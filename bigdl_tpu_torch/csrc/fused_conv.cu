// Fused BN-apply -> ReLU -> 1x1 conv for Hopper (sm_90a): forward, dgrad and
// wgrad kernels with plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/fused_conv.py:
//   _fwd_kernel   (:141) -> fwd_wgmma (bf16, C and K multiples of 8) and
//                            fwd_kernel (f32, bf16 rows TMA cannot read,
//                            and z in another dtype than x, the JAX
//                            out_dtype): z = relu(x*scale + shift [+ r]) @ W,
//                            zstats = [sum z, sum z^2] per output channel
//                            (from the f32 accumulator), optional y
//   _dgrad_kernel (:281) -> dgrad_wgmma / dgrad_kernel, split the same way:
//                            dp = (dz @ W^T [+ dy]) * 1[p > 0],
//                            q = [sum dp, sum dp*xhat] per input channel
//   _wgrad_kernel (:405) -> wgrad_wgmma / wgrad_kernel, split the same way:
//                            dW = relu(x*scale + shift [+ r])^T @ dz, y
//                            recomputed and never stored
// Operands are row-major: x, r, y, dp (M, C); dz, z (M, K); W, dW (C, K);
// scale, shift, mean, inv_std (C,) f32. An NHWC activation is (M, C) rows.
// Element by element, as the plain versions (bigdl_tpu_torch/ops/
// fused_conv.py) compute it: p = (x*scale) + shift + r, each op rounded once
// (no FMA contraction), y = max(p, 0) rounded to the data dtype before the
// product, products accumulated in f32, xhat = (x - mean) * inv_std.
//
// Bound on the H100 SXM: bytes. At ResNet-50's edges (bf16, C = 256..2048,
// K = 64..2048, M = 12,544..802,816) one pass over the operands at 3.35 TB/s
// takes longer than 2*M*C*K FLOP at 989 TFLOP/s on every edge but the
// stage-4 expansion (M 12,544, C 512, K 2048), so the design keeps the
// activation between BN and conv out of memory and reads each operand
// about once, streamed by TMA while wgmma keeps the product off the
// arithmetic limit.
//
// The bf16 wgmma kernels (TMA needs 16-byte row strides) share one shape
// (the forward in two: fwd_wgmma streams x per N tile, fwd_panel_wgmma
// keeps a tile's y for every N tile; see fwd_on_panel): persistent blocks,
// one per SM, of a loader warp (in the wgrad a warpgroup, whose registers
// go to the consumers), whose one thread issues TMA loads into an mbarrier
// ring, and two consumer warpgroups running wgmma from shared memory with
// f32 accumulators in registers, one group left in flight. The forward and
// the wgrad share one prologue, built once per tile in shared memory
// (choice (a) of the two ways: registers would hold A fragments beside the
// accumulators, and the forward's transformed tile is already y's TMA
// store tile): each consumer thread reads 16-byte swizzled chunks of x and
// r, writes relu(x*scale + shift + r) rounded once to bf16 back over x
// (zero in rows past M), then fence.proxy.async and its warpgroup's
// barrier before the wgmma; the next step's prologue overlaps this step's
// products. Each kernel's design is described above it: fwd_wgmma,
// fwd_panel_wgmma, dgrad_wgmma, wgrad_wgmma.
//
// The f32 kernels and the bf16 mma.sync kernels (simple and right first):
//   * One 64 x 64 output tile per block step, 4 warps, K-depth 32 per stage.
//     bf16: each warp owns 16 rows and runs mma.sync from ldmatrix fragments
//     (tiles padded by 8 elements); f32: each thread owns an 8 x 4 sub-tile of
//     scalar FMAs (the tensor cores have no full-f32 path). The tile helpers
//     live in mma_tile.cuh, shared with conv3x3.cu.
//   * The accumulator tile goes to shared memory as f32, and the epilogue
//     (z/dp stores, the dgrad mask, per-channel sums) walks it with one thread
//     per column, so stores are coalesced and the sums come from the f32
//     values before any rounding.
//   * Ragged M, C and K are masked in the kernels (no padding copies); rows
//     past M are zero in the A tile, so they add nothing to z or the sums.
//     16-byte vector loads when the row length is a multiple of 8.
// Cross-row reductions are deterministic and use no atomics, in every
// kernel: each forward or dgrad block writes one partial row of sums over
// a fixed set of M tiles, each wgrad block one partial dW over a fixed
// range of M, and sum_rows adds the partials in a fixed order. Results
// repeat bitwise from run to run. The kernels allocate nothing (the
// wrapper passes the partials' scratch, sized by bigdl_fused_conv_scratch)
// and launch on the caller's stream.

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBSize = (kBK * kLdKN > kTN * kLdNK) ? kBK * kLdKN : kTN * kLdNK;
constexpr int kMaxRowBlocks = 768;  // fwd/dgrad blocks along M
constexpr int kWgradBlocks = 1024;  // wgrad blocks aimed at (tiles x splits)
constexpr int kMinSplitRows = 256;

// ---------------------------------------------------------------- scalars

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// p = x*scale + shift + r, each op rounded once; relu(p)
__device__ __forceinline__ float pre_act(float x, float s, float b, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, s), b), r);
}

// ---------------------------------------------------------------- forward

// Z: z's type, T's unless the caller asks for another (a bf16 forward
// storing an f32 z, the JAX wrapper's out_dtype)
template <typename T, typename Z = T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const float* __restrict__ scale, const float* __restrict__ shift,
               const T* __restrict__ w, Z* __restrict__ z, T* __restrict__ y,
               float* __restrict__ part, int M, int C, int K) {
  __shared__ __align__(16) unsigned char smem_a[kTM * kLdA * sizeof(T)];
  __shared__ __align__(16) unsigned char smem_b[kBSize * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem_a);
  T* sB = reinterpret_cast<T*>(smem_b);
  __shared__ __align__(16) float sO[kTM * kLdO];
  __shared__ float sRed[2][2][kTN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kTN;
  const bool vecC = (C % 8) == 0, vecK = (K % 8) == 0;
  const bool write_y = y != nullptr && blockIdx.y == 0;
  const int col = tid & (kTN - 1), half = tid / kTN;
  const int n_mt = (M + kTM - 1) / kTM;
  float tot1 = 0.f, tot2 = 0.f;  // column n0 + col, threads < kTN

  for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
    const int m0 = mt * kTM;
    float acc[8][4];
    zero_acc(acc);
    for (int c0 = 0; c0 < C; c0 += kBK) {
      // A = y rows m0.., channels c0..: BN and ReLU applied while loading
      for (int i = tid; i < kTM * (kBK / 8); i += kThreads) {
        const int rr = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
        const int m = m0 + rr, c = c0 + cc;
        float v[8];
        if (m < M && c < C) {
          const int valid = min(8, C - c);
          const size_t at = static_cast<size_t>(m) * C + c;
          float rv[8];
          zero8(rv);
          load8(v, x + at, valid, vecC);
          if (r != nullptr) load8(rv, r + at, valid, vecC);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = e < valid ? round_to<T>(fmaxf(
                                   pre_act(v[e], scale[c + e], shift[c + e],
                                           rv[e]), 0.f))
                             : 0.f;
          if (write_y) store8(y + at, v, valid, vecC);
        } else {
          zero8(v);
        }
        store8_vec(sA + rr * kLdA + cc, v);
      }
      // B = W rows c0.., columns n0.. (held (k, n))
      for (int i = tid; i < kBK * (kTN / 8); i += kThreads) {
        const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
        const int c = c0 + rr, n = n0 + cc;
        float v[8];
        zero8(v);
        if (c < C && n < K)
          load8(v, w + static_cast<size_t>(c) * K + n, min(8, K - n), vecK);
        store8_vec(sB + rr * kLdKN + cc, v);
      }
      __syncthreads();
      tile_product<true>(acc, sA, sB, tid);
      __syncthreads();
    }
    acc_to_smem<T>(sO, acc, tid);
    __syncthreads();
    float s1 = 0.f, s2 = 0.f;
    const int n = n0 + col;
    if (n < K) {
      for (int i = 0; i < kTM / 2; ++i) {
        const int row = half * (kTM / 2) + i, m = m0 + row;
        if (m >= M) break;
        const float v = sO[row * kLdO + col];
        z[static_cast<size_t>(m) * K + n] = from_f<Z>(v);
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
    sRed[0][half][col] = s1;
    sRed[1][half][col] = s2;
    __syncthreads();
    if (tid < kTN) {
      tot1 += sRed[0][0][col] + sRed[0][1][col];
      tot2 += sRed[1][0][col] + sRed[1][1][col];
    }
    __syncthreads();
  }
  if (tid < kTN && n0 + col < K) {
    float* row = part + static_cast<size_t>(blockIdx.x) * 2 * K;
    row[n0 + col] = tot1;
    row[K + n0 + col] = tot2;
  }
}

// ------------------------------------------------------------------ dgrad

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dgrad_kernel(const T* __restrict__ dz, const T* __restrict__ w,
                 const T* __restrict__ x, const T* __restrict__ r,
                 const T* __restrict__ g, const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ mean,
                 const float* __restrict__ inv_std, T* __restrict__ dp,
                 float* __restrict__ part, int M, int C, int K) {
  __shared__ __align__(16) unsigned char smem_a[kTM * kLdA * sizeof(T)];
  __shared__ __align__(16) unsigned char smem_b[kBSize * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem_a);
  T* sB = reinterpret_cast<T*>(smem_b);
  __shared__ __align__(16) float sO[kTM * kLdO];
  __shared__ float sRed[2][2][kTN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kTN;  // channel tile
  const bool vecK = (K % 8) == 0;
  const int col = tid & (kTN - 1), half = tid / kTN;
  const int c = n0 + col;
  const int n_mt = (M + kTM - 1) / kTM;
  float sc = 0.f, sh = 0.f, mu = 0.f, is = 0.f;
  if (c < C) {
    sc = scale[c];
    sh = shift[c];
    mu = mean[c];
    is = inv_std[c];
  }
  float tot1 = 0.f, tot2 = 0.f;

  for (int mt = blockIdx.x; mt < n_mt; mt += gridDim.x) {
    const int m0 = mt * kTM;
    float acc[8][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // A = dz rows m0.., columns k0..
      for (int i = tid; i < kTM * (kBK / 8); i += kThreads) {
        const int rr = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
        const int m = m0 + rr, k = k0 + cc;
        float v[8];
        zero8(v);
        if (m < M && k < K)
          load8(v, dz + static_cast<size_t>(m) * K + k, min(8, K - k), vecK);
        store8_vec(sA + rr * kLdA + cc, v);
      }
      // B = W^T: W rows n0.. (channels), columns k0.. (held (n, k))
      for (int i = tid; i < kTN * (kBK / 8); i += kThreads) {
        const int rr = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
        const int ch = n0 + rr, k = k0 + cc;
        float v[8];
        zero8(v);
        if (ch < C && k < K)
          load8(v, w + static_cast<size_t>(ch) * K + k, min(8, K - k), vecK);
        store8_vec(sB + rr * kLdNK + cc, v);
      }
      __syncthreads();
      tile_product<false>(acc, sA, sB, tid);
      __syncthreads();
    }
    acc_to_smem<T>(sO, acc, tid);
    __syncthreads();
    float s1 = 0.f, s2 = 0.f;
    if (c < C) {
      for (int i = 0; i < kTM / 2; ++i) {
        const int row = half * (kTM / 2) + i, m = m0 + row;
        if (m >= M) break;
        const size_t at = static_cast<size_t>(m) * C + c;
        float d = sO[row * kLdO + col];
        if (g != nullptr) d = __fadd_rn(d, to_f(g[at]));
        const float xv = to_f(x[at]);
        const float p = pre_act(xv, sc, sh, r != nullptr ? to_f(r[at]) : 0.f);
        const float dpv = p > 0.f ? d : 0.f;
        dp[at] = from_f<T>(dpv);
        const float xhat = __fmul_rn(__fsub_rn(xv, mu), is);
        s1 += dpv;
        s2 = fmaf(dpv, xhat, s2);
      }
    }
    sRed[0][half][col] = s1;
    sRed[1][half][col] = s2;
    __syncthreads();
    if (tid < kTN) {
      tot1 += sRed[0][0][col] + sRed[0][1][col];
      tot2 += sRed[1][0][col] + sRed[1][1][col];
    }
    __syncthreads();
  }
  if (tid < kTN && c < C) {
    float* row = part + static_cast<size_t>(blockIdx.x) * 2 * C;
    row[c] = tot1;
    row[C + c] = tot2;
  }
}

// ----------------------------------------------------- dgrad, bf16 (wgmma)
//
// The bf16 dgrad where the rows of x, dz and W are 16-byte aligned (C and K
// multiples of 8, which TMA needs). At ResNet-50's stage-1 join (M 802,816,
// C 256, K 64) the product is one 64-deep step and x, r, dy and dp carry 16
// of every 17 bytes: there the point is streaming those four tiles. At the
// stage-4 expansion (C 512, K 2048) the product dominates and runs on wgmma.
//   * Persistent blocks, one per SM: block b owns channel tile b % n_ct (BN
//     channels) and walks M tiles of 128 rows b / n_ct, + R, + 2R, ... (R =
//     blocks / n_ct). The channel tiles of one M tile run on neighbouring
//     blocks at the same time, so dz is read from memory about once and
//     re-read from L2 (a block covering all C channels would need the whole
//     accumulator row in registers). Its channels' sums stay in registers
//     across its tiles: one partial row per row-block feeds sum_rows, in a
//     fixed order.
//   * A loader warp issues TMA loads: per tile, the first ring's worth of
//     dz (128 rows x 64 k) and W (BN channels x 64 k) boxes into an mbarrier
//     ring, then the epilogue's x, r and dy tiles (128 rows x BN channels,
//     as 64-channel panels) once their buffer is free, then the other steps.
//     So the next tile's epilogue operands stream in while this tile's
//     product and epilogue run.
//   * Two consumer warpgroups of 64 rows: wgmma m64nBNk16 with A = dz and
//     B = W^T, both K-major from shared memory (W's (C, K) rows are B's
//     rows), f32 accumulators in registers, one group left in flight.
//   * The epilogue works in the accumulator's own layout: each thread reads
//     its elements' x, r, dy pairs from the swizzled tiles (conflict-free),
//     masks, adds its per-channel sums, and writes dp as bf16 pairs into a
//     swizzled tile, which one thread then stores by TMA (16-byte rows,
//     ragged M and C clipped by the tensor map).
//   * Two shapes of the same kernel, chosen by K (dgrad_launch):
//     - shallow products (K <= 128: one or two steps), BN 64, 3 ring stages,
//       two epilogue buffers and two dp tiles, so one tile's operands load
//       while the previous one's are used;
//     - deep products, BN 128 (half the bytes per product of BN 64: at K
//       2048 the ring's L2 traffic is what holds the product back), 3 ring
//       stages of 32 KB, one epilogue buffer, dp written in place over x and
//       the buffer freed once its store has read it.
// Rows past M and channels past C load as zeros, so they add nothing.

constexpr int kDgRows = 128;           // rows per tile: two warpgroups
constexpr int kDgThreads = 288;        // 2 consumer warpgroups + loader warp
constexpr int kDgA = kDgRows * 128;    // dz box: 128 rows x 64 k
constexpr int kDgPanel = kDgRows * 128;  // 128 rows x 64 channels of x etc.

// BN channels per tile, kStages ring stages of (dz, W), kBufs buffers of
// (x, r, dy): with 2, two separate dp tiles; with 1, dp over x
template <int BN, int kStages, int kBufs>
struct DgSmem {
  static constexpr int kB = BN * 128;             // W box: BN rows x 64 k
  static constexpr int kStage = kDgA + kB;
  static constexpr int kTile = kDgPanel * (BN / 64);  // one of x, r, dy, dp
  static constexpr int kEpi = kStages * kStage;
  static constexpr int kOut = kEpi + kBufs * 3 * kTile;
  static constexpr int kVec = kOut + (kBufs == 2 ? 2 * kTile : 0);
  static constexpr int kRed = kVec + 4 * BN * 4;      // [4][BN] f32
  static constexpr int kBars = kRed + 8 * 2 * BN * 4;  // [8][2][BN] f32
  static constexpr int kNumBars = 2 * kStages + 2 * kBufs;
  static constexpr int kBytes = kBars + 8 * kNumBars + 1024;
};

template <int BN>
__device__ __forceinline__ void dgrad_mma(float (&acc)[BN / 2],
                                          const unsigned char* sA,
                                          const unsigned char* sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = wg::desc_k_major(sA + kk * 32);
    const uint64_t db = wg::desc_k_major(sB + kk * 32);
    if constexpr (BN == 64)
      wg::mma_ss_n64<0>(acc, da, db, 1);
    else
      wg::mma_ss_n128<0>(acc, da, db, 1);
  }
}

// (dz, W) as (K, M) and (K, C); x, r, dy, dp as (C, M); r and dy may be
// absent (has_r, has_g: their maps are then never read)
template <int BN, int kStages, int kBufs>
__global__ void __launch_bounds__(kDgThreads, 1)
    dgrad_wgmma(const __grid_constant__ CUtensorMap tdz,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tdp,
                const float* __restrict__ scale,
                const float* __restrict__ shift,
                const float* __restrict__ mean,
                const float* __restrict__ inv_std, float* __restrict__ part,
                int M, int C, int K, int n_ct, int has_r, int has_g) {
  using L = DgSmem<BN, kStages, kBufs>;
  constexpr int kPanels = BN / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  float* vec = reinterpret_cast<float*>(sm + L::kVec);  // scale, shift, mu, is
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* epi_full = empty + kStages;
  uint64_t* epi_empty = epi_full + kBufs;
  const int tid = threadIdx.x;
  const int ct = blockIdx.x % n_ct, rb = blockIdx.x / n_ct;
  const int R = gridDim.x / n_ct;
  const int c0 = ct * BN;
  const int n_mt = (M + kDgRows - 1) / kDgRows;
  const int nk = (K + 63) / 64;
  if (tid < BN) {
    const int c = c0 + tid;
    const bool ok = c < C;
    vec[tid] = ok ? scale[c] : 0.f;
    vec[BN + tid] = ok ? shift[c] : 0.f;
    vec[2 * BN + tid] = ok ? mean[c] : 0.f;
    vec[3 * BN + tid] = ok ? inv_std[c] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);  // every consumer thread is done
    }
    for (int e = 0; e < kBufs; ++e) {
      wg::mbar_init(epi_full + e, 1);
      wg::mbar_init(epi_empty + e, 1);  // one consumer, after a barrier
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the loader warp: one thread feeds both rings
    if (tid == 256) {
      const uint32_t epi_bytes =
          L::kTile * (1 + (has_r ? 1 : 0) + (has_g ? 1 : 0));
      const int head = nk < kStages ? nk : kStages;
      int s = 0;
      for (int mt = rb, i = 0; mt < n_mt; mt += R, ++i) {
        const int m0 = mt * kDgRows, e = i % kBufs, use = i / kBufs;
        unsigned char* eb = sm + L::kEpi + e * 3 * L::kTile;
        for (int kt = 0; kt < nk; ++kt, ++s) {
          const int slot = s % kStages;
          unsigned char* st = sm + slot * L::kStage;
          if (s >= kStages)
            wg::mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
          wg::mbar_expect_tx(full + slot, L::kStage);
          wg::tma_load_4d(st, &tdz, full + slot, kt * 64, m0, 0, 0);
          wg::tma_load_4d(st + kDgA, &tw, full + slot, kt * 64, c0, 0, 0);
          if (kt != head - 1) continue;
          if (use > 0) wg::mbar_wait(epi_empty + e, (use - 1) & 1);
          wg::mbar_expect_tx(epi_full + e, epi_bytes);
          for (int p = 0; p < kPanels; ++p) {
            const int cp = c0 + 64 * p;
            unsigned char* pb = eb + p * kDgPanel;
            wg::tma_load_4d(pb, &tx, epi_full + e, cp, m0, 0, 0);
            if (has_r)
              wg::tma_load_4d(pb + L::kTile, &tr, epi_full + e, cp, m0, 0, 0);
            if (has_g)
              wg::tma_load_4d(pb + 2 * L::kTile, &tg, epi_full + e, cp, m0, 0,
                              0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 of each tile;
  // a thread's accumulator elements are rows 64 wgi + 16 w + l/4 (+ 8) and
  // channels 8 j + 2 (l % 4) (+ 1), j = 0 .. BN/8 - 1
  const int wgi = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
  float s1[BN / 4], s2[BN / 4];  // per channel 8 j + 2 (l % 4) + q: [2 j + q]
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) s1[i] = s2[i] = 0.f;
  int s = 0;
  for (int mt = rb, i = 0; mt < n_mt; mt += R, ++i) {
    const int m0 = mt * kDgRows, e = i % kBufs;
    float acc[BN / 2];
#pragma unroll
    for (int a = 0; a < BN / 2; ++a) acc[a] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      const int slot = s % kStages;
      const unsigned char* st = sm + slot * L::kStage;
      wg::mbar_wait(full + slot, (s / kStages) & 1);
      wg::fence_acc(acc);
      wg::fence();
      dgrad_mma<BN>(acc, st + wgi * 64 * 128, st + kDgA);
      wg::commit();
      wg::wait<1>();  // the previous step's products are done reading
      if (kt > 0) wg::mbar_arrive(empty + (s - 1) % kStages);
      if (kBufs == 1 && kt == 0 && i > 0 && tid == 0) {
        // the last tile's dp, written over its x, has left: free the buffer
        wg::bulk_wait_read<0>();
        wg::mbar_arrive(epi_empty);
      }
    }
    wg::wait<0>();
    wg::fence_acc(acc);
    wg::mbar_arrive(empty + (s - 1) % kStages);

    // epilogue: dp = (acc [+ dy]) * 1[p > 0], sums from the f32 dp
    const unsigned char* ex = sm + L::kEpi + e * 3 * L::kTile;
    unsigned char* od =
        kBufs == 1 ? sm + L::kEpi : sm + L::kOut + (i & 1) * L::kTile;
    wg::mbar_wait(epi_full + e, (i / kBufs) & 1);
    if (kBufs == 2) {
      if (tid == 0) wg::bulk_wait_read<1>();  // dp tile i & 1 has been read
      wg::named_barrier(1, 256);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wgi * 64 + 16 * w + (l >> 2) + 8 * h;
        const uint32_t off =
            (j >> 3) * kDgPanel + wg::sw128(row, j & 7) + 4 * (l & 3);
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ex + off));
        const float2 rv =
            has_r ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        ex + L::kTile + off))
                  : make_float2(0.f, 0.f);
        const float2 gv =
            has_g ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        ex + 2 * L::kTile + off))
                  : make_float2(0.f, 0.f);
        float dpv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = 8 * j + 2 * (l & 3) + q;
          const float x = q ? xv.y : xv.x;
          const float p = pre_act(x, vec[c], vec[BN + c], q ? rv.y : rv.x);
          float d = acc[4 * j + 2 * h + q];
          if (has_g) d = __fadd_rn(d, q ? gv.y : gv.x);
          dpv[q] = p > 0.f ? d : 0.f;
          const float xhat =
              __fmul_rn(__fsub_rn(x, vec[2 * BN + c]), vec[3 * BN + c]);
          s1[2 * j + q] += dpv[q];
          s2[2 * j + q] = fmaf(dpv[q], xhat, s2[2 * j + q]);
        }
        *reinterpret_cast<__nv_bfloat162*>(od + off) =
            __floats2bfloat162_rn(dpv[0], dpv[1]);
      }
    }
    wg::fence_proxy_async();  // the dp tile, to the TMA store's proxy
    wg::named_barrier(1, 256);
    if (tid == 0) {
      if (kBufs == 2) wg::mbar_arrive(epi_empty + e);  // x, r, dy are read
      for (int p = 0; p < kPanels; ++p)
        wg::tma_store_4d(&tdp, od + p * kDgPanel, c0 + 64 * p, m0, 0, 0);
      wg::bulk_commit();
    }
  }
  if (tid == 0) wg::bulk_wait<0>();

  // the block's channel sums: over the 8 row lanes of a warp (butterfly),
  // then over the 8 warps in order
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
    }
  }
  const int wi = wgi * 4 + w;
  if (l < 4) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        red[(wi * 2) * BN + 8 * j + 2 * l + q] = s1[2 * j + q];
        red[(wi * 2 + 1) * BN + 8 * j + 2 * l + q] = s2[2 * j + q];
      }
  }
  wg::named_barrier(1, 256);
  if (tid < BN && c0 + tid < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int v = 0; v < 8; ++v) {
      t1 += red[(v * 2) * BN + tid];
      t2 += red[(v * 2 + 1) * BN + tid];
    }
    float* row = part + static_cast<size_t>(rb) * 2 * C;
    row[c0 + tid] = t1;
    row[C + c0 + tid] = t2;
  }
}

// ------------------------------ the prologue of the bf16 forward and wgrad
//
// Both wgmma kernels build y = relu(x*scale + shift [+ r]) once per tile,
// in shared memory: each consumer thread reads 16-byte chunks (8 channels
// of one row) of the x and r tiles TMA landed, and writes y back over x,
// rounded once to bf16; then fence.proxy.async and a barrier of its
// warpgroup, and the warpgroup's wgmma reads y as its A operand.

// one bf16 pair of y from a pair of x and of r (low half first; a bf16 is
// the high half of its f32), as pre_act rounds
__device__ __forceinline__ uint32_t y_pair(uint32_t x2, uint32_t r2, float s0,
                                          float s1, float b0, float b1) {
  const float x0 = __uint_as_float(x2 << 16);
  const float x1 = __uint_as_float(x2 & 0xffff0000u);
  const float r0 = __uint_as_float(r2 << 16);
  const float r1 = __uint_as_float(r2 & 0xffff0000u);
  return wg::pack_bf16(fmaxf(pre_act(x0, s0, b0, r0), 0.f),
                       fmaxf(pre_act(x1, s1, b1, r1), 0.f));
}

// y over x for the 16-byte chunk at px (channels c..c+7 of one row, scale
// and shift of those channels in sc, sh); pr: the same chunk of r, or null.
// Zero where !live: TMA fills x and r past M with zeros, but relu(shift)
// need not be zero there.
__device__ __forceinline__ void y_chunk(unsigned char* px,
                                        const unsigned char* pr,
                                        const float (&sc)[8],
                                        const float (&sh)[8], bool live) {
  uint4 v = *reinterpret_cast<const uint4*>(px);
  const uint4 r = pr != nullptr ? *reinterpret_cast<const uint4*>(pr)
                                : make_uint4(0u, 0u, 0u, 0u);
  v.x = live ? y_pair(v.x, r.x, sc[0], sc[1], sh[0], sh[1]) : 0u;
  v.y = live ? y_pair(v.y, r.y, sc[2], sc[3], sh[2], sh[3]) : 0u;
  v.z = live ? y_pair(v.z, r.z, sc[4], sc[5], sh[4], sh[5]) : 0u;
  v.w = live ? y_pair(v.w, r.w, sc[6], sc[7], sh[6], sh[7]) : 0u;
  *reinterpret_cast<uint4*>(px) = v;
}

// v = p[c .. c+7] (16-byte aligned), zeros when c >= C (C % 8 == 0)
__device__ __forceinline__ void load_vec8(float (&v)[8],
                                          const float* __restrict__ p, int c,
                                          int C) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (c < C) {
    a = __ldg(reinterpret_cast<const float4*>(p + c));
    b = __ldg(reinterpret_cast<const float4*>(p + c + 4));
  }
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// one step of a reduce-scatter over lanes lane ^ mask: v[0 .. 2 kHalf) in,
// v[0 .. kHalf) out, the upper half where `upper`, each value plus the
// partner lane's copy of it
template <int kHalf>
__device__ __forceinline__ void fold_half(float* v, bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float lo = v[i], hi = v[i + kHalf];
    v[i] = (upper ? hi : lo) +
           __shfl_xor_sync(0xffffffffu, upper ? lo : hi, mask);
  }
}

// the sums of v (N values per lane, alike in the 8 lanes l % 4 + 4 r of a
// warp) over those 8 lanes, scattered: lane l keeps N / 8 of them, value i
// being v's entry (l & 16 ? N/2 : 0) + (l & 8 ? N/4 : 0) + (l & 4 ? N/8 : 0)
// + i, and adds them to t
template <int N>
__device__ __forceinline__ void sum_rows_scatter(float (&v)[N],
                                                 float (&t)[N / 8], int l) {
  fold_half<N / 2>(v, l & 16, 16);
  fold_half<N / 4>(v, l & 8, 8);
  fold_half<N / 8>(v, l & 4, 4);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) t[i] += v[i];
}

// ----------------------------------------------------- forward, bf16 (wgmma)
//
// z (M x K) = y (M x C) . W (C x K): A = y, K-major as x lies (channels
// along a row); B = W, whose (C, K) rows are MN-major for B.
//   * Persistent blocks, one per SM: block b owns the N tile b % n_nt (BN
//     columns) and walks M tiles of 128 rows b / n_nt, + R, + 2R, ... (R =
//     blocks / n_nt). K <= 64 takes BN 64, larger K BN 128; where K > BN the
//     N tiles of one M tile run on neighbouring blocks at the same time, so
//     x and r leave memory about once and are re-read from L2.
//   * A loader warp streams, per 64-channel step of the reduction, the x
//     tile (128 rows x 64 channels), the r tile and the W tile (64 channels
//     x BN) into an mbarrier ring.
//   * Two consumer warpgroups of 64 rows each build their rows of y in
//     place over x (above), then run wgmma m64nBNk16 on it; one group stays
//     in flight, so the prologue of the next step overlaps the products of
//     this one. Where y is wanted, the blocks of N tile 0 store each
//     transformed tile by TMA (y's SW128 box of 64 rows), so y leaves once.
//   * Epilogue in the accumulator's own layout: z as bf16 pairs into a
//     swizzled tile, which one thread per warpgroup stores by TMA; sum z
//     and sum z^2 per column from the f32 accumulators, over the warp's
//     8 row lanes by a shuffle reduce-scatter (each lane keeps BN / 32
//     columns' sums across the block's M tiles: 64 registers of running
//     sums per thread spilled at BN 128), then over the 8 warps in order:
//     one partial row per row-block feeds sum_rows.
// Rows past M are zero in y, so their z rows are zero and add nothing to
// the sums; TMA clips their z and y stores.

constexpr int kFwRows = 128;             // rows per M tile: two warpgroups
constexpr int kFwTile = kFwRows * 128;   // x, r, y or z: 128 rows x 64

template <int BN, int kStages>
struct FwSmem {
  static constexpr int kW = BN * 128;              // W: 64 channels x BN
  static constexpr int kStage = 2 * kFwTile + kW;  // x, r, W
  static constexpr int kZ = kStages * kStage;      // z: BN / 64 panels
  static constexpr int kBars = kZ + (BN / 64) * kFwTile;
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
  // the column sums' [8 warps][2][BN] f32 scratch reuses the ring at the end
  static_assert(8 * 2 * BN * 4 <= kZ, "column-sum scratch");
};

template <int BN>
__device__ __forceinline__ void fwd_mma(float (&acc)[BN / 2],
                                        const unsigned char* sA,
                                        const unsigned char* sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = wg::desc_k_major(sA + kk * 32);
    const uint64_t db = wg::desc_mn_major(sB + kk * 2048, 64 * 128);
    if constexpr (BN == 64)
      wg::mma_ss_n64<1>(acc, da, db, 1);
    else
      wg::mma_ss_n128<1>(acc, da, db, 1);
  }
}

// a finished tile of either forward kernel: warpgroup g's 64 rows of z as
// bf16 pairs into the swizzled tile zt, stored by TMA at (n0, m0); the
// tile's column sums from the f32 accumulators added to this lane's share
// t1 (sum z), t2 (sum z^2) of them (sum_rows_scatter). Thread t == 0 of the
// warpgroup issues the store, after its previous one has left zt.
template <int BN>
__device__ __forceinline__ void fwd_tile_out(const float (&acc)[BN / 2],
                                             unsigned char* zt,
                                             const CUtensorMap* tz, int n0,
                                             int m0, float (&t1)[BN / 32],
                                             float (&t2)[BN / 32], int g,
                                             int t) {
  const int w = t >> 5, l = t & 31;
  if (t == 0) wg::bulk_wait_read<0>();
  wg::named_barrier(1 + g, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * g + 16 * w + (l >> 2) + 8 * h;
      *reinterpret_cast<uint32_t*>(zt + (j >> 3) * kFwTile +
                                   wg::sw128(row, j & 7) + 4 * (l & 3)) =
          wg::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  wg::fence_proxy_async();  // the z tile, to the TMA store's proxy
  wg::named_barrier(1 + g, 128);
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < BN / 64; ++p)
      wg::tma_store_4d(tz, zt + p * kFwTile + g * 64 * 128, n0 + 64 * p,
                       m0 + 64 * g, 0, 0);
    wg::bulk_commit();
  }
  // this thread's sums per column 8 j + 2 (l % 4) + q, at [2 j + q]
  float v1[BN / 4], v2[BN / 4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float a = acc[4 * j + q], b = acc[4 * j + 2 + q];
      v1[2 * j + q] = a + b;
      v2[2 * j + q] = fmaf(b, b, a * a);
    }
  sum_rows_scatter<BN / 4>(v1, t1, l);
  sum_rows_scatter<BN / 4>(v2, t2, l);
}

// lane l's share of its warp wi's column sums into red[wi][2][BN]: the
// columns sum_rows_scatter gave it
template <int BN>
__device__ __forceinline__ void put_col_sums(float* red,
                                             const float (&t1)[BN / 32],
                                             const float (&t2)[BN / 32],
                                             int wi, int l) {
  const int first = (l & 16 ? BN / 8 : 0) + (l & 8 ? BN / 16 : 0) +
                    (l & 4 ? BN / 32 : 0);
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int o = first + i;  // [2 j + q] of column 8 j + 2 (l % 4) + q
    const int col = 8 * (o >> 1) + 2 * (l & 3) + (o & 1);
    red[(wi * 2) * BN + col] = t1[i];
    red[(wi * 2 + 1) * BN + col] = t2[i];
  }
}

// x, r, y as (C, M) maps (x and r in boxes of 128 rows, y of 64), W as
// (K, C) in boxes of 64 rows, z as (K, M) in boxes of 64 rows; r and y may
// be absent (has_r, want_y: their maps are then never read)
template <int BN, int kStages>
__global__ void __launch_bounds__(kDgThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tr,
              const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap ty,
              const __grid_constant__ CUtensorMap tz,
              const float* __restrict__ scale,
              const float* __restrict__ shift, float* __restrict__ part,
              int M, int C, int K, int n_nt, int has_r, int want_y) {
  using L = FwSmem<BN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int nt = blockIdx.x % n_nt, rb = blockIdx.x / n_nt;
  const int R = gridDim.x / n_nt;
  const int n0 = nt * BN;
  const int n_mt = (M + kFwRows - 1) / kFwRows;
  const int nk = (C + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);  // every consumer thread is done
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the loader warp: one thread feeds the ring
    if (tid == 256) {
      const uint32_t bytes = kFwTile * (has_r ? 2 : 1) + L::kW;
      int s = 0;
      for (int mt = rb; mt < n_mt; mt += R) {
        for (int kt = 0; kt < nk; ++kt, ++s) {
          const int slot = s % kStages;
          unsigned char* st = sm + slot * L::kStage;
          if (s >= kStages)
            wg::mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
          wg::mbar_expect_tx(full + slot, bytes);
          wg::tma_load_4d(st, &tx, full + slot, 64 * kt, mt * kFwRows, 0, 0);
          if (has_r)
            wg::tma_load_4d(st + kFwTile, &tr, full + slot, 64 * kt,
                            mt * kFwRows, 0, 0);
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            wg::tma_load_4d(st + 2 * kFwTile + p * 64 * 128, &tw, full + slot,
                            n0 + 64 * p, 64 * kt, 0, 0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows 64 g .. 64 g + 63 of each tile; a
  // thread's accumulator elements are rows 64 g + 16 w + l/4 (+ 8) and
  // columns 8 j + 2 (l % 4) (+ 1); its prologue chunks are rows
  // 64 g + t/8 + 16 i, channels 8 (t % 8) .. + 7 of each 64-channel step
  const int g = tid >> 7, t = tid & 127, w = t >> 5, l = tid & 31;
  const bool stores_y = want_y && nt == 0 && t == 0;
  float t1[BN / 32], t2[BN / 32];  // this lane's share of the column sums
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) t1[i] = t2[i] = 0.f;
  int s = 0;
  for (int mt = rb; mt < n_mt; mt += R) {
    const int m0 = mt * kFwRows;
    float acc[BN / 2];
#pragma unroll
    for (int a = 0; a < BN / 2; ++a) acc[a] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      const int slot = s % kStages;
      unsigned char* st = sm + slot * L::kStage;
      float sc[8], sh[8];
      load_vec8(sc, scale, 64 * kt + 8 * (t & 7), C);
      load_vec8(sh, shift, 64 * kt + 8 * (t & 7), C);
      wg::mbar_wait(full + slot, (s / kStages) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 64 * g + (t >> 3) + 16 * i;
        const uint32_t off = wg::sw128(row, t & 7);
        y_chunk(st + off, has_r ? st + kFwTile + off : nullptr, sc, sh,
                m0 + row < M);
      }
      wg::fence_proxy_async();  // y, to the async proxy of wgmma and TMA
      wg::named_barrier(1 + g, 128);
      if (stores_y) {
        wg::tma_store_4d(&ty, st + g * 64 * 128, 64 * kt, m0 + 64 * g, 0, 0);
        wg::bulk_commit();
      }
      wg::fence_acc(acc);
      wg::fence();
      fwd_mma<BN>(acc, st + g * 64 * 128, st + 2 * kFwTile);
      wg::commit();
      wg::wait<1>();  // the previous step's products are done reading
      if (kt > 0) {
        if (stores_y) wg::bulk_wait_read<1>();  // and its y store
        wg::mbar_arrive(empty + (s - 1) % kStages);
      }
    }
    wg::wait<0>();
    wg::fence_acc(acc);
    if (stores_y) wg::bulk_wait_read<0>();
    wg::mbar_arrive(empty + (s - 1) % kStages);

    fwd_tile_out<BN>(acc, sm + L::kZ, &tz, n0, m0, t1, t2, g, t);
  }
  if (t == 0) wg::bulk_wait<0>();

  // the block's column sums over its 8 warps, in order, in scratch over
  // the ring (both warpgroups are done with it: products waited, y stores
  // complete)
  wg::named_barrier(3, 256);
  float* red = reinterpret_cast<float*>(sm);
  put_col_sums<BN>(red, t1, t2, 4 * g + w, l);
  wg::named_barrier(3, 256);
  if (tid < BN && n0 + tid < K) {
    float s1 = 0.f, s2 = 0.f;
    for (int v = 0; v < 8; ++v) {
      s1 += red[(v * 2) * BN + tid];
      s2 += red[(v * 2 + 1) * BN + tid];
    }
    float* row = part + static_cast<size_t>(rb) * 2 * K;
    row[n0 + tid] = s1;
    row[K + n0 + tid] = s2;
  }
}

// ------------------------ forward, bf16 (wgmma), the y panel kept resident
//
// For C <= 512 and K > 256 with neither a residual nor y (ResNet-50's
// expansions (200,704, 128, 512), (50,176, 256, 1024) and (12,544, 512,
// 2048)), fwd_wgmma's N tiles would each re-read x from L2 and rebuild y:
// at the stage-4 expansion x 16 times, as many bytes through L2 as W. Here
// a block builds the y panel of its 128-row M tile (all C channels, 16 KB
// per 64) once and walks every N tile of K over it, W streamed from L2.
//   * Block b walks M tiles b, b + blocks, ...; per M tile, per N tile of
//     BN 128, per 64-channel step, the loader brings W's 64 x 128 tile into
//     a ring; in the first N tile it also brings step kt's x tile into
//     panel slot kt (barriers of its own), which the consumers turn into y
//     in place. Slot kt is freed after the last N tile's products over it,
//     so the next M tile's x streams in during the last N tile.
//   * Epilogue per (M tile, N tile): z by TMA as in fwd_wgmma; the column
//     sums over the warp's row lanes (reduce-scatter), then over the 8
//     warps in order, added to the block's own partial row in `part` (read
//     before the tile's products, written after: the same order each run).

constexpr int kFpBN = 128;

template <int kStages>
struct FpSmem {
  static constexpr int kW = kFpBN * 128;                   // W: 64 x BN
  static constexpr int kZ = kStages * kW;                  // z: 2 panels
  static constexpr int kRed = kZ + (kFpBN / 64) * kFwTile;  // [8][2][BN]
  static constexpr int kPanel = kRed + 8 * 2 * kFpBN * 4;   // nk x, then bars
  static_assert(kPanel % 1024 == 0, "panel alignment");
  // bytes for a panel of nk 64-channel tiles: the barriers full and empty
  // of the ring, pfull and pempty of the panel slots
  static int bytes(int nk) {
    return kPanel + nk * kFwTile + 8 * (2 * kStages + 2 * nk) + 1024;
  }
};

// x as (C, M) in boxes of 128 rows, W as (K, C) and z as (K, M) in boxes
// of 64 rows; part: [blocks][2][K] f32
template <int kStages>
__global__ void __launch_bounds__(kDgThreads, 1)
    fwd_panel_wgmma(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tz,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ part,
                    int M, int C, int K) {
  using L = FpSmem<kStages>;
  constexpr int BN = kFpBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  const int nk = (C + 63) / 64, n_nt = (K + BN - 1) / BN;
  const int n_mt = (M + kFwRows - 1) / kFwRows;
  unsigned char* panel = sm + L::kPanel;
  uint64_t* full = reinterpret_cast<uint64_t*>(panel + nk * kFwTile);
  uint64_t* empty = full + kStages;
  uint64_t* pfull = empty + kStages;
  uint64_t* pempty = pfull + nk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);  // every consumer thread is done
    }
    for (int kt = 0; kt < nk; ++kt) {
      wg::mbar_init(pfull + kt, 1);
      wg::mbar_init(pempty + kt, 256);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the loader warp: one thread feeds ring and panel
    if (tid == 256) {
      int s = 0;
      for (int mt = blockIdx.x, i = 0; mt < n_mt; mt += gridDim.x, ++i) {
        for (int nt = 0; nt < n_nt; ++nt) {
          for (int kt = 0; kt < nk; ++kt, ++s) {
            if (nt == 0) {
              if (i > 0) wg::mbar_wait(pempty + kt, (i - 1) & 1);
              wg::mbar_expect_tx(pfull + kt, kFwTile);
              wg::tma_load_4d(panel + kt * kFwTile, &tx, pfull + kt, 64 * kt,
                              mt * kFwRows, 0, 0);
            }
            const int slot = s % kStages;
            unsigned char* st = sm + slot * L::kW;
            if (s >= kStages)
              wg::mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
            wg::mbar_expect_tx(full + slot, L::kW);
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              wg::tma_load_4d(st + p * 64 * 128, &tw, full + slot,
                              nt * BN + 64 * p, 64 * kt, 0, 0);
          }
        }
      }
    }
    return;
  }

  // consumers: as in fwd_wgmma (rows 64 g .. 64 g + 63 of each tile)
  const int g = tid >> 7, t = tid & 127, w = t >> 5, l = tid & 31;
  float* red = reinterpret_cast<float*>(sm + L::kRed);
  unsigned char* zt = sm + L::kZ;
  float* row = part + static_cast<size_t>(blockIdx.x) * 2 * K;
  int s = 0;
  for (int mt = blockIdx.x, i = 0; mt < n_mt; mt += gridDim.x, ++i) {
    const int m0 = mt * kFwRows;
    for (int nt = 0; nt < n_nt; ++nt) {
      const int n0 = nt * BN;
      const bool last = nt == n_nt - 1;
      // the block's running sums of this thread's column, read ahead
      float run1 = 0.f, run2 = 0.f;
      if (i > 0 && tid < BN && n0 + tid < K) {
        run1 = row[n0 + tid];
        run2 = row[K + n0 + tid];
      }
      float acc[BN / 2];
#pragma unroll
      for (int a = 0; a < BN / 2; ++a) acc[a] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++s) {
        unsigned char* pt = panel + kt * kFwTile;
        if (nt == 0) {  // y over this step's x tile, this warpgroup's rows
          float sc[8], sh[8];
          load_vec8(sc, scale, 64 * kt + 8 * (t & 7), C);
          load_vec8(sh, shift, 64 * kt + 8 * (t & 7), C);
          wg::mbar_wait(pfull + kt, i & 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = 64 * g + (t >> 3) + 16 * q;
            y_chunk(pt + wg::sw128(r, t & 7), nullptr, sc, sh, m0 + r < M);
          }
          wg::fence_proxy_async();  // y, to the async proxy of wgmma
          wg::named_barrier(1 + g, 128);
        }
        const int slot = s % kStages;
        wg::mbar_wait(full + slot, (s / kStages) & 1);
        wg::fence_acc(acc);
        wg::fence();
        fwd_mma<BN>(acc, pt + g * 64 * 128, sm + slot * L::kW);
        wg::commit();
        wg::wait<1>();  // the previous step's products are done reading
        if (kt > 0) {
          wg::mbar_arrive(empty + (s - 1) % kStages);
          if (last) wg::mbar_arrive(pempty + kt - 1);
        }
      }
      wg::wait<0>();
      wg::fence_acc(acc);
      wg::mbar_arrive(empty + (s - 1) % kStages);
      if (last) wg::mbar_arrive(pempty + nk - 1);

      float t1[BN / 32], t2[BN / 32];  // this tile's share of the sums
#pragma unroll
      for (int e = 0; e < BN / 32; ++e) t1[e] = t2[e] = 0.f;
      fwd_tile_out<BN>(acc, zt, &tz, n0, m0, t1, t2, g, t);
      wg::named_barrier(3, 256);  // the last tile's sums are read
      put_col_sums<BN>(red, t1, t2, 4 * g + w, l);
      wg::named_barrier(3, 256);
      if (tid < BN && n0 + tid < K) {
        float s1 = 0.f, s2 = 0.f;
        for (int v = 0; v < 8; ++v) {
          s1 += red[(v * 2) * BN + tid];
          s2 += red[(v * 2 + 1) * BN + tid];
        }
        row[n0 + tid] = run1 + s1;
        row[K + n0 + tid] = run2 + s2;
      }
    }
  }
  if (t == 0) wg::bulk_wait<0>();
}

// ------------------------------------------------------- wgrad, bf16 (wgmma)
//
// dW (C x K) = y^T (C x M) . dz (M x K), the reduction over M. A = y^T: an
// x tile as TMA lays it (rows = m, channels along a row) is MN-major for
// A, read with wgmma's transposed A; B = dz, MN-major (rows = m, K along a
// row). No element of y is moved to transpose it.
//   * Output tiles of BC = 128 MC channels x BN columns (MC m64 channel
//     groups per warpgroup; see wgrad_mc and wgrad_cols), T of them. Each
//     block owns one tile and one contiguous range of M in steps of 64
//     rows (kWgRows), with S = max(1, SMs / T) ranges; the T tiles of one
//     range are neighbouring blocks, so L2 serves their re-reads of x, r
//     and dz. At ResNet-50's stage-1 join (C 256, K 64) one tile covers all
//     of C x K, and x, r and dz leave memory exactly once.
//   * A loader warpgroup, one thread of which streams, per step, the x and
//     r tiles (64 rows x BC channels, as 64-channel panels) and the dz tile
//     (64 x BN) into an mbarrier ring, gives its registers to the two
//     consumer warpgroups (setmaxnreg). Consumer warpgroup g builds y over
//     its MC channel panels, then runs its MC products per k16 step; one
//     group stays in flight.
//   * Out: each block writes its f32 tile (C x K partial for its range) from
//     the accumulators; sum_rows adds the S partials in a fixed order and
//     rounds once to dW's dtype. Ranges are whole steps, so only the last
//     one reaches past M, where y is zeroed (dz is zero there too).

constexpr int kWgRows = 64;  // rows of M per ring step
// 2 consumer warpgroups and a loader warpgroup, which gives its registers
// to the consumers (setmaxnreg): 232 each holds the 128 x 256 tile's 128
// accumulators (the block's even share, 168, does not)
constexpr int kWgThreads = 384;

template <int MC, int BN, int kStages>
struct WgSmem {
  static constexpr int kBC = 128 * MC;                     // channels
  static constexpr int kPanel = kWgRows * 128;             // 64 rows x 64
  static constexpr int kAct = (kBC / 64) * kPanel;         // x or r
  static constexpr int kStage = 2 * kAct + (BN / 64) * kPanel;  // x, r, dz
  static constexpr int kVec = kStages * kStage;            // [2][kBC] f32
  static constexpr int kBars = kVec + 2 * kBC * 4;
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

// first: the first step, whose first products overwrite acc (scale-d 0)
template <int MC, int BN, int kRows>
__device__ __forceinline__ void wgrad_mma(float (&acc)[MC][BN / 2],
                                          const unsigned char* sA,
                                          const unsigned char* sB,
                                          bool first) {
  constexpr int kPanel = kRows * 128;
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint64_t db = wg::desc_mn_major(sB + kk * 2048, kPanel);
#pragma unroll
    for (int mc = 0; mc < MC; ++mc) {
      const uint64_t da =
          wg::desc_mn_major(sA + mc * kPanel + kk * 2048, kPanel);
      const int keep = !first || kk > 0;
      if constexpr (BN == 64)
        wg::mma_ss_n64<1, 1>(acc[mc], da, db, keep);
      else if constexpr (BN == 128)
        wg::mma_ss_n128<1, 1>(acc[mc], da, db, keep);
      else
        wg::mma_ss_n256<1, 1>(acc[mc], da, db, keep);
    }
  }
}

// x, r as (C, M) and dz as (K, M) maps in boxes of kWgRows rows; r may be
// absent (has_r: its map is then never read). part: [S][C][K] f32
template <int MC, int BN, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad_wgmma(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tr,
                const __grid_constant__ CUtensorMap tdz,
                const float* __restrict__ scale,
                const float* __restrict__ shift, float* __restrict__ part,
                int M, int C, int K, int n_ct, int n_nt, int per,
                int has_r) {
  using L = WgSmem<MC, BN, kStages>;
  constexpr int kRows = kWgRows;
  constexpr int kBC = L::kBC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  float* vec = reinterpret_cast<float*>(sm + L::kVec);  // scale, shift
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % (n_ct * n_nt);
  const int range = blockIdx.x / (n_ct * n_nt);
  const int c0 = (tile / n_nt) * kBC, n0 = (tile % n_nt) * BN;
  const int n_st = (M + kRows - 1) / kRows;
  const int st0 = range * per;
  const int steps = min(per, n_st - st0);  // >= 1: no range is empty
  if (tid < kBC) {
    const int c = c0 + tid;
    vec[tid] = c < C ? scale[c] : 0.f;
    vec[kBC + tid] = c < C ? shift[c] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);  // every consumer thread is done
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the loader warpgroup: one thread feeds the ring
    wg::setmaxnreg_dec<40>();
    if (tid == 256) {
      const uint32_t bytes = L::kStage - (has_r ? 0 : L::kAct);
      for (int i = 0; i < steps; ++i) {
        const int slot = i % kStages, m = (st0 + i) * kRows;
        unsigned char* st = sm + slot * L::kStage;
        if (i >= kStages)
          wg::mbar_wait(empty + slot, ((i / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(full + slot, bytes);
#pragma unroll
        for (int p = 0; p < kBC / 64; ++p) {
          wg::tma_load_4d(st + p * L::kPanel, &tx, full + slot, c0 + 64 * p,
                          m, 0, 0);
          if (has_r)
            wg::tma_load_4d(st + L::kAct + p * L::kPanel, &tr, full + slot,
                            c0 + 64 * p, m, 0, 0);
        }
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          wg::tma_load_4d(st + 2 * L::kAct + p * L::kPanel, &tdz, full + slot,
                          n0 + 64 * p, m, 0, 0);
      }
    }
    return;
  }

  // consumers: warpgroup g owns channel panels MC g .. MC g + MC - 1 of the
  // tile; a thread's accumulator elements of group mc are channels
  // 64 (MC g + mc) + 16 w + l/4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1);
  // its prologue chunks are rows t/8 + 16 i, channels 8 (t % 8) .. + 7 of
  // each of its panels
  wg::setmaxnreg_inc<232>();
  const int g = tid >> 7, t = tid & 127, w = t >> 5, l = tid & 31;
  // no zeros are written into acc: the first products overwrite it
  // (scale-d 0). Zeroing it by ordinary instructions made ptxas serialize
  // every wgmma of this loop (C7515: the prologue between the products)
  float acc[MC][BN / 2];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int a = 0; a < BN / 2; ++a) asm volatile("" : "=f"(acc[mc][a]));
  for (int i = 0; i < steps; ++i) {
    const int slot = i % kStages, m = (st0 + i) * kRows;
    unsigned char* st = sm + slot * L::kStage;
    wg::mbar_wait(full + slot, (i / kStages) & 1);
#pragma unroll
    for (int mc = 0; mc < MC; ++mc) {
      const int p = MC * g + mc;
      const float4* vs =
          reinterpret_cast<const float4*>(vec + 64 * p + 8 * (t & 7));
      const float4 a0 = vs[0], a1 = vs[1];
      const float4 b0 = vs[kBC / 4], b1 = vs[kBC / 4 + 1];
      const float sc[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float sh[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int q = 0; q < kRows / 16; ++q) {
        const int rr = (t >> 3) + 16 * q;
        const uint32_t off = p * L::kPanel + wg::sw128(rr, t & 7);
        y_chunk(st + off, has_r ? st + L::kAct + off : nullptr, sc, sh,
                m + rr < M);
      }
    }
    wg::fence_proxy_async();  // y, to the async proxy of wgmma
    wg::named_barrier(1 + g, 128);
#pragma unroll
    for (int mc = 0; mc < MC; ++mc) wg::fence_acc(acc[mc]);
    wg::fence();
    wgrad_mma<MC, BN, kRows>(acc, st + MC * g * L::kPanel, st + 2 * L::kAct,
                             i == 0);
    wg::commit();
    wg::wait<1>();  // the previous step's products are done reading
    if (i > 0) wg::mbar_arrive(empty + (i - 1) % kStages);
  }
  wg::wait<0>();
#pragma unroll
  for (int mc = 0; mc < MC; ++mc) wg::fence_acc(acc[mc]);

  // this range's f32 partial of the tile, straight from the accumulators
  float* out = part + static_cast<size_t>(range) * C * K;
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 64 * (MC * g + mc) + 16 * w + (l >> 2) + 8 * h;
        const int n = n0 + 8 * j + 2 * (l & 3);
        if (c < C && n < K)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(c) * K + n) =
              make_float2(acc[mc][4 * j + 2 * h], acc[mc][4 * j + 2 * h + 1]);
      }
}

// ------------------------------------------------------------------ wgrad

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, const T* __restrict__ dz,
                 float* __restrict__ part, int M, int C, int K,
                 int split_rows) {
  __shared__ __align__(16) unsigned char smem_a[kTM * kLdA * sizeof(T)];
  __shared__ __align__(16) unsigned char smem_b[kBSize * sizeof(T)];
  T* sA = reinterpret_cast<T*>(smem_a);
  T* sB = reinterpret_cast<T*>(smem_b);
  __shared__ __align__(16) float sO[kTM * kLdO];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int mb = blockIdx.z * split_rows;
  const int me = min(M, mb + split_rows);
  const bool vecC = (C % 8) == 0, vecK = (K % 8) == 0;
  float acc[8][4];
  zero_acc(acc);
  for (int m0 = mb; m0 < me; m0 += kBK) {
    // A = y^T: x rows m0.., channels c0.., BN and ReLU applied, stored
    // transposed ([channel][row]) so A's rows are channels
    for (int i = tid; i < kBK * (kTM / 8); i += kThreads) {
      const int rr = i / (kTM / 8), cc = (i % (kTM / 8)) * 8;
      const int m = m0 + rr, c = c0 + cc;
      float v[8];
      if (m < me && c < C) {
        const int valid = min(8, C - c);
        const size_t at = static_cast<size_t>(m) * C + c;
        float rv[8];
        zero8(rv);
        load8(v, x + at, valid, vecC);
        if (r != nullptr) load8(rv, r + at, valid, vecC);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = e < valid ? fmaxf(pre_act(v[e], scale[c + e], shift[c + e],
                                           rv[e]), 0.f)
                           : 0.f;
      } else {
        zero8(v);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sA[(cc + e) * kLdA + rr] = from_f<T>(v[e]);
    }
    // B = dz rows m0.., columns n0.. (held (k, n))
    for (int i = tid; i < kBK * (kTN / 8); i += kThreads) {
      const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
      const int m = m0 + rr, n = n0 + cc;
      float v[8];
      zero8(v);
      if (m < me && n < K)
        load8(v, dz + static_cast<size_t>(m) * K + n, min(8, K - n), vecK);
      store8_vec(sB + rr * kLdKN + cc, v);
    }
    __syncthreads();
    tile_product<true>(acc, sA, sB, tid);
    __syncthreads();
  }
  acc_to_smem<T>(sO, acc, tid);
  __syncthreads();
  const int col = tid & (kTN - 1), half = tid / kTN;
  const int n = n0 + col;
  if (n >= K) return;
  float* out = part + static_cast<size_t>(blockIdx.z) * C * K;
  for (int i = 0; i < kTM / 2; ++i) {
    const int row = half * (kTM / 2) + i, c = c0 + row;
    if (c >= C) break;
    out[static_cast<size_t>(c) * K + n] = sO[row * kLdO + col];
  }
}

// -------------------------------------------- fixed-order partial row sums

// out[n] = sum over r of part[r][n], r ascending within each of 8 lanes of
// rows, then the 8 lane sums in order
template <typename O>
__global__ void __launch_bounds__(256)
    sum_rows(const float* __restrict__ part, O* __restrict__ out, int R,
             int N) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (n < N)
    for (int r = ty; r < R; r += 8) s += part[static_cast<size_t>(r) * N + n];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][tx];
    out[n] = from_f<O>(t);
  }
}

template <typename O>
cudaError_t launch_sum(const float* part, void* out, int R, int N,
                       cudaStream_t st) {
  sum_rows<O><<<(N + 31) / 32, dim3(32, 8), 0, st>>>(
      part, static_cast<O*>(out), R, N);
  return cudaGetLastError();
}

int row_blocks(int M) {
  const int n_mt = (M + kTM - 1) / kTM;
  return n_mt < kMaxRowBlocks ? n_mt : kMaxRowBlocks;
}

// rows of M per wgrad split (a multiple of kBK), from the tile count
int split_rows(int M, int C, int K) {
  const int tiles = ((C + kTM - 1) / kTM) * ((K + kTN - 1) / kTN);
  int splits = (kWgradBlocks + tiles - 1) / tiles;
  const int most = (M + kMinSplitRows - 1) / kMinSplitRows;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const int rows = (M + splits - 1) / splits;
  return (rows + kBK - 1) / kBK * kBK;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  return sms;
}

// bf16 rows that TMA can read (16-byte strides: C and K multiples of 8)
// take the wgmma kernels
bool on_wgmma(int dtype, int C, int K) {
  return dtype == 1 && C % 8 == 0 && K % 8 == 0;
}

// channels per tile of the wgmma dgrad for a product K deep: products
// deeper than two ring steps take the BN 128 shape
int dgrad_cols(int K) { return K > 128 ? 128 : 64; }

// row-blocks of the wgmma dgrad: blocks per channel tile, one block per SM
int dgrad_rows(int M, int C, int K) {
  const int bn = dgrad_cols(K);
  const int n_ct = (C + bn - 1) / bn;
  const int n_mt = (M + kDgRows - 1) / kDgRows;
  int rows = sm_count() / n_ct;
  if (rows < 1) rows = 1;
  return rows < n_mt ? rows : n_mt;
}

// columns per tile of the wgmma forward: BN 64 covers K <= 64, BN 128 the
// rest
int fwd_cols(int K) { return K > 64 ? 128 : 64; }

// the forward's three regimes (bf16 rows TMA can read), chosen by (C, K):
// K <= 256 (ResNet-50's K 64 to 256): fwd_wgmma with one N tile of BN 64 or
// 128, or two of 128 for K 256 on neighbouring blocks; C <= 512 and K > 256
// with neither r nor y ((128, 512), (256, 1024), (512, 2048)): the y panel
// resident, fwd_panel_wgmma; C >= 1024 or r or y with K > 256 ((1024, 512),
// (2048, 512)): fwd_wgmma, the N tiles of one M tile on neighbouring blocks
bool fwd_on_panel(int C, int K) { return C <= 512 && K > 256; }

// blocks of the panel forward: one per SM, each over whole M tiles
int panel_rows(int M) {
  const int n_mt = (M + kFwRows - 1) / kFwRows;
  const int sms = sm_count();
  return sms < n_mt ? sms : n_mt;
}

// row-blocks of the wgmma forward: blocks per N tile, one block per SM
int fwd_rows(int M, int K) {
  const int bn = fwd_cols(K);
  const int n_nt = (K + bn - 1) / bn;
  const int n_mt = (M + kFwRows - 1) / kFwRows;
  int rows = sm_count() / n_nt;
  if (rows < 1) rows = 1;
  return rows < n_mt ? rows : n_mt;
}

// the wgmma wgrad's tile: MC m64 channel groups per warpgroup (BC = 128
// MC channels) by BN columns. Where K <= 64: 256 x 64, so one tile covers
// the stage-1 join's C x K (128 x 64 for C <= 128); K 128: 128 x 128;
// larger K: 128 x 256, 128 accumulators per thread. The tiles re-read x
// and r K / BN times and dz C / BC times through L2, which bounds the wide
// products: at ResNet-50's K 256-2048 edges 128 x 256 moves 25-33% fewer
// bytes there than 128 x 128
int wgrad_mc(int C, int K) { return C > 128 && K <= 64 ? 2 : 1; }
int wgrad_cols(int K) { return K > 128 ? 256 : K > 64 ? 128 : 64; }

// the wgmma wgrad's grid: n_ct x n_nt tiles, each over `ranges` ranges of
// `per` steps of M (the last may be shorter; none is empty)
struct WgGrid {
  int n_ct, n_nt, per, ranges;
};

WgGrid wgrad_grid(int M, int C, int K) {
  const int bc = 128 * wgrad_mc(C, K), bn = wgrad_cols(K);
  const int rows = kWgRows;
  WgGrid gr;
  gr.n_ct = (C + bc - 1) / bc;
  gr.n_nt = (K + bn - 1) / bn;
  const int n_st = (M + rows - 1) / rows;
  int s = sm_count() / (gr.n_ct * gr.n_nt);
  if (s < 1) s = 1;
  if (s > n_st) s = n_st;
  gr.per = (n_st + s - 1) / s;
  gr.ranges = (n_st + gr.per - 1) / gr.per;
  return gr;
}

// a bf16 (inner, outer) row-major matrix read or written in boxes of
// (64, box_outer) SW128 tiles
cudaError_t matrix_map(CUtensorMap* map, const void* base, int inner,
                       int outer, int box_outer) {
  const uint64_t dims[4] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(outer), 1, 1};
  const uint64_t row = 2ull * inner;
  const uint64_t strides[3] = {row, row * outer, row * outer};
  const uint32_t box[4] = {64, static_cast<uint32_t>(box_outer), 1, 1};
  return wg::tensor_map_bf16(map, base, dims, strides, box);
}

template <int BN, int kStages, int kBufs>
cudaError_t launch_dgrad_shape(const void* dz, const void* w, const void* x,
                               const void* r, const void* g,
                               const float* scale, const float* shift,
                               const float* mean, const float* inv_std,
                               void* dp, float* q, float* part, int M, int C,
                               int K, cudaStream_t st) {
  using L = DgSmem<BN, kStages, kBufs>;
  CUtensorMap tdz = {}, tw = {}, tx = {}, tr = {}, tg = {}, tdp = {};
  cudaError_t e = matrix_map(&tdz, dz, K, M, kDgRows);
  if (e == cudaSuccess) e = matrix_map(&tw, w, K, C, BN);
  if (e == cudaSuccess) e = matrix_map(&tx, x, C, M, kDgRows);
  if (e == cudaSuccess && r != nullptr) e = matrix_map(&tr, r, C, M, kDgRows);
  if (e == cudaSuccess && g != nullptr) e = matrix_map(&tg, g, C, M, kDgRows);
  if (e == cudaSuccess) e = matrix_map(&tdp, dp, C, M, kDgRows);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dgrad_wgmma<BN, kStages, kBufs>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
  if (e != cudaSuccess) return e;
  const int n_ct = (C + BN - 1) / BN;
  const int rows = dgrad_rows(M, C, K);
  dgrad_wgmma<BN, kStages, kBufs><<<rows * n_ct, kDgThreads, L::kBytes, st>>>(
      tdz, tw, tx, tr, tg, tdp, scale, shift, mean, inv_std, part, M, C, K,
      n_ct, r != nullptr, g != nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum<float>(part, q, rows, 2 * C, st);
}

cudaError_t launch_dgrad_wgmma(const void* dz, const void* w, const void* x,
                               const void* r, const void* g,
                               const float* scale, const float* shift,
                               const float* mean, const float* inv_std,
                               void* dp, float* q, float* part, int M, int C,
                               int K, cudaStream_t st) {
  if (dgrad_cols(K) == 128)
    return launch_dgrad_shape<128, 3, 1>(dz, w, x, r, g, scale, shift, mean,
                                         inv_std, dp, q, part, M, C, K, st);
  return launch_dgrad_shape<64, 3, 2>(dz, w, x, r, g, scale, shift, mean,
                                      inv_std, dp, q, part, M, C, K, st);
}

template <int BN, int kStages>
cudaError_t launch_fwd_shape(const void* x, const void* r, const float* scale,
                             const float* shift, const void* w, void* z,
                             void* y, float* zstats, float* part, int M, int C,
                             int K, cudaStream_t st) {
  using L = FwSmem<BN, kStages>;
  CUtensorMap tx = {}, tr = {}, tw = {}, ty = {}, tz = {};
  cudaError_t e = matrix_map(&tx, x, C, M, kFwRows);
  if (e == cudaSuccess && r != nullptr) e = matrix_map(&tr, r, C, M, kFwRows);
  if (e == cudaSuccess) e = matrix_map(&tw, w, K, C, 64);
  if (e == cudaSuccess && y != nullptr) e = matrix_map(&ty, y, C, M, 64);
  if (e == cudaSuccess) e = matrix_map(&tz, z, K, M, 64);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fwd_wgmma<BN, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
  if (e != cudaSuccess) return e;
  const int n_nt = (K + BN - 1) / BN;
  const int rows = fwd_rows(M, K);
  fwd_wgmma<BN, kStages><<<rows * n_nt, kDgThreads, L::kBytes, st>>>(
      tx, tr, tw, ty, tz, scale, shift, part, M, C, K, n_nt, r != nullptr,
      y != nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum<float>(part, zstats, rows, 2 * K, st);
}

template <int kStages>
cudaError_t launch_fwd_panel(const void* x, const float* scale,
                             const float* shift, const void* w, void* z,
                             float* zstats, float* part, int M, int C, int K,
                             cudaStream_t st) {
  using L = FpSmem<kStages>;
  CUtensorMap tx = {}, tw = {}, tz = {};
  cudaError_t e = matrix_map(&tx, x, C, M, kFwRows);
  if (e == cudaSuccess) e = matrix_map(&tw, w, K, C, 64);
  if (e == cudaSuccess) e = matrix_map(&tz, z, K, M, 64);
  const int bytes = L::bytes((C + 63) / 64);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fwd_panel_wgmma<kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return e;
  const int rows = panel_rows(M);
  fwd_panel_wgmma<kStages><<<rows, kDgThreads, bytes, st>>>(
      tx, tw, tz, scale, shift, part, M, C, K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum<float>(part, zstats, rows, 2 * K, st);
}

cudaError_t launch_fwd_wgmma(const void* x, const void* r, const float* scale,
                             const float* shift, const void* w, void* z,
                             void* y, float* zstats, float* part, int M, int C,
                             int K, cudaStream_t st) {
  if (r == nullptr && y == nullptr && fwd_on_panel(C, K))
    return launch_fwd_panel<3>(x, scale, shift, w, z, zstats, part, M, C, K,
                               st);
  if (fwd_cols(K) == 128)
    return launch_fwd_shape<128, 4>(x, r, scale, shift, w, z, y, zstats, part,
                                    M, C, K, st);
  return launch_fwd_shape<64, 5>(x, r, scale, shift, w, z, y, zstats, part,
                                 M, C, K, st);
}

template <int MC, int BN, int kStages>
cudaError_t launch_wgrad_shape(const void* x, const void* r,
                               const float* scale, const float* shift,
                               const void* dz, void* dw, float* part, int M,
                               int C, int K, int out_dtype, cudaStream_t st) {
  using L = WgSmem<MC, BN, kStages>;
  CUtensorMap tx = {}, tr = {}, tdz = {};
  cudaError_t e = matrix_map(&tx, x, C, M, kWgRows);
  if (e == cudaSuccess && r != nullptr)
    e = matrix_map(&tr, r, C, M, kWgRows);
  if (e == cudaSuccess) e = matrix_map(&tdz, dz, K, M, kWgRows);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgrad_wgmma<MC, BN, kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
  if (e != cudaSuccess) return e;
  const WgGrid gr = wgrad_grid(M, C, K);
  wgrad_wgmma<MC, BN, kStages>
      <<<gr.n_ct * gr.n_nt * gr.ranges, kWgThreads, L::kBytes, st>>>(
          tx, tr, tdz, scale, shift, part, M, C, K, gr.n_ct, gr.n_nt, gr.per,
          r != nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return out_dtype == 1 ? launch_sum<bf16>(part, dw, gr.ranges, C * K, st)
                        : launch_sum<float>(part, dw, gr.ranges, C * K, st);
}

cudaError_t launch_wgrad_wgmma(const void* x, const void* r,
                               const float* scale, const float* shift,
                               const void* dz, void* dw, float* part, int M,
                               int C, int K, int out_dtype, cudaStream_t st) {
  // ring stages of 72, 64, 48 or 40 KB: as many as fit about 200 KB
  if (wgrad_mc(C, K) == 2)
    return launch_wgrad_shape<2, 64, 3>(x, r, scale, shift, dz, dw, part, M,
                                        C, K, out_dtype, st);
  if (wgrad_cols(K) == 256)
    return launch_wgrad_shape<1, 256, 3>(x, r, scale, shift, dz, dw, part, M,
                                         C, K, out_dtype, st);
  if (wgrad_cols(K) == 128)
    return launch_wgrad_shape<1, 128, 4>(x, r, scale, shift, dz, dw, part, M,
                                         C, K, out_dtype, st);
  return launch_wgrad_shape<1, 64, 5>(x, r, scale, shift, dz, dw, part, M, C,
                                      K, out_dtype, st);
}

template <typename T, typename Z = T>
cudaError_t launch_fwd(const void* x, const void* r, const float* scale,
                       const float* shift, const void* w, void* z, void* y,
                       float* zstats, float* part, int M, int C, int K,
                       cudaStream_t st) {
  const dim3 grid(row_blocks(M), (K + kTN - 1) / kTN);
  fwd_kernel<T, Z><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, shift,
      static_cast<const T*>(w), static_cast<Z*>(z), static_cast<T*>(y), part,
      M, C, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum<float>(part, zstats, grid.x, 2 * K, st);
}

template <typename T>
cudaError_t launch_dgrad(const void* dz, const void* w, const void* x,
                         const void* r, const void* g, const float* scale,
                         const float* shift, const float* mean,
                         const float* inv_std, void* dp, float* q, float* part,
                         int M, int C, int K, cudaStream_t st) {
  const dim3 grid(row_blocks(M), (C + kTN - 1) / kTN);
  dgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(dz), static_cast<const T*>(w),
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(g), scale, shift, mean, inv_std,
      static_cast<T*>(dp), part, M, C, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_sum<float>(part, q, grid.x, 2 * C, st);
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* r, const float* scale,
                         const float* shift, const void* dz, void* dw,
                         float* part, int M, int C, int K, int out_dtype,
                         cudaStream_t st) {
  const int rows = split_rows(M, C, K);
  const dim3 grid((C + kTM - 1) / kTM, (K + kTN - 1) / kTN,
                  (M + rows - 1) / rows);
  wgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, shift,
      static_cast<const T*>(dz), part, M, C, K, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return out_dtype == 1 ? launch_sum<bf16>(part, dw, grid.z, C * K, st)
                        : launch_sum<float>(part, dw, grid.z, C * K, st);
}

bool bad_dims(int M, int C, int K) { return M <= 0 || C <= 0 || K <= 0; }

}  // namespace

// f32 elements of scratch a call needs: which = 0 forward, 1 dgrad,
// 2 wgrad, 3 the forward with another z dtype (fwd_kernel), sized for the
// kernel that the call's dtype, C and K take
extern "C" long long bigdl_fused_conv_scratch(int which, int M, int C, int K,
                                              int dtype) {
  if (bad_dims(M, C, K)) return 0;
  if (which == 3) return static_cast<long long>(row_blocks(M)) * 2 * K;
  const bool tma = on_wgmma(dtype, C, K);
  if (which == 0) {  // the panel forward's rows cover fwd_wgmma's too
    const int rows = !tma                 ? row_blocks(M)
                     : fwd_on_panel(C, K) ? panel_rows(M)
                                          : fwd_rows(M, K);
    return static_cast<long long>(rows) * 2 * K;
  }
  if (which == 1)
    return static_cast<long long>(tma ? dgrad_rows(M, C, K) : row_blocks(M)) *
           2 * C;
  if (tma) return static_cast<long long>(wgrad_grid(M, C, K).ranges) * C * K;
  const int rows = split_rows(M, C, K);
  return static_cast<long long>((M + rows - 1) / rows) * C * K;
}

// dtype: 0 = float32 (scalar FMA), 1 = bfloat16 (tensor cores: wgmma
// where C and K are multiples of 8, else mma.sync). r, y, g may be null.
// Returns the cudaError_t of the launches (0 = launched).
extern "C" int bigdl_fused_fwd(const void* x, const void* r,
                               const float* scale, const float* shift,
                               const void* w, void* z, void* y, float* zstats,
                               float* part, int M, int C, int K, int dtype,
                               void* stream) {
  if (bad_dims(M, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, C, K))
    return static_cast<int>(launch_fwd_wgmma(x, r, scale, shift, w, z, y,
                                             zstats, part, M, C, K, st));
  return static_cast<int>(
      dtype == 1
          ? launch_fwd<bf16>(x, r, scale, shift, w, z, y, zstats, part, M, C,
                             K, st)
          : launch_fwd<float>(x, r, scale, shift, w, z, y, zstats, part, M, C,
                              K, st));
}

// The forward with z stored in z_dtype (0 = float32, 1 = bfloat16) where
// it differs from x's dtype: the mma.sync / scalar kernel fwd_kernel with
// z's type as a parameter (the wgmma forwards store z in the data dtype).
// Its scratch is bigdl_fused_conv_scratch(3, ...).
extern "C" int bigdl_fused_fwd_zcast(const void* x, const void* r,
                                     const float* scale, const float* shift,
                                     const void* w, void* z, void* y,
                                     float* zstats, float* part, int M, int C,
                                     int K, int dtype, int z_dtype,
                                     void* stream) {
  if (bad_dims(M, C, K) || dtype == z_dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1
          ? launch_fwd<bf16, float>(x, r, scale, shift, w, z, y, zstats, part,
                                    M, C, K, st)
          : launch_fwd<float, bf16>(x, r, scale, shift, w, z, y, zstats, part,
                                    M, C, K, st));
}

extern "C" int bigdl_fused_dgrad(const void* dz, const void* w, const void* x,
                                 const void* r, const void* g,
                                 const float* scale, const float* shift,
                                 const float* mean, const float* inv_std,
                                 void* dp, float* q, float* part, int M, int C,
                                 int K, int dtype, void* stream) {
  if (bad_dims(M, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, C, K))
    return static_cast<int>(launch_dgrad_wgmma(dz, w, x, r, g, scale, shift,
                                               mean, inv_std, dp, q, part, M,
                                               C, K, st));
  return static_cast<int>(
      dtype == 1 ? launch_dgrad<bf16>(dz, w, x, r, g, scale, shift, mean,
                                      inv_std, dp, q, part, M, C, K, st)
                 : launch_dgrad<float>(dz, w, x, r, g, scale, shift, mean,
                                       inv_std, dp, q, part, M, C, K, st));
}

// out_dtype: dW's dtype, 0 = float32, 1 = bfloat16
extern "C" int bigdl_fused_wgrad(const void* x, const void* r,
                                 const float* scale, const float* shift,
                                 const void* dz, void* dw, float* part, int M,
                                 int C, int K, int dtype, int out_dtype,
                                 void* stream) {
  if (bad_dims(M, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, C, K))
    return static_cast<int>(launch_wgrad_wgmma(x, r, scale, shift, dz, dw,
                                               part, M, C, K, out_dtype, st));
  return static_cast<int>(
      dtype == 1 ? launch_wgrad<bf16>(x, r, scale, shift, dz, dw, part, M, C,
                                      K, out_dtype, st)
                 : launch_wgrad<float>(x, r, scale, shift, dz, dw, part, M, C,
                                       K, out_dtype, st));
}
