// Fused BN-apply -> ReLU -> 1x1 conv for Hopper (sm_90a): forward, dgrad and
// wgrad kernels with plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/fused_conv.py:
//   _fwd_kernel   (:141) -> fwd_kernel:   z = relu(x*scale + shift [+ r]) @ W,
//                            zstats = [sum z, sum z^2] per output channel
//                            (from the f32 accumulator), optional y
//   _dgrad_kernel (:281) -> dgrad_wgmma (bf16, C and K multiples of 8) and
//                            dgrad_kernel (f32, and bf16 rows TMA cannot
//                            read): dp = (dz @ W^T [+ dy]) * 1[p > 0],
//                            q = [sum dp, sum dp*xhat] per input channel
//   _wgrad_kernel (:405) -> wgrad_kernel: dW = relu(x*scale + shift [+ r])^T
//                            @ dz, y recomputed and never stored
// Operands are row-major: x, r, y, dp (M, C); dz, z (M, K); W, dW (C, K);
// scale, shift, mean, inv_std (C,) f32. An NHWC activation is (M, C) rows.
// Element by element, as the plain versions (bigdl_tpu_torch/ops/
// fused_conv.py) compute it: p = (x*scale) + shift + r, each op rounded once
// (no FMA contraction), y = max(p, 0) rounded to the data dtype before the
// product, products accumulated in f32, xhat = (x - mean) * inv_std.
//
// Bound on the H100 SXM: bytes. At ResNet-50's edges (bf16, C = 256..2048,
// K = 64..2048, M = 12,544..802,816) one pass over the operands at 3.35 TB/s
// takes longer than 2*M*C*K FLOP at 989 TFLOP/s on every edge of stages 1-3,
// so the design keeps the activation between BN and conv out of memory (the
// prologue applies BN and ReLU while the A tile loads) and reads each operand
// about once; the product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate) to stay off the arithmetic limit.
//
// Design of the forward, the wgrad and the mma.sync dgrad (simple and right
// first; the bf16 dgrad's wgmma design is described at dgrad_wgmma):
//   * One 64 x 64 output tile per block step, 4 warps, K-depth 32 per stage.
//     bf16: each warp owns 16 rows and runs mma.sync from ldmatrix fragments
//     (tiles padded by 8 elements); f32: each thread owns an 8 x 4 sub-tile of
//     scalar FMAs (the tensor cores have no full-f32 path). The tile helpers
//     live in mma_tile.cuh, shared with conv3x3.cu.
//   * The accumulator tile goes to shared memory as f32, and the epilogue
//     (z/dp stores, the dgrad mask, per-channel sums) walks it with one thread
//     per column, so stores are coalesced and the sums come from the f32
//     values before any rounding.
//   * Cross-row reductions are deterministic and use no atomics: the forward
//     and dgrad blocks each walk a fixed set of M tiles (tile b, b + grid, ...)
//     and write one partial row per block; wgrad splits M into fixed ranges
//     and writes one partial dW per range; sum_rows then adds the partial rows
//     in a fixed order. Results repeat bitwise from run to run.
//   * Ragged M, C and K are masked in the kernels (no padding copies); rows
//     past M are zero in the A tile, so they add nothing to z or the sums.
//     16-byte vector loads when the row length is a multiple of 8.
// The kernels allocate nothing (the wrapper passes the partials' scratch,
// sized by bigdl_fused_conv_scratch) and launch on the caller's stream.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const float* __restrict__ scale, const float* __restrict__ shift,
               const T* __restrict__ w, T* __restrict__ z, T* __restrict__ y,
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
        z[static_cast<size_t>(m) * K + n] = from_f<T>(v);
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

// the bf16 dgrad takes the wgmma kernel where TMA can read the rows
bool dgrad_on_wgmma(int dtype, int C, int K) {
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

template <typename T>
cudaError_t launch_fwd(const void* x, const void* r, const float* scale,
                       const float* shift, const void* w, void* z, void* y,
                       float* zstats, float* part, int M, int C, int K,
                       cudaStream_t st) {
  const dim3 grid(row_blocks(M), (K + kTN - 1) / kTN);
  fwd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, shift,
      static_cast<const T*>(w), static_cast<T*>(z), static_cast<T*>(y), part,
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
// 2 wgrad
extern "C" long long bigdl_fused_conv_scratch(int which, int M, int C, int K) {
  if (bad_dims(M, C, K)) return 0;
  if (which == 0) return static_cast<long long>(row_blocks(M)) * 2 * K;
  if (which == 1) {  // either dgrad kernel: the larger of their row counts
    const int rows = dgrad_rows(M, C, K);
    return static_cast<long long>(rows > row_blocks(M) ? rows : row_blocks(M)) *
           2 * C;
  }
  const int rows = split_rows(M, C, K);
  return static_cast<long long>((M + rows - 1) / rows) * C * K;
}

// dtype: 0 = float32 (scalar FMA), 1 = bfloat16 (tensor cores: mma.sync;
// the dgrad on wgmma where C and K are multiples of 8). r, y, g may be
// null. Returns the cudaError_t of the launches (0 = launched).
extern "C" int bigdl_fused_fwd(const void* x, const void* r,
                               const float* scale, const float* shift,
                               const void* w, void* z, void* y, float* zstats,
                               float* part, int M, int C, int K, int dtype,
                               void* stream) {
  if (bad_dims(M, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1
          ? launch_fwd<bf16>(x, r, scale, shift, w, z, y, zstats, part, M, C,
                             K, st)
          : launch_fwd<float>(x, r, scale, shift, w, z, y, zstats, part, M, C,
                              K, st));
}

extern "C" int bigdl_fused_dgrad(const void* dz, const void* w, const void* x,
                                 const void* r, const void* g,
                                 const float* scale, const float* shift,
                                 const float* mean, const float* inv_std,
                                 void* dp, float* q, float* part, int M, int C,
                                 int K, int dtype, void* stream) {
  if (bad_dims(M, C, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dgrad_on_wgmma(dtype, C, K))
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
  return static_cast<int>(
      dtype == 1 ? launch_wgrad<bf16>(x, r, scale, shift, dz, dw, part, M, C,
                                      K, out_dtype, st)
                 : launch_wgrad<float>(x, r, scale, shift, dz, dw, part, M, C,
                                       K, out_dtype, st));
}
