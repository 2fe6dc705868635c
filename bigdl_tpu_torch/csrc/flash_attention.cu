// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels with
// plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/flash_attention.py:
//   _fwd_kernel (:52)  -> fwd_wgmma / fwd_simt: O and the per-query LSE (f32)
//   _dq_kernel  (:149) -> dq_wgmma / dq_simt:   dq from the saved LSE and
//                                               delta = sum_d dO*O (bf16:
//                                               computed here for dk/dv)
//   _dkv_kernel (:213) -> dkv_wgmma / dkv_simt: dk and dv over key tiles
// Same function, element by element:
//   s  = (q . k) * scale, masked to -1e30 where col > row + offset (causal)
//   fwd: online softmax over key tiles; p = exp(s - m_running) is rounded to
//        V's dtype before p.v and the sum l takes the unrounded p;
//        O = acc / max(l, 1e-30), LSE = m + log(max(l, 1e-30))
//   bwd: p = exp(s - lse); dp = dO . v; ds = p * (dp - delta);
//        dq = scale * sum_k ds(k dtype) . k, dv = sum_q p(dO dtype)^T . dO,
//        dk = scale * sum_q ds(q dtype)^T . q
// A row that is fully masked (row + offset < 0, e.g. row 0 at offset -1)
// keeps m = -1e30 and gets p = 1 on every real key: O is the mean of V and
// LSE is -1e30, as the plain version computes it.
//
// Bound on the H100 SXM at the training shape (B*H = 96, T = 2048, D = 64,
// bf16, causal): operations. The causal half of the two forward matmuls is
// ~52 GFLOP (~52 us at the 989 TFLOP/s bf16 tensor-core peak), dq ~78 GFLOP,
// dk/dv ~104 GFLOP, against ~25-50 MB of traffic (~10 us at 3.35 TB/s). So
// the bf16 kernels run their matmuls on the tensor cores (f32 accumulate)
// and keep the scores in registers.
//
// Shared design:
//   * The TPU kernels carry the softmax state (or the dq / dk,dv sums) across
//     a sequential grid axis in VMEM scratch; Hopper's blocks run in no order,
//     so each block owns its query tile (fwd, dq) or key tile (dk/dv) and
//     LOOPS over the other axis itself. Nothing crosses blocks and no atomics
//     are used, so the results are the same from run to run (the
//     FlashAttention-2 split into dq and dk/dv).
//   * Causal: a query tile stops at the (offset) diagonal; the dk/dv tile
//     starts at the first query tile that can see it. A tile holding a fully
//     masked row (offset < 0) visits every key, so those rows get the plain
//     version's answer.
//   * Ragged T: keys past Tk get p = 0 and query rows past Tq get p = 0 in
//     dk/dv (the TPU kernel relies on zero-padded q and delta there); tiles
//     are zero filled past T and past the head dim.
//   * Layout: q, k, v, O, dO, dq, dk, dv are read and written in place in the
//     public (B, T, H, D) layout (contiguous), so no transposes surround the
//     call; LSE and delta are (B, H, Tq) f32.
//   * delta: the TPU wrapper computes it outside its kernels (XLA fuses that
//     into one pass); here the bf16 dq kernel computes it for its own rows
//     from O and dO and writes it for the dk/dv kernel, launched after it on
//     the same stream. The f32 path takes it from the caller, computed as
//     the plain version computes it, so that the f32 checks compare the
//     same sums.
//   * f32 inputs take the *_simt kernels: one thread per row, scalar f32 math,
//     the forward's online softmax updated key by key (the tensor cores have
//     no full-f32 path; the f32 path exists for checks and small models).
//   * bf16 inputs take the wgmma kernels, built from wgmma.cuh: TMA copies
//     into SW128 shared-memory tiles that complete on mbarriers, and wgmma
//     products with f32 accumulators in registers. Head dims up to 64 ride
//     in one 64-wide panel (zero filled), 128 in two.
// bf16 forward, fwd_wgmma:
//   * A block owns 128 query rows of one (batch, head): two warpgroups of 64
//     rows, two blocks per SM. One thread loads Q once and K/V tiles of 64
//     keys into a ring (4 stages at D <= 64, 2 at 128) by TMA: tensor maps
//     over (B, T, H, D) with boxes of 64 head dims, zero filled past T and
//     D, each tile landing as SW128 panels and completing on its stage's
//     "full" mbarrier. A stage is refilled once all 256 threads have
//     arrived on its "empty" mbarrier; the loading thread belongs to the
//     warpgroup that visits every tile and refills two tiles behind its own
//     (a separate loader warp would cost the registers that let two blocks
//     share an SM).
//   * S = Q K^T by wgmma m64n64k16 from shared memory (Q and K K-major);
//     P V by wgmma m64nDk16 with p repacked in registers as the A operand
//     and V MN-major in shared memory. Head dims up to 64 are one 64-wide
//     panel, 128 two. Tile j's softmax runs while tile j-1's P V is in
//     flight.
//   * The softmax keeps the running max of the raw scores; p = exp2(s c -
//     m c) with c = scale * log2(e) is one FFMA and one EX2 per score, and O
//     is rescaled only when some row's max moved. Masks only on the tile
//     that crosses the causal diagonal or the Tk edge; a warpgroup skips
//     the key tiles past its own diagonal.
// bf16 backward, dq_wgmma and dkv_wgmma: see the notes above each.
// The kernels allocate nothing and launch on the caller's stream.

#include <float.h>
#include <math.h>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the finite mask sentinel of the JAX code

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// one past the last key tile a query tile [q0, q0 + rows) must visit
__device__ __forceinline__ int key_tiles_for(int q0, int q_last, int Tk,
                                             int tile, int causal, int off) {
  int n_k = (Tk + tile - 1) / tile;
  if (!causal || q0 + off < 0) return n_k;  // fully masked rows see all keys
  return min(n_k, (q_last + off) / tile + 1);
}

// the first query tile that can see key tile [k0, ...)
__device__ __forceinline__ int first_query_tile(int k0, int tile, int causal,
                                                int off) {
  if (!causal || off < 0) return 0;  // offset < 0: fully masked rows see all
  return max(0, k0 - off) / tile;
}

// ------------------------------------------------ bf16 forward (wgmma, TMA)

constexpr int kFwdRows = 128;     // query rows per block: 2 warpgroups x 64
constexpr int kFwdKeys = 64;      // keys per K/V tile
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the forward: the Q tile (128 rows), a ring of K and V
// tiles (64 keys each), then the barriers; every tile is SW128 panels of
// 64 head-dim columns (wgmma.cuh), DP / 64 of them.
template <int DP>
struct FwdSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kStages = DP == 64 ? 4 : 2;
  static constexpr int kQPanel = kFwdRows * 128;
  static constexpr int kKVPanel = kFwdKeys * 128;
  static constexpr int kKV = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kK = kPanels * kQPanel;    // ring of K tiles
  static constexpr int kV = kK + kStages * kKV;   // ring of V tiles
  static constexpr int kBars = kV + kStages * kKV;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// q, k, v (B, T, H, D) bf16 through tensor maps (boxes of 64 head dims x
// 128 query rows or 64 keys; zero filled past T and D); o (B, Tq, H, D);
// lse (B, H, Tq). scale_log2 = scale * log2(e), so exp2((s - m) *
// scale_log2) is the plain version's exp((s - m) * scale).
template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 2)
    fwd_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              float* __restrict__ lse, int H, int Tq, int Tk, int D,
              int causal, int off, float scale_log2) {
  using L = FwdSmem<DP>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;  // stage s: its K and V tiles landed
  uint64_t* empty = full + S;   // stage s: both warpgroups are done with it
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // the longest causal tiles first: they bound the kernel's tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  int kt_wg[2];  // key tiles each warpgroup's 64 rows must visit
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r0 = q0 + 64 * g;
    kt_wg[g] = r0 < Tq ? key_tiles_for(r0, min(r0 + 64, Tq) - 1, Tk, kFwdKeys,
                                       causal, off)
                       : 1;  // rows past Tq: one tile, never stored
  }
  const int kt_end = max(kt_wg[0], kt_wg[1]);
  // the thread that loads: thread 0 of the warpgroup that visits every tile
  const int loader = kt_wg[1] == kt_end ? 128 : 0;
  const bool loads = threadIdx.x == loader;
  // tile j into stage j % S, completing on full[j % S]
  auto load_kv = [&](int j) {
    const int s = j % S;
    wg::mbar_expect_tx(full + s, 2 * L::kKV);
    for (int p = 0; p < L::kPanels; ++p) {
      const int at = s * L::kKV + p * L::kKVPanel;
      const int t0 = j * kFwdKeys;
      wg::tma_load_4d(sm + L::kK + at, &tk, full + s, 64 * p, h, t0, b);
      wg::tma_load_4d(sm + L::kV + at, &tv, full + s, 64 * p, h, t0, b);
    }
  };
  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 2 * 128);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (loads) {
    wg::mbar_expect_tx(q_full, L::kK);
    for (int p = 0; p < L::kPanels; ++p)
      wg::tma_load_4d(sm + p * L::kQPanel, &tq, q_full, 64 * p, h, q0, b);
    for (int j = 0; j < min(S, kt_end); ++j) load_kv(j);
  }
  // this warpgroup is done with tile j; the loader then refills the stage
  // of tile r = j - kLag + 1 with tile r + S once both warpgroups are done
  // with r (a lag of 2 with 4 stages: the other warpgroup has had a tile's
  // time to finish r, so the loader rarely waits for it)
  constexpr int kLag = S >= 4 ? 2 : 1;
  auto release = [&](int j) {
    wg::mbar_arrive(empty + j % S);
    const int r = j - kLag + 1;
    if (loads && r >= 0 && r + S < kt_end) {
      wg::mbar_wait(empty + r % S, (r / S) & 1);
      load_kv(r + S);
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // consumers: warpgroup g owns query rows q0 + 64g .. q0 + 64g + 63.
  // Tile j's softmax runs while tile j-1's P V is in flight:
  //   start S_j = Q K_j^T; start O += P_{j-1} V_{j-1}; wait for S_j;
  //   mask, max and exp of S_j; wait for P V; rescale O; repack P_j.
  // The first and the last tile are peeled off, so the loop starts its
  // products unconditionally.
  const int g = warp >> 2;
  const int g_row0 = q0 + 64 * g;
  const int r0 = g_row0 + 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int n_kt = kt_wg[g];
  const unsigned char* sQ = sm + g * 64 * 128;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // running max of the raw scores (-inf before the first key) and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[kFwdKeys / 16][4];  // P of the last tile: the A fragments of P V

  // S = Q K^T of stage s (Q and K K-major in shared memory)
  auto start_s = [&](float (&sc)[kFwdKeys / 2], int s) {
    const unsigned char* sK = sm + L::kK + s * L::kKV;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::mma_ss_n64<0>(
          sc, wg::desc_k_major(sQ + (kk >> 2) * L::kQPanel + (kk & 3) * 32),
          wg::desc_k_major(sK + (kk >> 2) * L::kKVPanel + (kk & 3) * 32),
          kk > 0);
  };
  // O += P V of stage s (V MN-major in shared memory)
  auto start_pv = [&](int s) {
    const unsigned char* sV = sm + L::kV + s * L::kKV;
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
      const uint64_t dv = wg::desc_mn_major(sV + kk * 2048, L::kKVPanel);
      if constexpr (DP == 64)
        wg::mma_rs_n64<1>(acc, pa[kk], dv, 1);
      else
        wg::mma_rs_n128<1>(acc, pa[kk], dv, 1);
    }
  };
  // masks (only on a tile that crosses the diagonal or the Tk edge), the
  // new running max mx (raw scores) and p = exp2(s c - mx c) in place, one
  // FFMA and one EX2 per score, with its row sums. A causally masked score
  // holds -FLT_MAX and a key past Tk -inf, so p = 0 for both; a row masked
  // everywhere so far (only when causal_offset < 0) keeps mx = -FLT_MAX and
  // takes p = 1 on its causally masked keys, as the plain version does.
  auto exp_tile = [&](float (&sc)[kFwdKeys / 2], int j, float (&mx)[2],
                      float (&rs)[2]) {
    const int k0 = j * kFwdKeys;
    const bool edge =
        k0 + kFwdKeys > Tk || (causal && k0 + kFwdKeys - 1 > g_row0 + off);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kFwdKeys / 2; ++e) {
        const int col = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (col >= Tk) sc[e] = -INFINITY;
        else if (causal && col > r0 + 8 * ((e >> 1) & 1) + off)
          sc[e] = -FLT_MAX;
      }
    }
    mx[0] = m[0];
    mx[1] = m[1];
#pragma unroll
    for (int e = 0; e < kFwdKeys / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float bias[2] = {-mx[0] * scale_log2, -mx[1] * scale_log2};
    rs[0] = rs[1] = 0.f;
    if (edge && (mx[0] == -FLT_MAX || mx[1] == -FLT_MAX)) {
#pragma unroll
      for (int e = 0; e < kFwdKeys / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float p = mx[i] == -FLT_MAX
                            ? (sc[e] == -FLT_MAX ? 1.f : 0.f)
                            : wg::exp2_approx(fmaf(sc[e], scale_log2, bias[i]));
        rs[i] += p;
        sc[e] = p;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kFwdKeys / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float p = wg::exp2_approx(fmaf(sc[e], scale_log2, bias[i]));
        rs[i] += p;
        sc[e] = p;
      }
    }
  };
  // rescale O and l to the new max (O only when some row's max moved); p
  // rounded to bf16 as P's A fragments
  auto rescale_and_pack = [&](const float (&sc)[kFwdKeys / 2],
                              const float (&mx)[2], const float (&rs)[2]) {
    const bool moved = m[0] != mx[0] || m[1] != mx[1];
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = wg::exp2_approx((m[i] - mx[i]) * scale_log2);
      l[i] = l[i] * alpha[i] + quad_sum(rs[i]);
      m[i] = mx[i];
    }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] =
            wg::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  wg::mbar_wait(q_full, 0);
  {  // tile 0
    float sc[kFwdKeys / 2], mx[2], rs[2];
    wg::mbar_wait(full, 0);
    wg::fence();
    start_s(sc, 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(sc);
    exp_tile(sc, 0, mx, rs);
    rescale_and_pack(sc, mx, rs);
  }
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % S, sp = (j - 1) % S;
    float sc[kFwdKeys / 2], mx[2], rs[2];
    wg::mbar_wait(full + s, (j / S) & 1);
    wg::fence_acc(acc);
    wg::fence();
    start_s(sc, s);
    wg::commit();
    start_pv(sp);
    wg::commit();
    wg::wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
    wg::fence_acc(sc);
    exp_tile(sc, j, mx, rs);
    wg::wait<0>();  // P_{j-1} V_{j-1} is done with its registers and stage
    wg::fence_acc(acc);
    release(j - 1);
    rescale_and_pack(sc, mx, rs);
  }
  {  // the last tile's P V
    const int sp = (n_kt - 1) % S;
    wg::fence_acc(acc);
    wg::fence();
    start_pv(sp);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
    release(n_kt - 1);
  }
  // the tiles past this warpgroup's diagonal that the other one needs
  for (int j = n_kt; j < kt_end; ++j) {
    wg::mbar_wait(full + j % S, (j / S) & 1);
    wg::mbar_arrive(empty + j % S);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const size_t base = ((static_cast<size_t>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(o + base + d) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] / l_safe,
                                  acc[4 * n + 2 * i + 1] / l_safe);
    }
    // a fully masked row keeps the sentinel, as the plain version does
    if ((lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          m[i] == -FLT_MAX ? kNegInf
                           : m[i] * scale_log2 * kLn2 + logf(l_safe);
  }
}

// ----------------------------------------------- bf16 backward (wgmma, TMA)

// sum + the dot product of 8 bf16 values of a with 8 of b, in f32
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float sum) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    sum = fmaf(fx.x, fy.x, sum);
    sum = fmaf(fx.y, fy.y, sum);
  }
  return sum;
}

// dq_wgmma replaces _dq_kernel (bigdl_tpu/ops/flash_attention.py:149).
// Bound: operations (three matmuls over the kept (query, key) pairs: ~78
// GFLOP, ~79 us at the training shape). The design gives the tensor cores
// wgmma and keeps copies off the threads:
//   * A block owns 64 G query rows of one (batch, head), G warpgroups of 64
//     (G = 3 at D <= 64, 2 at D 128). Q and dO of those rows arrive once by
//     TMA; K and V tiles of 64 keys arrive in a ring (4 stages at D <= 64,
//     3 at 128) that one consumer thread of a warpgroup visiting every tile
//     refills, as in the forward.
//   * Per key tile each warpgroup starts S = Q K^T and dP = dO V^T (wgmma
//     from shared memory, all four operands K-major) and, behind them, dQ +=
//     dS K of the previous tile (dS as register A fragments; K read a
//     second time through an MN-major descriptor of the same SW128 stage).
//     p is computed while dP and that dQ product run, ds while dQ runs.
//   * p = exp2(s * scale log2(e) - lse log2(e)): one FFMA and one EX2 per
//     score; ds = p (dp - delta). Masks only on the tile that crosses the
//     causal diagonal or the Tk edge; a warpgroup stops at its own diagonal
//     and the longest query tiles run first.
//   * delta = sum_d dO*O of the block's rows is computed in the prologue,
//     from O rows read from global memory while the TMA copies land and
//     from the landed dO tile, and written to delta (B, H, Tq) for dk/dv.
//     The grid covers every query row, so every delta row is written
//     before the dk/dv kernel, launched next on the same stream, reads it.
//   * Registers: S, dP and dQ (f32, 64 x 64 each at D 64) and the dS
//     fragments take 167 a thread (ptxas, D 64). Two blocks of two
//     warpgroups per SM would leave 128, and ptxas then spilled and
//     serialized the wgmmas (C7512); so one block per SM, which at D 64
//     holds three warpgroups (3 x 128 threads x 167 registers fit the SM's
//     65,536) and was 7% faster than two in one call on the H100.
template <int DP, int G>
struct DqSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kRowPanel = G * 64 * 128;      // the block's rows x 64
  static constexpr int kKeyPanel = kFwdKeys * 128;    // 64 keys x 64 dims
  static constexpr int kTile = kPanels * kKeyPanel;   // one K or V tile
  static constexpr int kDO = kPanels * kRowPanel;     // Q at 0, then dO
  static constexpr int kK = 2 * kDO;                  // ring of K tiles
  static constexpr int kV = kK + kStages * kTile;     // ring of V tiles
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// q, k, v, dO (B, T, H, D) bf16 through tensor maps (boxes of 64 head dims
// x 64 G query rows or 64 keys; zero filled past T and D); o (B, Tq, H, D);
// lse (B, H, Tq) f32; delta (B, H, Tq) f32, written here; dq (B, Tq, H, D)
template <int DP, int G>
__global__ void __launch_bounds__(G * 128, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const bf16* __restrict__ o, const float* __restrict__ lse,
             float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tq,
             int Tk, int D, int causal, int off, float scale) {
  using L = DqSmem<DP, G>;
  constexpr int S = L::kStages;
  constexpr int kN = kFwdKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;  // stage s: its K and V tiles landed
  uint64_t* empty = full + S;   // stage s: every warpgroup is done with it
  // the longest causal tiles of every head first (blockIdx.x runs over
  // the heads): they bound the kernel's tail
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64 * G;
  // key tiles warpgroup g's 64 rows must visit
  auto tiles_of = [&](int g) {
    const int r0 = q0 + 64 * g;
    return r0 < Tq ? key_tiles_for(r0, min(r0 + 64, Tq) - 1, Tk, kN, causal,
                                   off)
                   : 1;  // rows past Tq: one tile, never stored
  };
  int kt_end = 0, loader = 0;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (tiles_of(g) > kt_end) kt_end = tiles_of(g), loader = 128 * g;
  // the thread that loads: thread 0 of a warpgroup that visits every tile
  const bool loads = threadIdx.x == loader;
  // key tile j into stage j % S, completing on full[j % S]
  auto load_kv = [&](int j) {
    const int s = j % S;
    wg::mbar_expect_tx(full + s, 2 * L::kTile);
    for (int p = 0; p < L::kPanels; ++p) {
      const int at = s * L::kTile + p * L::kKeyPanel;
      wg::tma_load_4d(sm + L::kK + at, &tk, full + s, 64 * p, h, j * kN, b);
      wg::tma_load_4d(sm + L::kV + at, &tv, full + s, 64 * p, h, j * kN, b);
    }
  };
  if (threadIdx.x == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, G * 128);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (loads) {
    wg::mbar_expect_tx(q_full, 2 * L::kDO);
    for (int p = 0; p < L::kPanels; ++p) {
      const int at = p * L::kRowPanel;
      wg::tma_load_4d(sm + at, &tq, q_full, 64 * p, h, q0, b);
      wg::tma_load_4d(sm + L::kDO + at, &tdo, q_full, 64 * p, h, q0, b);
    }
    for (int j = 0; j < min(S, kt_end); ++j) load_kv(j);
  }
  // this warpgroup is done with tile j; the loader then refills the stage
  // of tile r = j - kLag + 1 with tile r + S once every warpgroup is done
  // with r
  constexpr int kLag = S >= 4 ? 2 : 1;
  auto release = [&](int j) {
    wg::mbar_arrive(empty + j % S);
    const int r = j - kLag + 1;
    if (loads && r >= 0 && r + S < kt_end) {
      wg::mbar_wait(empty + r % S, (r / S) & 1);
      load_kv(r + S);
    }
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp >> 2;
  const int g_row0 = q0 + 64 * g;
  const int lr = 16 * (warp & 3) + (lane >> 2);  // rows lr, lr + 8 of the 64
  const int r0 = g_row0 + lr;
  const int n_kt = tiles_of(g);
  const unsigned char* sQ = sm + g * 64 * 128;
  const unsigned char* sDO = sm + L::kDO + g * 64 * 128;
  const float c = scale * kLog2e;

  // delta of rows r0 and r0 + 8: the four lanes of a row take the 16-byte
  // chunks (lane & 3) and (lane & 3) + 4 of each 64-wide panel; O is read
  // from global memory before the wait for the TMA copies, dO from the
  // landed tile
  uint4 ov[2][L::kPanels][2];
  float bias[2];  // -lse log2(e) of the two rows
  bool dead[2];   // fully masked rows: lse at the sentinel
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool in = row < Tq;
    const float l = in ? lse[static_cast<size_t>(bh) * Tq + row] : 0.f;
    bias[i] = -l * kLog2e;
    dead[i] = l == kNegInf;
    const bf16* orow =
        o + ((static_cast<size_t>(b) * Tq + (in ? row : 0)) * H + h) * D;
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = 64 * p + 8 * ((lane & 3) + 4 * u);
        ov[i][p][u] = in && d < D
                          ? *reinterpret_cast<const uint4*>(orow + d)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
  }
  float dl[2];  // delta of the two rows
  wg::mbar_wait(q_full, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        sum = dot8(*reinterpret_cast<const uint4*>(
                       sDO + p * L::kRowPanel +
                       wg::sw128(lr + 8 * i, (lane & 3) + 4 * u)),
                   ov[i][p][u], sum);
    dl[i] = quad_sum(sum);
    const int row = r0 + 8 * i;
    if ((lane & 3) == 0 && row < Tq)
      delta[static_cast<size_t>(bh) * Tq + row] = dl[i];
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t dsa[kN / 16][4];  // dS of the last tile: the A fragments of dQ

  // S = Q K^T and dP = dO V^T of stage s (all four operands K-major)
  auto start_s = [&](float (&sc)[kN / 2], int s) {
    const unsigned char* sK = sm + L::kK + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::mma_ss_n64<0>(
          sc, wg::desc_k_major(sQ + (kk >> 2) * L::kRowPanel + (kk & 3) * 32),
          wg::desc_k_major(sK + (kk >> 2) * L::kKeyPanel + (kk & 3) * 32),
          kk > 0);
  };
  auto start_dp = [&](float (&dp)[kN / 2], int s) {
    const unsigned char* sV = sm + L::kV + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wg::mma_ss_n64<0>(
          dp, wg::desc_k_major(sDO + (kk >> 2) * L::kRowPanel + (kk & 3) * 32),
          wg::desc_k_major(sV + (kk >> 2) * L::kKeyPanel + (kk & 3) * 32),
          kk > 0);
  };
  // dQ += dS K of stage s (K MN-major: each key's row along the head dims)
  auto start_dq = [&](int s) {
    const unsigned char* sK = sm + L::kK + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t dk = wg::desc_mn_major(sK + kk * 2048, L::kKeyPanel);
      if constexpr (DP == 64)
        wg::mma_rs_n64<1>(acc, dsa[kk], dk, 1);
      else
        wg::mma_rs_n128<1>(acc, dsa[kk], dk, 1);
    }
  };
  // p = exp2(s c - lse log2(e)) in place of the scores. Masks only on a
  // tile that crosses the causal diagonal or the Tk edge: keys past Tk take
  // p = 0, causally masked keys p = 0, or p = 1 in a fully masked row (the
  // plain version's exp(-1e30 - lse) with lse at the -1e30 sentinel)
  auto p_tile = [&](float (&sc)[kN / 2], int j) {
    const int k0 = j * kN;
    const bool edge =
        k0 + kN > Tk || (causal && k0 + kN - 1 > g_row0 + off);
    if (edge) {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const int i = (e >> 1) & 1;
        const int col = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        float p = wg::exp2_approx(fmaf(sc[e], c, bias[i]));
        if (col >= Tk)
          p = 0.f;
        else if (causal && col > r0 + 8 * i + off)
          p = dead[i] ? 1.f : 0.f;
        sc[e] = p;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kN / 2; ++e)
        sc[e] = wg::exp2_approx(fmaf(sc[e], c, bias[(e >> 1) & 1]));
    }
  };
  // ds = p (dp - delta) in place of p
  auto ds_tile = [&](float (&sc)[kN / 2], const float (&dp)[kN / 2]) {
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) sc[e] *= dp[e] - dl[(e >> 1) & 1];
  };
  // ds rounded to bf16 as dQ's A fragments
  auto pack = [&](const float (&sc)[kN / 2]) {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dsa[kk][r] =
            wg::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // Tile j's p runs while its dP and tile j-1's dQ += dS K are in flight,
  // and its ds while that dQ product runs:
  //   start S_j; start dP_j; start dQ += dS_{j-1} K_{j-1}; wait for S_j;
  //   p_j; wait for dP_j; ds_j; wait for dQ; repack dS_j.
  // The first tile and the last tile's dQ product are peeled off, so the
  // loop starts its products unconditionally.
  {  // tile 0
    float sc[kN / 2], dp[kN / 2];
    wg::mbar_wait(full, 0);
    wg::fence();
    start_s(sc, 0);
    wg::commit();
    start_dp(dp, 0);
    wg::commit();
    wg::wait<1>();
    wg::fence_acc(sc);
    p_tile(sc, 0);
    wg::wait<0>();
    wg::fence_acc(dp);
    ds_tile(sc, dp);
    pack(sc);
  }
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % S, sp = (j - 1) % S;
    float sc[kN / 2], dp[kN / 2];
    wg::mbar_wait(full + s, (j / S) & 1);
    wg::fence_acc(acc);
    wg::fence();
    start_s(sc, s);
    wg::commit();
    start_dp(dp, s);
    wg::commit();
    start_dq(sp);
    wg::commit();
    wg::wait<2>();  // S_j is done
    wg::fence_acc(sc);
    p_tile(sc, j);
    wg::wait<1>();  // dP_j is done; dQ += dS_{j-1} K_{j-1} may still run
    wg::fence_acc(dp);
    ds_tile(sc, dp);
    wg::wait<0>();  // the dQ product is done with its registers and stage
    wg::fence_acc(acc);
    wg::fence_frag(dsa);
    release(j - 1);
    pack(sc);
  }
  {  // the last tile's dQ += dS K
    wg::fence_acc(acc);
    wg::fence();
    start_dq((n_kt - 1) % S);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
    release(n_kt - 1);
  }
  // the tiles past this warpgroup's diagonal that the others need
  for (int j = n_kt; j < kt_end; ++j) {
    wg::mbar_wait(full + j % S, (j / S) & 1);
    wg::mbar_arrive(empty + j % S);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= Tq) continue;
    const size_t base = ((static_cast<size_t>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + d) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale,
                                  acc[4 * n + 2 * i + 1] * scale);
    }
  }
}

// dkv_wgmma replaces _dkv_kernel (bigdl_tpu/ops/flash_attention.py:213).
// Bound: operations (four matmuls over the kept pairs: ~104 GFLOP, ~105 us
// at the training shape). Design:
//   * A block owns 128 keys of one (batch, head), two warpgroups of 64.
//     Their K and V arrive once by TMA and stay in shared memory.
//   * The block walks the query tiles from the first that can see its keys
//     (first_query_tile). A tile of QN queries brings Q and dO by TMA and
//     its QN LSE and delta values by 4-byte cp.async (rows past Tq zero),
//     all completing on one stage's "full" mbarrier of a 4-stage ring that
//     both warpgroups read. The loading warp belongs to warpgroup 0, which
//     visits every tile, and refills a stage two tiles behind its own.
//   * Per query tile: S^T = K Q^T and dP^T = V dO^T (wgmma from shared
//     memory, all K-major), p^T and ds^T = p^T (dp^T - delta) in
//     registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
//     register A fragments and dO and Q read MN-major from the same stage.
//     p is computed while dP^T and the previous tile's dV and dK products
//     run, ds while those run.
//   * p = exp2(s * scale log2(e) - lse log2(e)), lse and delta per column
//     from the stage. Masks only on a tile that crosses the causal diagonal
//     or holds the Tq edge (query rows past Tq take p = 0). Keys past Tk
//     are zero rows of K and V whose dk and dv rows are never stored.
//   * Registers: four f32 accumulators (S^T, dP^T, dK, dV) and the P^T and
//     dS^T fragments: 214 a thread at D 64 (ptxas), one block of 256
//     threads per SM. At D 128 a query tile of 64 took 255 registers and
//     spilled, so QN is 32 there (m64n32 products; 242 registers).
constexpr int kDkvKeys = 128;     // keys per dk/dv block
constexpr int kDkvThreads = 256;  // two warpgroups of 64 keys

template <int DP, int QN>
struct DkvSmem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kStages = 4;
  static constexpr int kRowPanel = kDkvKeys * 128;      // 128 keys x 64 dims
  static constexpr int kQPanel = QN * 128;              // QN queries x 64
  static constexpr int kTile = kPanels * kQPanel;       // one Q or dO tile
  static constexpr int kV = kPanels * kRowPanel;        // K at 0, then V
  static constexpr int kQ = 2 * kV;                     // ring of Q tiles
  static constexpr int kDO = kQ + kStages * kTile;      // ring of dO tiles
  static constexpr int kLse = kDO + kStages * kTile;    // ring of QN LSEs
  static constexpr int kDelta = kLse + kStages * QN * 4;  // and deltas
  static constexpr int kBars = kDelta + kStages * QN * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// d (m64 x nN, f32) = A x B, both from shared memory, K-major
template <int N>
__device__ __forceinline__ void mma_ss_kk(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wg::mma_ss_n64<0>(d, da, db, scale_d);
  else
    wg::mma_ss_n32<0>(d, da, db, scale_d);
}

// q, k, v, dO (B, T, H, D) bf16 through tensor maps (boxes of 64 head dims
// x QN query rows or 128 keys; zero filled past T and D); lse and delta
// (B, H, Tq) f32; dk, dv (B, Tk, H, D)
template <int DP, int QN>
__global__ void __launch_bounds__(kDkvThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
              int Tk, int D, int causal, int off, float scale) {
  using L = DkvSmem<DP, QN>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = wg::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;  // stage s: its Q, dO, LSE and delta landed
  uint64_t* empty = full + S;    // stage s: both warpgroups are done with it
  // the key blocks with the most query tiles (k0 = 0) of every head first
  // (blockIdx.x runs over the heads): they bound the kernel's tail
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kDkvKeys;
  const int n_q = (Tq + QN - 1) / QN;
  // each warpgroup's first query tile: the first that can see its keys, at
  // most the last tile (which it then sees fully masked), so that each
  // warpgroup runs the loop below at least once
  int qb[2];
#pragma unroll
  for (int g = 0; g < 2; ++g)
    qb[g] = min(first_query_tile(k0 + 64 * g, QN, causal, off), n_q - 1);
  const int qt0 = qb[0];      // the block's first tile (qb[0] <= qb[1])
  const int n_t = n_q - qt0;  // tiles the block loads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool loads = warp == 0;  // warpgroup 0 visits every tile
  // query tile qt0 + t into stage t % S: Q and dO by TMA, LSE and delta by
  // the warp's 4-byte copies (zero past Tq), all completing on full[t % S]
  auto load_q = [&](int t) {
    const int s = t % S, qt = qt0 + t;
    float* sl = reinterpret_cast<float*>(sm + L::kLse) + s * QN;
    float* sd = reinterpret_cast<float*>(sm + L::kDelta) + s * QN;
    for (int i = lane; i < QN; i += 32) {
      const int row = qt * QN + i;
      const size_t at = static_cast<size_t>(bh) * Tq + min(row, Tq - 1);
      wg::cp_async_4(sl + i, lse + at, row < Tq);
      wg::cp_async_4(sd + i, delta + at, row < Tq);
    }
    wg::cp_async_mbar_arrive(full + s);
    if (lane == 0) {
      wg::mbar_expect_tx(full + s, 2 * L::kTile);
      for (int p = 0; p < L::kPanels; ++p) {
        const int at = s * L::kTile + p * L::kQPanel;
        const int t0 = qt * QN;
        wg::tma_load_4d(sm + L::kQ + at, &tq, full + s, 64 * p, h, t0, b);
        wg::tma_load_4d(sm + L::kDO + at, &tdo, full + s, 64 * p, h, t0, b);
      }
    }
  };
  if (threadIdx.x == 0) {
    wg::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + s, 1 + 32);  // the TMA's arrival and the warp's
      wg::mbar_init(empty + s, kDkvThreads);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (loads) {
    if (lane == 0) {
      wg::mbar_expect_tx(kv_full, 2 * L::kV);
      for (int p = 0; p < L::kPanels; ++p) {
        const int at = p * L::kRowPanel;
        wg::tma_load_4d(sm + at, &tk, kv_full, 64 * p, h, k0, b);
        wg::tma_load_4d(sm + L::kV + at, &tv, kv_full, 64 * p, h, k0, b);
      }
    }
    for (int t = 0; t < min(S, n_t); ++t) load_q(t);
  }
  // this warpgroup is done with tile t; the loading warp then refills the
  // stage of tile r = t - 1 with tile r + S once both warpgroups are done
  // with r
  auto release = [&](int t) {
    wg::mbar_arrive(empty + t % S);
    const int r = t - 1;
    if (loads && r >= 0 && r + S < n_t) {
      wg::mbar_wait(empty + r % S, (r / S) & 1);
      load_q(r + S);
    }
  };
  const int g = warp >> 2;
  const int k0g = k0 + 64 * g;
  const int key0 = k0g + 16 * (warp & 3) + (lane >> 2);  // keys key0, +8
  const unsigned char* sK = sm + g * 64 * 128;
  const unsigned char* sV = sm + L::kV + g * 64 * 128;
  const float c = scale * kLog2e;
  const int tb = qb[g] - qt0;  // this warpgroup's first tile
  // tiles that cannot see this warpgroup's keys (warpgroup 1 only)
  for (int t = 0; t < tb; ++t) {
    wg::mbar_wait(full + t % S, (t / S) & 1);
    wg::mbar_arrive(empty + t % S);
  }

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  // P^T and dS^T of the last tile: the A fragments of dV and dK
  uint32_t pa[QN / 16][4], dsa[QN / 16][4];

  // S^T = K Q^T and dP^T = V dO^T of stage s (all four operands K-major)
  auto start_s = [&](float (&sc)[QN / 2], int s) {
    const unsigned char* sQ = sm + L::kQ + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss_kk<QN>(
          sc, wg::desc_k_major(sK + (kk >> 2) * L::kRowPanel + (kk & 3) * 32),
          wg::desc_k_major(sQ + (kk >> 2) * L::kQPanel + (kk & 3) * 32),
          kk > 0);
  };
  auto start_dp = [&](float (&dp)[QN / 2], int s) {
    const unsigned char* sO = sm + L::kDO + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss_kk<QN>(
          dp, wg::desc_k_major(sV + (kk >> 2) * L::kRowPanel + (kk & 3) * 32),
          wg::desc_k_major(sO + (kk >> 2) * L::kQPanel + (kk & 3) * 32),
          kk > 0);
  };
  // dV += P^T dO and dK += dS^T Q of stage s (dO and Q MN-major)
  auto start_dk_dv = [&](int s) {
    const unsigned char* sQ = sm + L::kQ + s * L::kTile;
    const unsigned char* sO = sm + L::kDO + s * L::kTile;
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk) {
      const uint64_t d_o = wg::desc_mn_major(sO + kk * 2048, L::kQPanel);
      const uint64_t d_q = wg::desc_mn_major(sQ + kk * 2048, L::kQPanel);
      if constexpr (DP == 64) {
        wg::mma_rs_n64<1>(dva, pa[kk], d_o, 1);
        wg::mma_rs_n64<1>(dka, dsa[kk], d_q, 1);
      } else {
        wg::mma_rs_n128<1>(dva, pa[kk], d_o, 1);
        wg::mma_rs_n128<1>(dka, dsa[kk], d_q, 1);
      }
    }
  };
  // p = exp2(s c - lse log2(e)) in place of the scores, the columns' lse
  // from stage t % S. Masks only on a tile that crosses the causal
  // diagonal or holds the Tq edge: query rows past Tq take p = 0, causally
  // masked pairs p = 0, or p = 1 in a fully masked row (lse at the -1e30
  // sentinel, as the plain version's exp(-1e30 - lse))
  auto p_tile = [&](float (&sc)[QN / 2], int t) {
    const int q0 = (qt0 + t) * QN;
    const float* sl =
        reinterpret_cast<const float*>(sm + L::kLse) + (t % S) * QN;
    const bool edge = q0 + QN > Tq || (causal && k0g + 63 > q0 + off);
#pragma unroll
    for (int n = 0; n < QN / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
      const float bias[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = wg::exp2_approx(fmaf(sc[4 * n + e], c, bias[e & 1]));
        if (edge) {
          const int row = q0 + col + (e & 1), key = key0 + 8 * (e >> 1);
          if (row >= Tq)
            p = 0.f;
          else if (causal && key > row + off)
            p = ((e & 1) ? l2.y : l2.x) == kNegInf ? 1.f : 0.f;
        }
        sc[4 * n + e] = p;
      }
    }
  };
  // ds = p (dp - delta) in place of dp, the columns' delta from the stage
  auto ds_tile = [&](const float (&sc)[QN / 2], float (&dp)[QN / 2], int t) {
    const float* sd =
        reinterpret_cast<const float*>(sm + L::kDelta) + (t % S) * QN;
#pragma unroll
    for (int n = 0; n < QN / 8; ++n) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sd + 8 * n + 2 * (lane & 3));
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - dl[e & 1]);
    }
  };
  // p and ds rounded to bf16 as the A fragments of dV and dK
  auto pack = [&](const float (&sc)[QN / 2], const float (&dp)[QN / 2]) {
#pragma unroll
    for (int kk = 0; kk < QN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = wg::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        dsa[kk][r] = wg::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
  };

  // Tile t's p runs while its dP^T and tile t-1's dV and dK products are in
  // flight, and its ds while those run:
  //   start S^T_t; start dP^T_t; start dV, dK of t-1; wait for S^T_t; p_t;
  //   wait for dP^T_t; ds_t; wait for dV, dK; repack P^T_t and dS^T_t.
  // This warpgroup's first tile and the last tile's dV and dK products are
  // peeled off, so the loop starts its products unconditionally.
  wg::mbar_wait(kv_full, 0);
  {  // this warpgroup's first tile
    float sc[QN / 2], dp[QN / 2];
    wg::mbar_wait(full + tb % S, (tb / S) & 1);
    wg::fence();
    start_s(sc, tb % S);
    wg::commit();
    start_dp(dp, tb % S);
    wg::commit();
    wg::wait<1>();
    wg::fence_acc(sc);
    p_tile(sc, tb);
    wg::wait<0>();
    wg::fence_acc(dp);
    ds_tile(sc, dp, tb);
    pack(sc, dp);
  }
  for (int t = tb + 1; t < n_t; ++t) {
    const int s = t % S, sp = (t - 1) % S;
    float sc[QN / 2], dp[QN / 2];
    wg::mbar_wait(full + s, (t / S) & 1);
    wg::fence_acc(dka);
    wg::fence_acc(dva);
    wg::fence();
    start_s(sc, s);
    wg::commit();
    start_dp(dp, s);
    wg::commit();
    start_dk_dv(sp);
    wg::commit();
    wg::wait<2>();  // S^T of tile t is done
    wg::fence_acc(sc);
    p_tile(sc, t);
    wg::wait<1>();  // dP^T of tile t is done; dK, dV of t-1 may still run
    wg::fence_acc(dp);
    ds_tile(sc, dp, t);
    wg::wait<0>();  // dK and dV of tile t-1 are done with their registers
    wg::fence_acc(dka);
    wg::fence_acc(dva);
    wg::fence_frag(pa);
    wg::fence_frag(dsa);
    release(t - 1);
    pack(sc, dp);
  }
  {  // the last tile's dV and dK products
    wg::fence_acc(dka);
    wg::fence_acc(dva);
    wg::fence();
    start_dk_dv((n_t - 1) % S);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(dka);
    wg::fence_acc(dva);
    release(n_t - 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= Tk) continue;
    const size_t base = ((static_cast<size_t>(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + d) =
            __floats2bfloat162_rn(dka[4 * n + 2 * i] * scale,
                                  dka[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + d) =
            __floats2bfloat162_rn(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ f32 (scalar)

constexpr int kSimtRows = 64;  // one thread per row
constexpr int kSimtTile = 32;  // rows of the other operand per shared tile

template <int DP>
__device__ __forceinline__ void load_row(float r[DP], const float* g, int b,
                                         int h, int t, int T, int H, int D) {
#pragma unroll
  for (int d = 0; d < DP; ++d)
    r[d] = (t < T && d < D)
               ? g[((static_cast<size_t>(b) * T + t) * H + h) * D + d]
               : 0.f;
}

template <int DP>
__device__ __forceinline__ void load_simt_tile(float* s, const float* g, int b,
                                               int h, int t0, int T, int H,
                                               int D) {
  for (int i = threadIdx.x; i < kSimtTile * DP; i += blockDim.x) {
    int r = i / DP, d = i % DP, t = t0 + r;
    s[i] = (t < T && d < D)
               ? g[((static_cast<size_t>(b) * T + t) * H + h) * D + d]
               : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ float dot_row(const float a[DP], const float* s) {
  float x = 0.f;
#pragma unroll
  for (int d = 0; d < DP; ++d) x = fmaf(a[d], s[d], x);
  return x;
}

template <int DP>
__device__ __forceinline__ void store_row(float* g, const float r[DP],
                                          float mul, int b, int h, int t,
                                          int T, int H, int D) {
  if (t >= T) return;
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < D) g[((static_cast<size_t>(b) * T + t) * H + h) * D + d] =
        r[d] * mul;
}

template <int DP>
__global__ void __launch_bounds__(kSimtRows)
    fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Tq, int Tk, int D,
             int causal, int off, float scale) {
  __shared__ float sK[kSimtTile * DP], sV[kSimtTile * DP];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kSimtRows, row = q0 + threadIdx.x;
  const int kt_end = key_tiles_for(q0, min(q0 + kSimtRows, Tq) - 1, Tk,
                                   kSimtTile, causal, off);
  float qr[DP], acc[DP];
  load_row<DP>(qr, q, b, h, row, Tq, H, D);
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    load_simt_tile<DP>(sK, k, b, h, kt * kSimtTile, Tk, H, D);
    load_simt_tile<DP>(sV, v, b, h, kt * kSimtTile, Tk, H, D);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kSimtTile; ++j) {
      const int col = kt * kSimtTile + j;
      if (col >= Tk) break;
      float x = dot_row<DP>(qr, sK + j * DP) * scale;
      if (causal && col > row + off) x = kNegInf;
      if (x > m) {  // a new running max rescales the sums
        const float alpha = expf(m - x);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] *= alpha;
        m = x;
      }
      const float p = expf(x - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, sV[j * DP + d], acc[d]);
    }
  }
  const float l_safe = fmaxf(l, 1e-30f);
  store_row<DP>(o, acc, 1.f / l_safe, b, h, row, Tq, H, D);
  if (row < Tq) lse[static_cast<size_t>(bh) * Tq + row] = m + logf(l_safe);
}

template <int DP>
__global__ void __launch_bounds__(kSimtRows)
    dq_simt(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Tq, int Tk, int D, int causal,
            int off, float scale) {
  __shared__ float sK[kSimtTile * DP], sV[kSimtTile * DP];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kSimtRows, row = q0 + threadIdx.x;
  const int kt_end = key_tiles_for(q0, min(q0 + kSimtRows, Tq) - 1, Tk,
                                   kSimtTile, causal, off);
  float qr[DP], dor[DP], acc[DP];
  load_row<DP>(qr, q, b, h, row, Tq, H, D);
  load_row<DP>(dor, dout, b, h, row, Tq, H, D);
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  const size_t at = static_cast<size_t>(bh) * Tq + row;
  const float lse_r = row < Tq ? lse[at] : 0.f;
  const float delta_r = row < Tq ? delta[at] : 0.f;
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    load_simt_tile<DP>(sK, k, b, h, kt * kSimtTile, Tk, H, D);
    load_simt_tile<DP>(sV, v, b, h, kt * kSimtTile, Tk, H, D);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kSimtTile; ++j) {
      const int col = kt * kSimtTile + j;
      if (col >= Tk) break;
      float x = dot_row<DP>(qr, sK + j * DP) * scale;
      if (causal && col > row + off) x = kNegInf;
      const float p = expf(x - lse_r);
      const float ds = p * (dot_row<DP>(dor, sV + j * DP) - delta_r);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, sK[j * DP + d], acc[d]);
    }
  }
  store_row<DP>(dq, acc, scale, b, h, row, Tq, H, D);
}

template <int DP>
__global__ void __launch_bounds__(kSimtRows)
    dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int H, int Tq,
             int Tk, int D, int causal, int off, float scale) {
  __shared__ float sQ[kSimtTile * DP], sO[kSimtTile * DP];
  __shared__ float sL[kSimtTile], sD[kSimtTile];
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kSimtRows, key = k0 + threadIdx.x;
  const int n_q = (Tq + kSimtTile - 1) / kSimtTile;
  float kr[DP], vr[DP], dka[DP], dva[DP];
  load_row<DP>(kr, k, b, h, key, Tk, H, D);
  load_row<DP>(vr, v, b, h, key, Tk, H, D);
#pragma unroll
  for (int d = 0; d < DP; ++d) dka[d] = dva[d] = 0.f;
  for (int qt = first_query_tile(k0, kSimtTile, causal, off); qt < n_q;
       ++qt) {
    const int q0 = qt * kSimtTile;
    __syncthreads();
    load_simt_tile<DP>(sQ, q, b, h, q0, Tq, H, D);
    load_simt_tile<DP>(sO, dout, b, h, q0, Tq, H, D);
    for (int i = threadIdx.x; i < kSimtTile; i += blockDim.x) {
      const int row = q0 + i;
      const size_t at = static_cast<size_t>(bh) * Tq + row;
      sL[i] = row < Tq ? lse[at] : 0.f;
      sD[i] = row < Tq ? delta[at] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kSimtTile; ++i) {
      const int row = q0 + i;
      if (row >= Tq) break;  // masked tail rows
      float x = dot_row<DP>(kr, sQ + i * DP) * scale;
      if (causal && key > row + off) x = kNegInf;
      const float p = expf(x - sL[i]);
      const float ds = p * (dot_row<DP>(vr, sO + i * DP) - sD[i]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dva[d] = fmaf(p, sO[i * DP + d], dva[d]);
        dka[d] = fmaf(ds, sQ[i * DP + d], dka[d]);
      }
    }
  }
  store_row<DP>(dk, dka, scale, b, h, key, Tk, H, D);
  store_row<DP>(dv, dva, 1.f, b, h, key, Tk, H, D);
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Geometry {
  int B, H, Tq, Tk, D, causal, off;
  float scale;
};

// A tensor map over (B, T, H, D) bf16: boxes of 64 head dims x `rows` rows
// of one (batch, head), landing as SW128 panels
cudaError_t tile_map(CUtensorMap* map, const void* t, int B, int T, int H,
                    int D, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(T),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * T * H * D};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return wg::tensor_map_bf16(map, t, dims, strides, box);
}

template <int DP>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, float* lse, const Geometry& g,
                             cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  cudaError_t e = tile_map(&mq, q, g.B, g.Tq, g.H, g.D, kFwdRows);
  if (e == cudaSuccess) e = tile_map(&mk, k, g.B, g.Tk, g.H, g.D, kFwdKeys);
  if (e == cudaSuccess) e = tile_map(&mv, v, g.B, g.Tk, g.H, g.D, kFwdKeys);
  constexpr int bytes = FwdSmem<DP>::kBytes;
  if (e == cudaSuccess) e = allow_smem(fwd_wgmma<DP>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Tq + kFwdRows - 1) / kFwdRows, g.B * g.H);
  fwd_wgmma<DP><<<grid, kFwdThreads, bytes, st>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, g.H, g.Tq, g.Tk, g.D, g.causal,
      g.off, g.scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Geometry& g, int dtype,
                       cudaStream_t st) {
  // bf16 head dims up to 64 ride in one 64-wide panel (zero filled)
  if (dtype == 1)
    return launch_fwd_wgmma<DP <= 64 ? 64 : 128>(q, k, v, o, lse, g, st);
  dim3 grid((g.Tq + kSimtRows - 1) / kSimtRows, g.B * g.H);
  fwd_simt<DP><<<grid, kSimtRows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, g.H, g.Tq,
      g.Tk, g.D, g.causal, g.off, g.scale);
  return cudaGetLastError();
}

// warpgroups (of 64 query rows) per dq block
template <int DP>
constexpr int kDqGroups = DP == 64 ? 3 : 2;

template <int DP>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* delta, void* dq, const Geometry& g,
                            cudaStream_t st) {
  constexpr int G = kDqGroups<DP>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = tile_map(&mq, q, g.B, g.Tq, g.H, g.D, 64 * G);
  if (e == cudaSuccess) e = tile_map(&mdo, dout, g.B, g.Tq, g.H, g.D, 64 * G);
  if (e == cudaSuccess) e = tile_map(&mk, k, g.B, g.Tk, g.H, g.D, kFwdKeys);
  if (e == cudaSuccess) e = tile_map(&mv, v, g.B, g.Tk, g.H, g.D, kFwdKeys);
  constexpr int bytes = DqSmem<DP, G>::kBytes;
  if (e == cudaSuccess) e = allow_smem(dq_wgmma<DP, G>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(g.B * g.H, (g.Tq + 64 * G - 1) / (64 * G));
  dq_wgmma<DP, G><<<grid, G * 128, bytes, st>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o), lse, delta,
      static_cast<bf16*>(dq), g.H, g.Tq, g.Tk, g.D, g.causal, g.off, g.scale);
  return cudaGetLastError();
}

// queries per dk/dv query tile: 32 at D 128 keeps dK and dV in registers
template <int DP>
constexpr int kDkvQueries = DP == 64 ? 64 : 32;

template <int DP>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const Geometry& g, cudaStream_t st) {
  constexpr int QN = kDkvQueries<DP>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = tile_map(&mq, q, g.B, g.Tq, g.H, g.D, QN);
  if (e == cudaSuccess) e = tile_map(&mdo, dout, g.B, g.Tq, g.H, g.D, QN);
  if (e == cudaSuccess) e = tile_map(&mk, k, g.B, g.Tk, g.H, g.D, kDkvKeys);
  if (e == cudaSuccess) e = tile_map(&mv, v, g.B, g.Tk, g.H, g.D, kDkvKeys);
  constexpr int bytes = DkvSmem<DP, QN>::kBytes;
  if (e == cudaSuccess) e = allow_smem(dkv_wgmma<DP, QN>, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(g.B * g.H, (g.Tk + kDkvKeys - 1) / kDkvKeys);
  dkv_wgmma<DP, QN><<<grid, kDkvThreads, bytes, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), g.H, g.Tq, g.Tk, g.D, g.causal, g.off, g.scale);
  return cudaGetLastError();
}

// bf16: delta is written (from o and dout); f32: delta is read (o unused)
template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, const Geometry& g, int dtype,
                      cudaStream_t st) {
  if (dtype == 1)
    return launch_dq_wgmma<DP <= 64 ? 64 : 128>(q, k, v, o, dout, lse, delta,
                                                dq, g, st);
  dim3 grid((g.Tq + kSimtRows - 1) / kSimtRows, g.B * g.H);
  dq_simt<DP><<<grid, kSimtRows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), g.H, g.Tq, g.Tk, g.D, g.causal, g.off,
      g.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, const Geometry& g, int dtype,
                       cudaStream_t st) {
  if (dtype == 1)
    return launch_dkv_wgmma<DP <= 64 ? 64 : 128>(q, k, v, dout, lse, delta,
                                                 dk, dv, g, st);
  dim3 grid((g.Tk + kSimtRows - 1) / kSimtRows, g.B * g.H);
  dkv_simt<DP><<<grid, kSimtRows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), g.H, g.Tq,
      g.Tk, g.D, g.causal, g.off, g.scale);
  return cudaGetLastError();
}

// head dims are padded to the next of 16/32/64/128 (zero filled)
#define BIGDL_DISPATCH_DP(D, CALL)            \
  do {                                        \
    if ((D) <= 16) return CALL(16);           \
    if ((D) <= 32) return CALL(32);           \
    if ((D) <= 64) return CALL(64);           \
    if ((D) <= 128) return CALL(128);         \
    return static_cast<int>(cudaErrorInvalidValue); \
  } while (0)

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, int B, int H, int Tq,
                               int Tk, int D, int causal, int off, float scale,
                               int dtype, void* stream) {
  const Geometry g{B, H, Tq, Tk, D, causal, off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIGDL_FWD(DP) \
  static_cast<int>(launch_fwd<DP>(q, k, v, o, lse, g, dtype, st))
  BIGDL_DISPATCH_DP(D, BIGDL_FWD);
#undef BIGDL_FWD
}

// delta (B, H, Tq) f32, sum_d dO*O of every query row, which
// bigdl_flash_dkv reads after this on the same stream: with dtype 1 (bf16)
// the kernel computes it from o and dout and writes it; with dtype 0 (f32)
// the caller has computed it (as the plain version does) and o is unused.
extern "C" int bigdl_flash_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq, int B,
                              int H, int Tq, int Tk, int D, int causal,
                              int off, float scale, int dtype, void* stream) {
  const Geometry g{B, H, Tq, Tk, D, causal, off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIGDL_DQ(DP)                                                       \
  static_cast<int>(                                                        \
      launch_dq<DP>(q, k, v, o, dout, lse, delta, dq, g, dtype, st))
  BIGDL_DISPATCH_DP(D, BIGDL_DQ);
#undef BIGDL_DQ
}

extern "C" int bigdl_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv, int B,
                               int H, int Tq, int Tk, int D, int causal,
                               int off, float scale, int dtype, void* stream) {
  const Geometry g{B, H, Tq, Tk, D, causal, off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIGDL_DKV(DP)                                                       \
  static_cast<int>(                                                         \
      launch_dkv<DP>(q, k, v, dout, lse, delta, dk, dv, g, dtype, st))
  BIGDL_DISPATCH_DP(D, BIGDL_DKV);
#undef BIGDL_DKV
}
