// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels with
// plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/flash_attention.py:
//   _fwd_kernel (:52)  -> fwd_wgmma / fwd_simt: O and the per-query LSE (f32)
//   _dq_kernel  (:149) -> dq_mma  / dq_simt:  dq from the saved LSE and
//                                             delta = sum_d dO*O
//   _dkv_kernel (:213) -> dkv_mma / dkv_simt: dk and dv over key tiles
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
//   * f32 inputs take the *_simt kernels: one thread per row, scalar f32 math,
//     the forward's online softmax updated key by key (the tensor cores have
//     no full-f32 path; the f32 path exists for checks and small models).
// bf16 forward, fwd_wgmma (wgmma.cuh's building blocks):
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
// bf16 backward, dq_mma / dkv_mma: 4 warps per block; each warp owns 16 rows
//   of the block's 64-row tile. The other operand arrives in 64-row tiles in
//   shared memory (rows padded by 8 elements so ldmatrix is conflict-free),
//   staged through registers. Scores stay in the mma.sync m16n8k16
//   accumulator registers; softmax reductions run over the 4 lanes that
//   share a row; p and ds are repacked in registers as the A operand of the
//   next mma (the accumulator layout of two n8 tiles is the A layout of one
//   k16 slice).
// The kernels allocate nothing and launch on the caller's stream.

#include <float.h>
#include <math.h>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the finite mask sentinel of the JAX code
constexpr int kRows = 64;          // rows per block tile (4 warps x 16)
constexpr int kThreads = 128;

// ------------------------------------------------------------ mma helpers

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand (16 rows x 16 k) of k16 slice kk, from accumulators of the
// n8 tiles 2kk and 2kk+1 (rows lane/4 and lane/4+8, columns 2*(lane%4)+{0,1}).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragment (16 x 16) of rows r0.. r0+15, columns c0.. c0+15 of a row-major
// shared tile with leading dimension LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n = n0..n0+15) at k = k0..k0+15 where the
// shared tile holds B^T row-major: element (k, n) at s[n * LD + k]
// (K for q.k^T, V for dO.v^T, Q for k.q^T, dO for v.dO^T).
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* s,
                                          int n0, int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (n = n0..n0+15) at k = k0..k0+15 where the
// shared tile holds B row-major: element (k, n) at s[k * LD + n]
// (V for p.v, K for ds.k, dO for p^T.dO, Q for ds^T.q).
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* s,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

// rows t0.. t0+63 of head h in batch b of a (B, T, H, D) bf16 tensor into a
// shared tile (kRows x LD); rows past T and columns past D are zero
template <int DP, int LD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int b, int h,
                                          int t0, int T, int H, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    int r = i / kChunks, c = (i % kChunks) * 8;
    int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T && c < D)
      val = *reinterpret_cast<const uint4*>(
          g + ((static_cast<size_t>(b) * T + t) * H + h) * D + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// score tile of one warp: s[8][4] = A-rows (fragments af) x 64 columns of
// the shared tile sb (held as B^T), over DP
template <int DP, int LD>
__device__ __forceinline__ void warp_scores(float s[8][4],
                                            const uint32_t af[DP / 16][4],
                                            const bf16* sb, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_nk<LD>(b, sb, np * 16, kk * 16, lane);
      mma16816(s[2 * np], af[kk], b[0], b[1]);
      mma16816(s[2 * np + 1], af[kk], b[2], b[3]);
    }
  }
}

// acc[DP/8][4] += P (16 x 64, accumulator layout, rounded to bf16 here) x
// the shared tile sb (64 x DP, held as B row-major)
template <int DP, int LD>
__device__ __forceinline__ void warp_pv(float acc[DP / 8][4],
                                        const float p[8][4], const bf16* sb,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      load_b_kn<LD>(b, sb, kk * 16, dp * 16, lane);
      mma16816(acc[2 * dp], a, b[0], b[1]);
      mma16816(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

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

// ------------------------------------------- bf16 backward (tensor cores)

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, int H, int Tq, int Tk, int D, int causal,
           int off, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kRows * LD;  // dO
  bf16* sK = sO + kRows * LD;
  bf16* sV = sK + kRows * LD;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int kt_end =
      key_tiles_for(q0, min(q0 + kRows, Tq) - 1, Tk, kRows, causal, off);

  load_tile<DP, LD>(sQ, q, b, h, q0, Tq, H, D);
  load_tile<DP, LD>(sO, dout, b, h, q0, Tq, H, D);
  __syncthreads();
  uint32_t qf[DP / 16][4], of[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    load_a<LD>(qf[kk], sQ, warp * 16, kk * 16, lane);
    load_a<LD>(of[kk], sO, warp * 16, kk * 16, lane);
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    lse_r[i] = row < Tq ? lse[at] : 0.f;
    delta_r[i] = row < Tq ? delta[at] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    load_tile<DP, LD>(sK, k, b, h, kt * kRows, Tk, H, D);
    load_tile<DP, LD>(sV, v, b, h, kt * kRows, Tk, H, D);
    __syncthreads();
    float s[8][4], dp[8][4];
    warp_scores<DP, LD>(s, qf, sK, lane);
    warp_scores<DP, LD>(dp, of, sV, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = r0 + i * 8;
        const int col = kt * kRows + j * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (causal && col > row + off) x = kNegInf;
        const float p = col < Tk ? expf(x - lse_r[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[i]);  // ds
      }
    warp_pv<DP, LD>(acc, s, sK, lane);  // dq += ds (bf16) . k
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
            __floats2bfloat162_rn(acc[n][2 * i] * scale,
                                  acc[n][2 * i + 1] * scale);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq,
            int Tk, int D, int causal, int off, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;
  bf16* sO = sQ + kRows * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + kRows * LD);  // lse
  float* sD = sL + kRows;                                 // delta
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr0 = k0 + warp * 16 + (lane >> 2);  // keys kr0 and kr0 + 8
  const int n_q = (Tq + kRows - 1) / kRows;

  load_tile<DP, LD>(sK, k, b, h, k0, Tk, H, D);
  load_tile<DP, LD>(sV, v, b, h, k0, Tk, H, D);
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = first_query_tile(k0, kRows, causal, off); qt < n_q; ++qt) {
    const int q0 = qt * kRows;
    __syncthreads();
    load_tile<DP, LD>(sQ, q, b, h, q0, Tq, H, D);
    load_tile<DP, LD>(sO, dout, b, h, q0, Tq, H, D);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int row = q0 + i;
      const size_t at = static_cast<size_t>(bh) * Tq + row;
      sL[i] = row < Tq ? lse[at] : 0.f;
      sD[i] = row < Tq ? delta[at] : 0.f;
    }
    __syncthreads();
    uint32_t kf[DP / 16][4], vf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      load_a<LD>(kf[kk], sK, warp * 16, kk * 16, lane);
      load_a<LD>(vf[kk], sV, warp * 16, kk * 16, lane);
    }
    float s[8][4], dp[8][4];
    warp_scores<DP, LD>(s, kf, sQ, lane);   // s^T: keys x queries
    warp_scores<DP, LD>(dp, vf, sO, lane);  // dp^T = v . dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr0 + (e >> 1) * 8;
        const int c = j * 8 + (lane & 3) * 2 + (e & 1);
        const int row = q0 + c;
        float x = s[j][e] * scale;
        if (causal && key > row + off) x = kNegInf;
        const float p = row < Tq ? expf(x - sL[c]) : 0.f;  // masked tail rows
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[c]);  // ds^T
      }
    warp_pv<DP, LD>(dva, s, sO, lane);   // dv += p^T (bf16) . dO
    warp_pv<DP, LD>(dka, dp, sQ, lane);  // dk += ds^T (bf16) . q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + i * 8;
    if (key >= Tk) continue;
    const size_t base = ((static_cast<size_t>(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + d) =
            __floats2bfloat162_rn(dka[n][2 * i] * scale,
                                  dka[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + d) =
            __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
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

// The forward's tensor maps over (B, T, H, D) bf16: boxes of 64 head dims
// x `rows` rows of one (batch, head), landing as SW128 panels
cudaError_t fwd_map(CUtensorMap* map, const void* t, int B, int T, int H,
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
  cudaError_t e = fwd_map(&mq, q, g.B, g.Tq, g.H, g.D, kFwdRows);
  if (e == cudaSuccess) e = fwd_map(&mk, k, g.B, g.Tk, g.H, g.D, kFwdKeys);
  if (e == cudaSuccess) e = fwd_map(&mv, v, g.B, g.Tk, g.H, g.D, kFwdKeys);
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

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, const Geometry& g, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const size_t bytes = 4 * kRows * (DP + 8) * sizeof(bf16);
    cudaError_t e = allow_smem(dq_mma<DP>, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((g.Tq + kRows - 1) / kRows, g.B * g.H);
    dq_mma<DP><<<grid, kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), g.H, g.Tq, g.Tk, g.D, g.causal, g.off,
        g.scale);
  } else {
    dim3 grid((g.Tq + kSimtRows - 1) / kSimtRows, g.B * g.H);
    dq_simt<DP><<<grid, kSimtRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), g.H, g.Tq, g.Tk, g.D, g.causal, g.off,
        g.scale);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, const Geometry& g, int dtype,
                       cudaStream_t st) {
  if (dtype == 1) {
    const size_t bytes =
        4 * kRows * (DP + 8) * sizeof(bf16) + 2 * kRows * sizeof(float);
    cudaError_t e = allow_smem(dkv_mma<DP>, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((g.Tk + kRows - 1) / kRows, g.B * g.H);
    dkv_mma<DP><<<grid, kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), g.H, g.Tq,
        g.Tk, g.D, g.causal, g.off, g.scale);
  } else {
    dim3 grid((g.Tk + kSimtRows - 1) / kSimtRows, g.B * g.H);
    dkv_simt<DP><<<grid, kSimtRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), g.H, g.Tq,
        g.Tk, g.D, g.causal, g.off, g.scale);
  }
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

extern "C" int bigdl_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int B, int H,
                              int Tq, int Tk, int D, int causal, int off,
                              float scale, int dtype, void* stream) {
  const Geometry g{B, H, Tq, Tk, D, causal, off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BIGDL_DQ(DP) \
  static_cast<int>(launch_dq<DP>(q, k, v, dout, lse, delta, dq, g, dtype, st))
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
