// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels with
// plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/flash_attention.py:
//   _fwd_kernel (:52)  -> fwd_mma / fwd_simt: O and the per-query LSE (f32)
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
// the bf16 kernels run their matmuls on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate) and keep the scores in registers.
//
// Design (simple and right first; cp.async/TMA pipelining and wgmma are later
// work):
//   * The TPU kernels carry the softmax state (or the dq / dk,dv sums) across
//     a sequential grid axis in VMEM scratch; Hopper's blocks run in no order,
//     so each block owns its query tile (fwd, dq) or key tile (dk/dv) and
//     LOOPS over the other axis itself. Nothing crosses blocks and no atomics
//     are used, so the gradients are the same from run to run (the
//     FlashAttention-2 split into dq and dk/dv).
//   * 4 warps per block; each warp owns 16 rows of the block's 64-row tile.
//     The other operand arrives in 64-row tiles in shared memory (rows padded
//     by 8 elements so ldmatrix is conflict-free). Scores stay in the mma
//     accumulator registers; softmax reductions run over the 4 lanes that
//     share a row; p and ds are repacked in registers as the A operand of the
//     next mma (the accumulator layout of two n8 tiles is the A layout of one
//     k16 slice).
//   * Causal: a query tile stops at the (offset) diagonal; the dk/dv tile
//     starts at the first query tile that can see it. A tile holding a fully
//     masked row (offset < 0) visits every key, so those rows get the plain
//     version's answer.
//   * Ragged T: rows past Tq and keys past Tk are never read (tiles are zero
//     filled in shared memory); keys past Tk get p = 0 and query rows past Tq
//     get p = 0 in dk/dv (the TPU kernel relies on zero-padded q and delta
//     there). Head dims below the tile width (D < 16, 48, ...) are zero filled.
//   * Layout: q, k, v, O, dO, dq, dk, dv are read and written in place in the
//     public (B, T, H, D) layout (contiguous), so no transposes surround the
//     call; LSE and delta are (B, H, Tq) f32.
//   * f32 inputs take the *_simt kernels: one thread per row, scalar f32 math,
//     the forward's online softmax updated key by key (the tensor cores have
//     no full-f32 path; the f32 path exists for checks and small models).
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------- bf16 (tensor cores)

template <int DP>
__global__ void __launch_bounds__(kThreads)
    fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o,
            float* __restrict__ lse, int H, int Tq, int Tk, int D, int causal,
            int off, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;
  bf16* sV = sK + kRows * LD;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // the longest causal tiles first: they bound the kernel's tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int kt_end =
      key_tiles_for(q0, min(q0 + kRows, Tq) - 1, Tk, kRows, causal, off);

  load_tile<DP, LD>(sQ, q, b, h, q0, Tq, H, D);
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    load_a<LD>(qf[kk], sQ, warp * 16, kk * 16, lane);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DP, LD>(sK, k, b, h, kt * kRows, Tk, H, D);
    load_tile<DP, LD>(sV, v, b, h, kt * kRows, Tk, H, D);
    __syncthreads();
    float s[8][4];
    warp_scores<DP, LD>(s, qf, sK, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int col = kt * kRows + j * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (col >= Tk) x = -INFINITY;  // past the keys: p = 0 exactly
        else if (causal && col > row + off) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = expf(m[i] - mx[i]);
      l[i] = l[i] * alpha + quad_sum(rs[i]);
      m[i] = mx[i];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
    warp_pv<DP, LD>(acc, s, sV, lane);
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
            __floats2bfloat162_rn(acc[n][2 * i] / l_safe,
                                  acc[n][2 * i + 1] / l_safe);
    }
    if ((lane & 3) == 0)
      lse[static_cast<size_t>(bh) * Tq + row] = m[i] + logf(l_safe);
  }
}

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

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Geometry& g, int dtype,
                       cudaStream_t st) {
  if (dtype == 1) {
    const size_t bytes = 3 * kRows * (DP + 8) * sizeof(bf16);
    cudaError_t e = allow_smem(fwd_mma<DP>, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((g.Tq + kRows - 1) / kRows, g.B * g.H);
    fwd_mma<DP><<<grid, kThreads, bytes, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, g.H, g.Tq,
        g.Tk, g.D, g.causal, g.off, g.scale);
  } else {
    dim3 grid((g.Tq + kSimtRows - 1) / kSimtRows, g.B * g.H);
    fwd_simt<DP><<<grid, kSimtRows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, g.H, g.Tq,
        g.Tk, g.D, g.causal, g.off, g.scale);
  }
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
