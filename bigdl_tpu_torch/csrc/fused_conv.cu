// Fused BN-apply -> ReLU -> 1x1 conv for Hopper (sm_90a): forward, dgrad and
// wgrad kernels with plain C entry points.
//
// Replaces the three Pallas TPU kernels of bigdl_tpu/ops/fused_conv.py:
//   _fwd_kernel   (:141) -> fwd_kernel:   z = relu(x*scale + shift [+ r]) @ W,
//                            zstats = [sum z, sum z^2] per output channel
//                            (from the f32 accumulator), optional y
//   _dgrad_kernel (:281) -> dgrad_kernel: dp = (dz @ W^T [+ dy]) * 1[p > 0],
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
// Design (simple and right first; cp.async/TMA pipelining and wgmma are later
// work):
//   * One 64 x 64 output tile per block step, 4 warps, K-depth 32 per stage.
//     bf16: each warp owns 16 rows and runs mma.sync from ldmatrix fragments
//     (tiles padded by 8 elements); f32: each thread owns an 8 x 4 sub-tile of
//     scalar FMAs (the tensor cores have no full-f32 path).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTM = 64;             // output tile rows
constexpr int kTN = 64;             // output tile columns
constexpr int kBK = 32;             // reduction depth per stage
constexpr int kThreads = 128;       // 4 warps
constexpr int kLdA = kBK + 8;       // A tile [kTM][kLdA]
constexpr int kLdKN = kTN + 8;      // B tile held (k, n): [kBK][kLdKN]
constexpr int kLdNK = kBK + 8;      // B tile held (n, k): [kTN][kLdNK]
constexpr int kLdO = kTN + 4;       // f32 accumulator tile [kTM][kLdO]
constexpr int kBSize = (kBK * kLdKN > kTN * kLdNK) ? kBK * kLdKN : kTN * kLdNK;
constexpr int kMaxRowBlocks = 768;  // fwd/dgrad blocks along M
constexpr int kWgradBlocks = 1024;  // wgrad blocks aimed at (tiles x splits)
constexpr int kMinSplitRows = 256;

// ---------------------------------------------------------------- scalars

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// p = x*scale + shift + r, each op rounded once; relu(p)
__device__ __forceinline__ float pre_act(float x, float s, float b, float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, s), b), r);
}

// ------------------------------------------------------- 8-element chunks

__device__ __forceinline__ void load8_vec(float v[8], const float* g) {
  const float4 a = reinterpret_cast<const float4*>(g)[0];
  const float4 b = reinterpret_cast<const float4*>(g)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8_vec(float v[8], const bf16* g) {
  const uint4 u = *reinterpret_cast<const uint4*>(g);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void zero8(float v[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
}

// v[e] = g[e] for e < valid, 0 past it
template <typename T>
__device__ __forceinline__ void load8(float v[8], const T* g, int valid,
                                      bool vec) {
  if (vec && valid == 8) {
    load8_vec(v, g);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_f(g[e]) : 0.f;
}

__device__ __forceinline__ void store8_vec(float* g, const float v[8]) {
  reinterpret_cast<float4*>(g)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(g)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8_vec(bf16* g, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(g) = u;
}

template <typename T>
__device__ __forceinline__ void store8(T* g, const float v[8], int valid,
                                       bool vec) {
  if (vec && valid == 8) {
    store8_vec(g, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) g[e] = from_f<T>(v[e]);
}

// -------------------------------------------------- tile products (64 x 64)

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

// acc += A (sA, [kTM][kLdA]) x B over kBK. kKN: B held (k, n) in
// [kBK][kLdKN], else (n, k) in [kTN][kLdNK]. bf16: warp w owns rows
// 16w..16w+15, acc[j] is the mma accumulator of columns 8j..8j+7.
template <bool kKN>
__device__ __forceinline__ void tile_product(float acc[8][4], const bf16* sA,
                                             const bf16* sB, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sA + (warp * 16 + (lane & 15)) * kLdA + kk * 16 +
                   (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kTN / 16; ++np) {
      uint32_t b[4];
      if (kKN)
        ldsm_x4_t(b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              kLdKN + np * 16 + (lane >> 4) * 8);
      else
        ldsm_x4(b, sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLdNK +
                       kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// f32: thread (tx = tid % 16, ty = tid / 16) owns rows 8ty..8ty+7 and
// columns 4tx..4tx+3; acc[i][j] is (row 8ty+i, column 4tx+j)
template <bool kKN>
__device__ __forceinline__ void tile_product(float acc[8][4], const float* sA,
                                             const float* sB, int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sA[(ty * 8 + i) * kLdA + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = kKN ? sB[kk * kLdKN + tx * 4 + j]
                 : sB[(tx * 4 + j) * kLdNK + kk];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__device__ __forceinline__ void acc_to_smem(float* sO, const float acc[8][4],
                                            int tid) {
  if (std::is_same<T, bf16>::value) {
    const int warp = tid >> 5, lane = tid & 31;
    const int row = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      sO[row * kLdO + col] = acc[j][0];
      sO[row * kLdO + col + 1] = acc[j][1];
      sO[(row + 8) * kLdO + col] = acc[j][2];
      sO[(row + 8) * kLdO + col + 1] = acc[j][3];
    }
  } else {
    const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sO[(ty * 8 + i) * kLdO + tx * 4 + j] = acc[i][j];
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
  if (which == 1) return static_cast<long long>(row_blocks(M)) * 2 * C;
  const int rows = split_rows(M, C, K);
  return static_cast<long long>((M + rows - 1) / rows) * C * K;
}

// dtype: 0 = float32 (scalar FMA), 1 = bfloat16 (tensor cores). r, y, g
// may be null. Returns the cudaError_t of the launches (0 = launched).
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
