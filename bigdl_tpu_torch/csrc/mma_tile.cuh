// Tile helpers shared by the mma.sync kernels of fused_conv.cu and
// conv3x3.cu: a 64 x 64 output tile, 4 warps, reduction depth 32 per stage,
// operands staged in shared memory (padded by 8 elements against bank
// conflicts). bf16 tiles multiply on the tensor cores (ldmatrix fragments,
// mma.sync m16n8k16, f32 accumulate): warp w owns rows 16w..16w+15. f32
// tiles take scalar FMAs: thread (tid % 16, tid / 16) owns an 8 x 4
// sub-tile. Each kernel source is its own library, so the helpers are
// inline device functions (utils/cuda_build.py hashes this header with
// every source, so an edit here rebuilds both).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

constexpr int kTM = 64;             // output tile rows
constexpr int kTN = 64;             // output tile columns
constexpr int kBK = 32;             // reduction depth per stage
constexpr int kThreads = 128;       // 4 warps
constexpr int kLdA = kBK + 8;       // A tile [kTM][kLdA]
constexpr int kLdKN = kTN + 8;      // B tile held (k, n): [kBK][kLdKN]
constexpr int kLdNK = kBK + 8;      // B tile held (n, k): [kTN][kLdNK]
constexpr int kLdO = kTN + 4;       // f32 accumulator tile [kTM][kLdO]

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

