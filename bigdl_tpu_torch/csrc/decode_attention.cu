// Pooled decode attention for Hopper (sm_90a), plain C entry point.
//
// Replaces: bigdl_tpu/ops/decode_attention.py::_decode_kernel, the Pallas
// TPU kernel behind pooled_decode_attention. Same function: for every pooled
// row n and head h, one query attends over the row's own cache columns
// 0..pos[n] inclusive,
//     s[l]   = (q . k[n, l, h]) * scale            (* k_scale[n, h] for int8)
//     out    = softmax(s) . v[n, :, h]             (* v_scale[n, h] for int8)
// with scores, the running max and sum, and p.v accumulated in f32. For int8
// K/V the per-(row, head) scales are constant over both contractions, so they
// factor out exactly (the JAX module's docstring, lines 23-24): K/V bytes stay
// int8 all the way from memory.
//
// Bound on the H100 SXM: bytes. The work reads sum_r (pos_r + 1) * H * D
// K and V elements (2 bytes per position-head-lane pair for int8) at
// 3.35 TB/s; the 4 f32 operations per such pair are ~100x below the f32 peak.
//
// Design (simple and right first; split-K over L for small N and cp.async/TMA
// staging are later work):
//   * grid (N, H): one block per (row, head), 4 warps; nothing carries between
//     blocks, the TPU grid's sequential L axis becomes a loop inside the block;
//   * q is staged once in shared memory as f32;
//   * the loop walks key positions 0..pos[n] only, in tiles of 128: each lane
//     scores one position (16-byte loads of its K row), each warp keeps its own
//     online softmax state (max, sum, and D/32 accumulator columns per lane),
//     and the warp's 32 probabilities are broadcast by shuffle for p.v, where
//     lanes own adjacent output columns so V reads are coalesced;
//   * positions past pos[n] are never read, so a cache length L that is not a
//     tile multiple needs no padding (the TPU wrapper pads, i.e. copies K/V);
//   * the four warps' states merge through shared memory at the end.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kThreads;  // key positions per block tile

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

// The probability as the p.v contraction consumes it: the TPU kernel casts p
// to V's dtype before that dot (exact for f32 and int8, bf16-rounded for bf16).
template <typename T> __device__ __forceinline__ float p_for_v(float p) {
  return p;
}
template <> __device__ __forceinline__ float p_for_v<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T> __device__ __forceinline__ void store(T* dst, float x);
template <> __device__ __forceinline__ void store<float>(float* dst, float x) {
  *dst = x;
}
template <> __device__ __forceinline__ void store<__nv_bfloat16>(
    __nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q . k for one K row of D elements, read with 16-byte loads.
template <typename KT, int D>
__device__ __forceinline__ float row_dot(const KT* __restrict__ k,
                                         const float* __restrict__ q) {
  constexpr int kPer = 16 / sizeof(KT);  // elements per 16-byte load
  static_assert(D % kPer == 0, "D must fill whole 16-byte loads");
  union Chunk {
    uint4 raw;
    KT e[kPer];
  };
  const uint4* k4 = reinterpret_cast<const uint4*>(k);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / kPer; ++c) {
    Chunk chunk;
    chunk.raw = __ldg(k4 + c);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      acc = fmaf(q[c * kPer + j], to_f32<KT>(chunk.e[j]), acc);
  }
  return acc;
}

template <typename KT, typename OT, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,        // (N, H, D) f32
                        const KT* __restrict__ k,           // (N, L, H, D)
                        const KT* __restrict__ v,           // (N, L, H, D)
                        const int* __restrict__ pos,        // (N,)
                        const float* __restrict__ k_scale,  // (N, H) or null
                        const float* __restrict__ v_scale,  // (N, H) or null
                        OT* __restrict__ out,               // (N, H, D)
                        int L, int H, float scale) {
  constexpr int kPerLane = D / 32;  // output columns one lane owns
  const int n = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ float q_s[D];
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  const size_t nh = static_cast<size_t>(n) * H + h;
  for (int d = threadIdx.x; d < D; d += kThreads) q_s[d] = q[nh * D + d];
  __syncthreads();

  // score scaling: (scale * k_scale) first, as the TPU kernel multiplies
  const float sc = k_scale != nullptr ? scale * k_scale[nh] : scale;
  const int last = min(pos[n], L - 1);  // last key column this row attends
  const size_t stride = static_cast<size_t>(H) * D;  // between key positions
  const KT* kb = k + static_cast<size_t>(n) * L * stride + h * D;
  const KT* vb = v + static_cast<size_t>(n) * L * stride + h * D;

  float m = -INFINITY, l = 0.f, acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 <= last; t0 += kTile) {
    const int base = t0 + warp * 32;  // this warp's first key position
    if (base > last) break;           // warp-uniform; later tiles lie beyond
    const int col = base + lane;
    const bool valid = col <= last;
    const float s = valid ? row_dot<KT, D>(kb + col * stride, q_s) * sc
                          : -INFINITY;
    // lane 0's column is valid, so m_new is finite
    const float m_new = fmaxf(m, warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);  // 0 on the warp's first tile
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
    const int n_valid = min(32, last - base + 1);
    const KT* vr = vb + base * stride + lane * kPerLane;
    for (int j = 0; j < n_valid; ++j, vr += stride) {
      const float pj = p_for_v<KT>(__shfl_sync(0xffffffffu, p, j));
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        acc[i] = fmaf(pj, to_f32<KT>(vr[i]), acc[i]);
    }
    m = m_new;
  }

  // merge the warps' online-softmax states
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc_s[warp][lane * kPerLane + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (m_s[w] == -INFINITY) continue;  // warp saw no valid column
      const float f = expf(m_s[w] - mx);
      num = fmaf(f, acc_s[w][d], num);
      den = fmaf(f, l_s[w], den);
    }
    float o = num / fmaxf(den, 1e-30f);
    if (v_scale != nullptr) o *= v_scale[nh];
    store<OT>(out + nh * D + d, o);
  }
}

template <typename KT, typename OT, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, const void* k_scale, const void* v_scale,
                   void* out, int n, int L, int h, float scale,
                   cudaStream_t stream) {
  decode_attention_kernel<KT, OT, D><<<dim3(n, h), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(pos),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<OT*>(out), L, h, scale);
  return cudaGetLastError();
}

template <typename KT, typename OT>
cudaError_t by_dim(int d, const void* q, const void* k, const void* v,
                   const void* pos, const void* ks, const void* vs, void* out,
                   int n, int L, int h, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<KT, OT, 32>(q, k, v, pos, ks, vs, out, n, L, h, scale, stream);
    case 64: return launch<KT, OT, 64>(q, k, v, pos, ks, vs, out, n, L, h, scale, stream);
    case 128: return launch<KT, OT, 128>(q, k, v, pos, ks, vs, out, n, L, h, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT>
cudaError_t by_out(int out_dtype, int d, const void* q, const void* k,
                   const void* v, const void* pos, const void* ks,
                   const void* vs, void* out, int n, int L, int h,
                   float scale, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return by_dim<KT, float>(d, q, k, v, pos, ks, vs, out, n, L, h, scale, stream);
    case 1: return by_dim<KT, __nv_bfloat16>(d, q, k, v, pos, ks, vs, out, n, L, h, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kv_dtype: 0 int8 (k_scale/v_scale required), 1 bf16, 2 f32.
// out_dtype: 0 f32, 1 bf16. q is f32 (the wrapper widens it). Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// dtype or head dim; the Python wrapper rejects those before calling).
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* k_scale,
                                      const void* v_scale, void* out, int n,
                                      int L, int h, int d, int kv_dtype,
                                      int out_dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
      return by_out<int8_t>(out_dtype, d, q, k, v, pos, k_scale, v_scale, out, n, L, h, scale, s);
    case 1:
      return by_out<__nv_bfloat16>(out_dtype, d, q, k, v, pos, nullptr, nullptr, out, n, L, h, scale, s);
    case 2:
      return by_out<float>(out_dtype, d, q, k, v, pos, nullptr, nullptr, out, n, L, h, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
