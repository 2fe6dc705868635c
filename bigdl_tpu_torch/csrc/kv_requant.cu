// The int8 KV cache's grow-only scale merge for Hopper (sm_90a), in place,
// plain C entry point.
//
// Replaces: the lax.cond of bigdl_tpu/models/transformer.py:653
// (_kv_quant_merge_step). That is no Pallas kernel: the JAX decode step
// skips the full-cache requantize on the device when no per-(row, head)
// scale grew, and requantizes every row otherwise. PyTorch has no
// device-side branch, so the port's step either read the "grew" flag back
// to the host (one sync per layer per step) or requantized unconditionally
// (the whole cache read and written every step). This kernel is the branch
// and the scale rule together: for every (cache, row, head) pair it reads
// the pair's old scale s_old and the new values' max |x| amax, computes
//     s_cand = amax * (1/127)
//     s_new  = s_cand > s_old ? s_cand * 1.25 : s_old
//     s_safe = s_new > 0 ? s_new : 1
//     ratio  = s_new > 0 ? s_old / s_safe : 1
// writes s_new and s_safe, returns when the ratio is exactly 1.0f, and
// otherwise rewrites the pair's L x D int8 values as
//     q' = (int8) rintf(q * ratio)            (f32, round half to even)
// Every step is one f32 operation rounded to nearest (__fmul_rn, __fdiv_rn:
// nvcc may not contract or approximate them), as PyTorch evaluates
// kv_scale_merge and kv_requant_reference elementwise, so the result is the
// plain version's bit for bit. A pair whose ratio is 1.0 requantizes to
// itself bitwise (the JAX docstring, :597-624), so skipping it per pair is
// exact. Inactive rows write amax 0: their scale does not grow and their
// ratio is 1.0.
//
// Bound on the H100 SXM: bytes. A step where no scale grew moves only the
// 2 * N * H scales and maxima in and 4 * N * H scales out (f32); a step
// where every pair grew also reads and writes both caches once: 2 caches x
// 2 x N * L * H * D bytes, 25.2 MB at the serving shape (N 16, L 512, H 12,
// D 64), 7.5 us at 3.35 TB/s. The one f32 multiply and rounding per byte are
// far below the f32 peak.
//
// Design: one block of 256 threads per (cache, row, head) pair, grid
// 2 * N * H (K pairs first, then V). Every thread evaluates the pair's scale
// rule from the same two loads (a broadcast), thread 0 stores the scales, and
// the ratio test is uniform over the block, so a pair that did not grow costs
// two 4-byte loads, two stores and an exit: the common no-growth step is one
// launch whose blocks all leave at once, with no host read and no cache
// traffic. A pair that grew walks its L positions; a position's D values are
// contiguous, so with D a multiple of 16 (and the caches 16-byte aligned,
// which the wrapper checks) each thread moves 16 bytes per load and store,
// neighbouring threads on neighbouring addresses within a position;
// otherwise one byte at a time. The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// f32(1/127), the multiplier kv_scale_merge spells as _INV_127
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kHeadroom = 1.25f;

__device__ __forceinline__ int8_t requant_one(int8_t q, float ratio) {
  return static_cast<int8_t>(
      static_cast<int>(rintf(__fmul_rn(static_cast<float>(q), ratio))));
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
kv_requant_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                  const float* __restrict__ ks_old,
                  const float* __restrict__ vs_old,
                  const float* __restrict__ k_amax,
                  const float* __restrict__ v_amax,
                  float* __restrict__ scales, int n, int L, int h, int d) {
  const int pairs = n * h;
  const bool is_v = static_cast<int>(blockIdx.x) >= pairs;
  const int rh = is_v ? blockIdx.x - pairs : blockIdx.x;
  const float s_old = (is_v ? vs_old : ks_old)[rh];
  const float s_cand = __fmul_rn((is_v ? v_amax : k_amax)[rh], kInv127);
  const float s_new = s_cand > s_old ? __fmul_rn(s_cand, kHeadroom) : s_old;
  const bool live = s_new > 0.0f;
  const float s_safe = live ? s_new : 1.0f;
  const float ratio = live ? __fdiv_rn(s_old, s_safe) : 1.0f;
  if (threadIdx.x == 0) {
    // scales: (4, n, h) = [ks, vs, ks_safe, vs_safe]
    const int c = is_v ? 1 : 0;
    scales[c * pairs + rh] = s_new;
    scales[(2 + c) * pairs + rh] = s_safe;
  }
  if (ratio == 1.0f) return;
  const int row = rh / h;
  const int head = rh - row * h;
  int8_t* base = (is_v ? vc : kc) + static_cast<size_t>(row) * L * h * d +
                 static_cast<size_t>(head) * d;
  const size_t stride = static_cast<size_t>(h) * d;  // one position
  const int per_pos = d / VEC;
  const int total = L * per_pos;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int l = i / per_pos;
    const int c = i - l * per_pos;
    int8_t* p = base + l * stride + c * VEC;
    if constexpr (VEC == 16) {
      int4 w = *reinterpret_cast<const int4*>(p);
      int8_t* b = reinterpret_cast<int8_t*>(&w);
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = requant_one(b[j], ratio);
      *reinterpret_cast<int4*>(p) = w;
    } else {
      *p = requant_one(*p, ratio);
    }
  }
}

}  // namespace

// kc, vc: (n, L, h, d) int8, contiguous, rewritten in place; ks_old,
// vs_old, k_amax, v_amax: (n, h) f32, contiguous; scales: (4, n, h) f32,
// contiguous, written as [ks, vs, ks_safe, vs_safe]. vec16: 1 when
// d % 16 == 0 and both caches are 16-byte aligned (the wrapper decides),
// else 0. Returns the launch's error (cudaErrorInvalidValue for a
// non-positive size).
extern "C" int bigdl_kv_requant(void* kc, void* vc, const void* ks_old,
                                const void* vs_old, const void* k_amax,
                                const void* v_amax, void* scales, int n,
                                int L, int h, int d, int vec16,
                                void* stream) {
  if (n <= 0 || L <= 0 || h <= 0 || d <= 0) return cudaErrorInvalidValue;
  if (vec16 && d % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(2u * static_cast<unsigned>(n) * static_cast<unsigned>(h));
  auto* k = static_cast<int8_t*>(kc);
  auto* v = static_cast<int8_t*>(vc);
  auto* ks = static_cast<const float*>(ks_old);
  auto* vs = static_cast<const float*>(vs_old);
  auto* ka = static_cast<const float*>(k_amax);
  auto* va = static_cast<const float*>(v_amax);
  auto* out = static_cast<float*>(scales);
  if (vec16)
    kv_requant_kernel<16><<<grid, kThreads, 0, s>>>(k, v, ks, vs, ka, va,
                                                    out, n, L, h, d);
  else
    kv_requant_kernel<1><<<grid, kThreads, 0, s>>>(k, v, ks, vs, ka, va, out,
                                                   n, L, h, d);
  return static_cast<int>(cudaGetLastError());
}
