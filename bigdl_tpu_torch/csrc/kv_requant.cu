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
// Design: one block of 256 threads per work item, a (cache, row) and a
// chunk of its positions: grid (chunks, 2 N) (K rows first, then V), the
// chunk from the Python wrapper's chunk_plan. A chunk's positions hold
// every head, so its bytes are one contiguous range of the cache (at most
// 64 KB) and a step where every pair grew streams each cache in order.
// Every block evaluates its row's scale rule per head from the same loads
// into a shared table of ratios; the row's first chunk writes the scales.
// A block whose heads all keep ratio 1.0 exits (the common no-growth step:
// two 4-byte loads per head and block, no cache traffic, no host read),
// and within a block a head that did not grow costs no cache byte either.
// Each thread issues all of a round's loads (up to eight 16-byte vectors)
// before its first store, so a round costs one trip to memory; at most 64
// registers a thread keep four blocks on an SM. A position's D values are
// contiguous, so with D a multiple of 16 (and the caches 16-byte aligned,
// which the wrapper checks) each load and store moves 16 bytes of one
// head, neighbouring threads on neighbouring addresses, and four codes are
// requantized by full-rate f32 adds and multiplies (requant4) rather than
// int-float conversions, which an SM runs at a quarter of the rate;
// otherwise one byte at a time. The kernel allocates nothing and launches
// on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 8;     // 16-byte vectors one thread of a chunk moves
// f32(1/127), the multiplier kv_scale_merge spells as _INV_127
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kHeadroom = 1.25f;

__device__ __forceinline__ int8_t requant_one(int8_t q, float ratio) {
  return static_cast<int8_t>(
      static_cast<int>(rintf(__fmul_rn(static_cast<float>(q), ratio))));
}

// requant_one of the four codes of w (byte i = code i), in full-rate f32
// instructions: the code is 2^23 + (code + 128) - (2^23 + 128), exact; its
// product with ratio is rounded once (__fmul_rn); adding 1.5 * 2^23 rounds
// that to the nearest integer, ties to even (|product| <= 128, so the
// sum's unit is 1), as rintf does, and leaves it as the low byte of the
// sum's bits in two's complement
__device__ __forceinline__ uint32_t requant4(uint32_t w, float ratio) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q = __fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)),
        8388736.0f);
    r[j] = __float_as_uint(__fadd_rn(__fmul_rn(q, ratio), 12582912.0f));
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                     __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

// chunk: positions per work item (blockIdx.x: which); blockIdx.y: cache *
// n + row. Dynamic shared memory: h floats (the row's ratios).
template <int VEC>
__global__ void __launch_bounds__(kThreads, 4)
kv_requant_kernel(int8_t* __restrict__ kc, int8_t* __restrict__ vc,
                  const float* __restrict__ ks_old,
                  const float* __restrict__ vs_old,
                  const float* __restrict__ k_amax,
                  const float* __restrict__ v_amax,
                  float* __restrict__ scales, int n, int L, int h, int d,
                  int chunk) {
  extern __shared__ float s_ratio[];
  const int pairs = n * h;
  const int rc = blockIdx.y;                   // cache * n + row
  const int part = blockIdx.x;
  const bool is_v = rc >= n;
  const int row = is_v ? rc - n : rc;
  const int c = is_v ? 1 : 0;
  int grew = 0;
  for (int hd = threadIdx.x; hd < h; hd += kThreads) {
    const int rh = row * h + hd;
    const float s_old = (is_v ? vs_old : ks_old)[rh];
    const float s_cand = __fmul_rn((is_v ? v_amax : k_amax)[rh], kInv127);
    const float s_new =
        s_cand > s_old ? __fmul_rn(s_cand, kHeadroom) : s_old;
    const bool live = s_new > 0.0f;
    const float s_safe = live ? s_new : 1.0f;
    const float ratio = live ? __fdiv_rn(s_old, s_safe) : 1.0f;
    if (part == 0) {
      // scales: (4, n, h) = [ks, vs, ks_safe, vs_safe]
      scales[c * pairs + rh] = s_new;
      scales[(2 + c) * pairs + rh] = s_safe;
    }
    s_ratio[hd] = ratio;
    grew |= ratio != 1.0f;
  }
  if (!__syncthreads_or(grew)) return;
  const int l0 = part * chunk;
  const int rows = min(L - l0, chunk);
  int8_t* base = (is_v ? vc : kc) + (static_cast<size_t>(row) * L + l0) * h * d;
  if constexpr (VEC == 16) {
    const int per_head = d / 16;          // vectors of one (position, head)
    const int total = rows * h * per_head;
    for (int i0 = 0; i0 < total; i0 += kVecs * kThreads) {
      uint4 w[kVecs];
      float ratio[kVecs];
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {   // the round's loads first
        const int i = i0 + threadIdx.x + u * kThreads;
        ratio[u] = i < total ? s_ratio[(i / per_head) % h] : 1.0f;
        if (ratio[u] != 1.0f)
          w[u] = *reinterpret_cast<const uint4*>(base + 16 * static_cast<size_t>(i));
      }
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const int i = i0 + threadIdx.x + u * kThreads;
        if (ratio[u] != 1.0f)
          *reinterpret_cast<uint4*>(base + 16 * static_cast<size_t>(i)) =
              make_uint4(requant4(w[u].x, ratio[u]), requant4(w[u].y, ratio[u]),
                         requant4(w[u].z, ratio[u]), requant4(w[u].w, ratio[u]));
      }
    }
  } else {
    const int total = rows * h * d;
    for (int i0 = 0; i0 < total; i0 += 16 * kThreads) {
      int8_t q[16];
      float ratio[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + threadIdx.x + u * kThreads;
        ratio[u] = i < total ? s_ratio[(i / d) % h] : 1.0f;
        if (ratio[u] != 1.0f) q[u] = base[i];
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + threadIdx.x + u * kThreads;
        if (ratio[u] != 1.0f) base[i] = requant_one(q[u], ratio[u]);
      }
    }
  }
}

}  // namespace

// kc, vc: (n, L, h, d) int8, contiguous, rewritten in place; ks_old,
// vs_old, k_amax, v_amax: (n, h) f32, contiguous; scales: (4, n, h) f32,
// contiguous, written as [ks, vs, ks_safe, vs_safe]. vec16: 1 when
// d % 16 == 0 and both caches are 16-byte aligned (the wrapper decides),
// else 0. chunk: positions per block, chunks: blocks per (cache, row),
// with chunk * chunks >= L (the wrapper's chunk_plan). Returns the launch's
// error (cudaErrorInvalidValue for a size or plan it does not take).
extern "C" int bigdl_kv_requant(void* kc, void* vc, const void* ks_old,
                                const void* vs_old, const void* k_amax,
                                const void* v_amax, void* scales, int n,
                                int L, int h, int d, int vec16, int chunk,
                                int chunks, void* stream) {
  if (n <= 0 || L <= 0 || h <= 0 || d <= 0 || chunk <= 0 || chunks <= 0)
    return cudaErrorInvalidValue;
  if ((vec16 && d % 16 != 0) || static_cast<long long>(chunk) * chunks < L ||
      static_cast<long long>(chunk) * h * d >= (1ll << 31) ||
      h > 12 * 1024)
    return cudaErrorInvalidValue;
  if (2ll * n >= 65536) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), 2u * static_cast<unsigned>(n));
  auto* k = static_cast<int8_t*>(kc);
  auto* v = static_cast<int8_t*>(vc);
  auto* ks = static_cast<const float*>(ks_old);
  auto* vs = static_cast<const float*>(vs_old);
  auto* ka = static_cast<const float*>(k_amax);
  auto* va = static_cast<const float*>(v_amax);
  auto* out = static_cast<float*>(scales);
  if (vec16)
    kv_requant_kernel<16><<<grid, kThreads, h * sizeof(float), s>>>(
        k, v, ks, vs, ka, va, out, n, L, h, d, chunk);
  else
    kv_requant_kernel<1><<<grid, kThreads, h * sizeof(float), s>>>(
        k, v, ks, vs, ka, va, out, n, L, h, d, chunk);
  return static_cast<int>(cudaGetLastError());
}
