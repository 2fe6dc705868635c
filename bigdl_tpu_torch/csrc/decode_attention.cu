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
// int8 all the way from memory. q arrives bf16 or f32: the int8 path widens
// it exactly, the float path first rounds it to the cache dtype. pos arrives
// int32 or int64 (the serving step's write index), read as it lies.
//
// Bound on the H100 SXM: bytes. The work reads sum_r (pos_r + 1) * H * D
// K and V elements (2 bytes per position-head-lane pair for int8) at
// 3.35 TB/s; the 4 f32 operations per such pair are ~100x below the f32 peak.
// At the serving shape (16 rows, 12 heads, D 64, cache 512) that is ~2 us:
// the kernel is bound by how many loads it keeps in flight, not by the rate.
//
// Design ("flash-decoding": the row's live columns split over S blocks,
// merged in the same launch):
//   * grid S * N * H blocks of 4 warps; the S blocks of one (row, head) form
//     a thread-block cluster (S <= 8, chosen by the Python wrapper from the
//     rows, the cache length and the SM count). Block s of the cluster takes
//     the s-th contiguous share, ceil((pos + 1) / S) columns, of 0..pos[n];
//     a share may be empty (pos + 1 < S);
//   * lanes load 16 bytes each: a column's D elements are spread over
//     D * sizeof(KT) / 16 adjacent lanes (a lane group), so one warp load
//     covers 32 / group-size columns, and each group loads kUnroll columns
//     (K and V) before it uses any, so every lane keeps 2 * kUnroll 16-byte
//     loads in flight;
//   * the score of a column is reduced over its lane group only, so every
//     lane of the group holds the column's probability: p.v needs no shuffle
//     per column. Each lane group keeps its own online-softmax state (max,
//     sum, and its lanes' slice of the accumulator);
//   * a warp merges its lane groups by a shuffle butterfly, the block its
//     warps through shared memory in warp order; after a cluster barrier,
//     block 0 of the cluster reads the S block states through distributed
//     shared memory and merges them in split order; a second cluster barrier keeps every block's shared memory
//     alive until then. No scratch, no counters, no atomics: the merge order
//     is fixed, so the result repeats bitwise. A state that saw no column
//     (max -inf) adds nothing to a merge;
//   * positions past pos[n] are never read, so a cache length L that is not a
//     tile multiple needs no padding (the TPU wrapper pads, i.e. copies K/V).
// The kernel allocates nothing and launches on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;     // columns each lane group loads per step
constexpr int kMaxSplits = 8;  // a portable cluster holds at most 8 blocks

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

// q as the q.k contraction consumes it: rounded to the cache dtype on the
// float path (exact for f32, and for int8 the widened value itself)
template <typename T> __device__ __forceinline__ float q_for_k(float q) {
  return q;
}
template <> __device__ __forceinline__ float q_for_k<__nv_bfloat16>(float q) {
  return __bfloat162float(__float2bfloat16(q));
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

// how the lanes of a warp cover the columns for K/V elements of type KT
template <typename KT, int D>
struct Lanes {
  static constexpr int kPer = 16 / sizeof(KT);  // elements per 16-byte load
  static constexpr int kGroup = D / kPer;       // lanes per column
  static constexpr int kCols = 32 / kGroup;     // columns per warp load
  static_assert(D % kPer == 0 && kGroup <= 32 && 32 % kGroup == 0,
                "a column must fill whole 16-byte loads of a lane group");
};

template <typename KT, int N>
union Chunk {
  uint4 raw;
  KT e[N];
};

template <typename KT, typename OT, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const void* __restrict__ q, int q_bf16,
                       const KT* __restrict__ k,           // (N, L, H, D)
                       const KT* __restrict__ v,           // (N, L, H, D)
                       const void* __restrict__ pos, int pos_i64,  // (N,)
                       const float* __restrict__ k_scale,  // (N, H) or null
                       const float* __restrict__ v_scale,  // (N, H) or null
                       OT* __restrict__ out,               // (N, H, D)
                       int L, int H, int S, float scale) {
  using G = Lanes<KT, D>;
  constexpr int P = G::kPer, kGroup = G::kGroup, kCols = G::kCols;
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][D];
  __shared__ float blk_m, blk_l;  // the block's merged state
  __shared__ float blk_acc[D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int nh = blockIdx.x / S;  // n * H + h
  const int n = nh / H, h = nh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = lane % kGroup;  // this lane's slice of D: P elements
  const int slot = lane / kGroup;   // its column within a warp load

  const long long p_n = pos_i64 ? static_cast<const long long*>(pos)[n]
                                : static_cast<const int*>(pos)[n];
  float qr[P];
#pragma unroll
  for (int e = 0; e < P; ++e) {
    const size_t at = static_cast<size_t>(nh) * D + chunk * P + e;
    const float qv =
        q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
               : static_cast<const float*>(q)[at];
    qr[e] = q_for_k<KT>(qv);
  }
  const int live = static_cast<int>(min(p_n, static_cast<long long>(L) - 1)) + 1;
  const int share = live > 0 ? (live + S - 1) / S : 0;
  const int c_begin = split * share;
  const int c_end = min(c_begin + share, live);
  // score scaling: (scale * k_scale) first, as the TPU kernel multiplies
  const float sc = k_scale != nullptr ? scale * k_scale[nh] : scale;
  const size_t stride = static_cast<size_t>(H) * D;  // between key positions
  const size_t base = static_cast<size_t>(n) * L * stride +
                      static_cast<size_t>(h) * D + chunk * P;
  const uint4* kb = reinterpret_cast<const uint4*>(k + base);
  const uint4* vb = reinterpret_cast<const uint4*>(v + base);
  const size_t stride4 = stride * sizeof(KT) / 16;  // in 16-byte units

  float m = -INFINITY, l = 0.f, acc[P];
#pragma unroll
  for (int e = 0; e < P; ++e) acc[e] = 0.f;

  constexpr int kPerIter = kWarps * kCols * kUnroll;
  for (int c0 = c_begin + warp * kCols * kUnroll; c0 < c_end;
       c0 += kPerIter) {  // warp-uniform bounds
    Chunk<KT, P> kr[kUnroll], vr[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kCols + slot;
      valid[u] = c < c_end;
      kr[u].raw = valid[u] ? __ldg(kb + c * stride4) : make_uint4(0, 0, 0, 0);
      vr[u].raw = valid[u] ? __ldg(vb + c * stride4) : make_uint4(0, 0, 0, 0);
    }
    float s[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < P; ++e) dot = fmaf(qr[e], to_f32<KT>(kr[u].e[e]), dot);
#pragma unroll
      for (int o = 1; o < kGroup; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = valid[u] ? dot * sc : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    if (mx == -INFINITY) continue;  // this lane group saw no column yet
    const float alpha = expf(m - mx);  // 0 on the group's first column
    l *= alpha;
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float pr = valid[u] ? expf(s[u] - mx) : 0.f;
      l += pr;
      const float pv = p_for_v<KT>(pr);
#pragma unroll
      for (int e = 0; e < P; ++e)
        acc[e] = fmaf(pv, to_f32<KT>(vr[u].e[e]), acc[e]);
    }
    m = mx;
  }

  // the warp's lane groups merge by a butterfly over the group bits, then
  // the block's warps merge in warp order
#pragma unroll
  for (int o = kGroup; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(m, mo);
    const float fs = m == -INFINITY ? 0.f : expf(m - mx);
    const float fo = mo == -INFINITY ? 0.f : expf(mo - mx);
    l = l * fs + lo * fo;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * fs + ao * fo;
    }
    m = mx;
  }
  if (slot == 0) {
#pragma unroll
    for (int e = 0; e < P; ++e) acc_s[warp][chunk * P + e] = acc[e];
    if (chunk == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (m_s[w] == -INFINITY) continue;  // the warp saw no column
      const float f = expf(m_s[w] - mx);
      num = fmaf(f, acc_s[w][d], num);
      den = fmaf(f, l_s[w], den);
    }
    blk_acc[d] = num;
    if (d == 0) {
      blk_m = mx;
      blk_l = den;
    }
  }

  // the cluster's blocks merge in split order, in block 0
  cluster.sync();
  if (split == 0 && threadIdx.x < D) {
    const int d = threadIdx.x;
    float mx = -INFINITY;
    for (int r = 0; r < S; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&blk_m, r));
    float num = 0.f, den = 0.f;
    for (int r = 0; r < S; ++r) {
      const float mr = *cluster.map_shared_rank(&blk_m, r);
      if (mr == -INFINITY) continue;  // an empty split
      const float f = expf(mr - mx);
      num = fmaf(f, *cluster.map_shared_rank(&blk_acc[d], r), num);
      den = fmaf(f, *cluster.map_shared_rank(&blk_l, r), den);
    }
    float o = num / fmaxf(den, 1e-30f);
    if (v_scale != nullptr) o *= v_scale[nh];
    store<OT>(out + static_cast<size_t>(nh) * D + d, o);
  }
  cluster.sync();  // block 0 has read every block's shared memory
}

struct Args {
  const void* q;
  int q_bf16;
  const void* k;
  const void* v;
  const void* pos;
  int pos_i64;
  const float* k_scale;
  const float* v_scale;
  void* out;
  int n, L, h, splits;
  float scale;
};

template <typename KT, typename OT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.splits) * a.n * a.h;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attention_split<KT, OT, D>, a.q, a.q_bf16,
      static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), a.pos,
      a.pos_i64, a.k_scale, a.v_scale, static_cast<OT*>(a.out), a.L, a.h,
      a.splits, a.scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename KT, typename OT>
cudaError_t by_dim(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<KT, OT, 32>(a, stream);
    case 64: return launch<KT, OT, 64>(a, stream);
    case 128: return launch<KT, OT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KT>
cudaError_t by_out(int out_dtype, int d, const Args& a, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return by_dim<KT, float>(d, a, stream);
    case 1: return by_dim<KT, __nv_bfloat16>(d, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 f32, 1 bf16. pos_dtype: 0 int32, 1 int64. kv_dtype: 0 int8
// (k_scale/v_scale required), 1 bf16, 2 f32. out_dtype: 0 f32, 1 bf16.
// splits: blocks per (row, head), 1..8 (one thread-block cluster). Returns
// the launch's error (cudaErrorInvalidValue for an unsupported dtype, head
// dim or split count; the Python wrapper rejects those before calling).
extern "C" int bigdl_decode_attention(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      const void* k_scale,
                                      const void* v_scale, void* out, int n,
                                      int L, int h, int d, int q_dtype,
                                      int pos_dtype, int kv_dtype,
                                      int out_dtype, int splits, float scale,
                                      void* stream) {
  if (splits < 1 || splits > kMaxSplits || q_dtype < 0 || q_dtype > 1 ||
      pos_dtype < 0 || pos_dtype > 1 || n <= 0 || L <= 0 || h <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, q_dtype, k, v, pos, pos_dtype,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         out, n, L, h, splits, scale};
  switch (kv_dtype) {
    case 0:
      if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
      return by_out<int8_t>(out_dtype, d, a, s);
    case 1:
      a.k_scale = a.v_scale = nullptr;
      return by_out<__nv_bfloat16>(out_dtype, d, a, s);
    case 2:
      a.k_scale = a.v_scale = nullptr;
      return by_out<float>(out_dtype, d, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
