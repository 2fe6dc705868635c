// Weight-only int8 projection (W8A16) for Hopper (sm_90a), plain C entry
// point:
//     acc[m, n] = w_scale[n] * sum_k bf16(x[m, k]) * bf16(weight_q[n, k])
// with x (M, K) f32 or bf16, weight_q (N, K) int8 and w_scale (N,) f32, the
// sum accumulated in f32, then the caller's epilogue: out (M, N) is acc in
// f32, plus an optional f32 bias (QuantizedLinear), or acc rounded to bf16
// and then, optionally, a bf16 bias added and rounded again (the bf16
// serving projection: `(acc).astype(x.dtype) + bias.astype(x.dtype)`).
// Every step is one rounded operation (__fmul_rn, __fadd_rn: no
// contraction), as PyTorch evaluates the plain version.
//
// Replaces: no Pallas kernel. It is the weight_q branch of the JAX serving
// projection (bigdl_tpu/models/transformer.py:674-681, _serving_proj) and the
// weight_only branch of QuantizedLinear (bigdl_tpu/nn/quantized.py:83-92):
// a dot_general of bf16(x) and bf16(weight_q) with
// preferred_element_type=f32, which XLA fuses so that the weights are read
// as int8 ("HBM reads stay int8", quantized.py:43-48). No single PyTorch
// call computes it: F.linear(x_bf16, weight_q.to(bf16)) writes and reads a
// bf16 copy of every weight (5 bytes per weight against int8's 1) and rounds
// the product to bf16. Here the int8 tile is converted to bf16 on its way
// into shared memory, and the tensor cores accumulate in f32. A product of
// two bf16 values is exact in f32, so the kernel differs from the plain
// version only by the order of the f32 sums.
//
// Bound on the H100 SXM: at decode (M of 1-16 rows) bytes: the N * K int8
// weights, read once (2.36 MB for the 137m LM's fc1 or fc2, 25.2 MB for its
// head: 0.70 / 7.5 us at 3.35 TB/s); at prefill (M in the thousands)
// operations: 2 * M * N * K at the bf16 tensor-core peak (989 TFLOP/s).
//
// Design: a block of 128 threads (4 warps) owns a BM x 64 output tile and
// walks K in stages of 64: every thread loads its share of the next stage's
// x and int8 weight tile into registers while the warps multiply the current
// stage from shared memory (ldmatrix, mma.sync m16n8k16 bf16, f32
// accumulate). BM is 16 when M <= 16 (the 4 warps side by side along N,
// each 16 columns) and 64 otherwise (each warp 16 rows, 64 columns). Rows
// past M, columns past N and depths past K are zeros in shared memory, so
// no dimension needs to be a multiple of a tile. Decode's few tiles cannot
// fill 132 SMs, so the wrapper splits K over gridDim.z: every split writes
// its f32 partial tile to a workspace, and the last split of a tile to
// arrive (a counter per tile, reset by that block) sums the partials in
// split order, so the result does not depend on which block finished last.
// The kernel allocates nothing and launches on the caller's stream.

#include "mma_tile.cuh"

namespace {

constexpr int kCols = 64;               // output columns per block
constexpr int kDepth = 64;              // K per stage
constexpr int kLd = kDepth + 8;         // shared tile row, bf16 elements
constexpr int kWThreads = 128;          // 4 warps

// 16 int8 weights -> 16 bf16 (exact) at dst, 16-byte aligned
__device__ __forceinline__ void store16_i8_as_bf16(bf16* dst, int4 w) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
  uint4 lo, hi;
  __nv_bfloat162* l = reinterpret_cast<__nv_bfloat162*>(&lo);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = __floats2bfloat162_rn(static_cast<float>(b[2 * i]),
                                 static_cast<float>(b[2 * i + 1]));
    h[i] = __floats2bfloat162_rn(static_cast<float>(b[8 + 2 * i]),
                                 static_cast<float>(b[8 + 2 * i + 1]));
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// the epilogue of one output: acc * scale, then the out dtype and bias
__device__ __forceinline__ void store_out(float* out, size_t at, float acc,
                                          float scale, const void* bias,
                                          int n) {
  float v = __fmul_rn(acc, scale);
  if (bias) v = __fadd_rn(v, static_cast<const float*>(bias)[n]);
  out[at] = v;
}

__device__ __forceinline__ void store_out(bf16* out, size_t at, float acc,
                                          float scale, const void* bias,
                                          int n) {
  bf16 v = __float2bfloat16_rn(__fmul_rn(acc, scale));
  if (bias)
    v = __float2bfloat16_rn(__fadd_rn(
        __bfloat162float(v),
        __bfloat162float(static_cast<const bf16*>(bias)[n])));
  out[at] = v;
}

// 8 f32 values -> 8 bf16 (round to nearest even) at dst, 16-byte aligned
__device__ __forceinline__ void store8_as_bf16(bf16* dst, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// WM: warps along M (4: BM 64; 1: BM 16). T: x's type (float or bf16);
// O: out's and bias's type (float or bf16); bias may be null.
template <typename T, typename O, int WM>
__global__ void __launch_bounds__(kWThreads)
w8a16_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ scale, const void* __restrict__ bias,
             O* __restrict__ out, float* __restrict__ ws,
             int* __restrict__ counters, int M, int N, int K, int k_split,
             bool vec) {
  constexpr int BM = 16 * WM;
  constexpr int WN = 4 / WM;             // warps along N
  constexpr int CW = kCols / WN;         // columns per warp
  constexpr int NT = CW / 8;             // n8 accumulators per warp
  constexpr int A_CHUNKS = BM * kDepth / 8 / kWThreads;   // 8 values each
  constexpr int B_CHUNKS = kCols * kDepth / 16 / kWThreads;  // 16 bytes each
  __shared__ __align__(16) bf16 sA[BM * kLd];
  __shared__ __align__(16) bf16 sB[kCols * kLd];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  float a_reg[A_CHUNKS][8];
  int4 b_reg[B_CHUNKS];

  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kWThreads;
      const int row = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
      const int m = m0 + row, k = k0 + col;
      const int valid = m < M ? max(0, min(8, k_end - k)) : 0;
      if (valid > 0)
        load8(a_reg[i], x + static_cast<size_t>(m) * K + k, valid, vec);
      else
        zero8(a_reg[i]);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kWThreads;
      const int row = c / (kDepth / 16), col = (c % (kDepth / 16)) * 16;
      const int n = n0 + row, k = k0 + col;
      const int valid = n < N ? max(0, min(16, k_end - k)) : 0;
      const int8_t* g = wq + static_cast<size_t>(n) * K + k;
      if (vec && valid == 16) {
        b_reg[i] = *reinterpret_cast<const int4*>(g);
      } else {
        int8_t* b = reinterpret_cast<int8_t*>(&b_reg[i]);
#pragma unroll
        for (int e = 0; e < 16; ++e) b[e] = e < valid ? g[e] : 0;
      }
    }
  };

  auto store_stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * kWThreads;
      const int row = c / (kDepth / 8), col = (c % (kDepth / 8)) * 8;
      store8_as_bf16(sA + row * kLd + col, a_reg[i]);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * kWThreads;
      const int row = c / (kDepth / 16), col = (c % (kDepth / 16)) * 16;
      store16_i8_as_bf16(sB + row * kLd + col, b_reg[i]);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (k_begin < k_end) load_stage(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kDepth) {
    store_stage();
    __syncthreads();
    if (k0 + kDepth < k_end) load_stage(k0 + kDepth);  // in flight below
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sA + (wm * 16 + (lane & 15)) * kLd + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sB + (wn * CW + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                           kLd + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // accumulator e of n8 tile j: row (lane >> 2) + 8 * (e >> 1), column
  // 8 j + 2 (lane & 3) + (e & 1) of the warp's 16 x CW sub-tile
  const int row0 = m0 + wm * 16 + (lane >> 2);
  const int col0 = n0 + wn * CW + 2 * (lane & 3);
  if (gridDim.z == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = row0 + 8 * (e >> 1), n = col0 + j * 8 + (e & 1);
        if (m < M && n < N)
          store_out(out, static_cast<size_t>(m) * N + n, acc[j][e], scale[n],
                    bias, n);
      }
    return;
  }
  const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * (e >> 1), n = col0 + j * 8 + (e & 1);
      if (m < M && n < N)
        ws[blockIdx.z * plane + static_cast<size_t>(m) * N + n] = acc[j][e];
    }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0)
    s_last = atomicAdd(&counters[tile], 1) == static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * (e >> 1), n = col0 + j * 8 + (e & 1);
      if (m < M && n < N) {
        const size_t at = static_cast<size_t>(m) * N + n;
        float s = 0.f;
        for (unsigned z = 0; z < gridDim.z; ++z)
          s += __ldcg(ws + z * plane + at);
        store_out(out, at, s, scale[n], bias, n);
      }
    }
  if (tid == 0) counters[tile] = 0;   // ready for the next launch
}

template <typename T, typename O>
int launch(const void* x, const void* wq, const void* scale, const void* bias,
           void* out, void* ws, void* counters, int M, int N, int K,
           int splits, int k_split, int vec, cudaStream_t s) {
  const bool small = M <= 16;
  const int bm = small ? 16 : 64;
  const dim3 grid((N + kCols - 1) / kCols, (M + bm - 1) / bm, splits);
  auto* xp = static_cast<const T*>(x);
  auto* wp = static_cast<const int8_t*>(wq);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<O*>(out);
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  if (small)
    w8a16_kernel<T, O, 1><<<grid, kWThreads, 0, s>>>(
        xp, wp, sp, bias, op, wsp, cp, M, N, K, k_split, vec != 0);
  else
    w8a16_kernel<T, O, 4><<<grid, kWThreads, 0, s>>>(
        xp, wp, sp, bias, op, wsp, cp, M, N, K, k_split, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) contiguous, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); wq: (N, K)
// int8, contiguous; scale: (N,) f32; out: (M, N), contiguous, f32
// (out_bf16 = 0) or bf16 (out_bf16 = 1); bias: null or (N,) of out's type.
// splits:
// the K splits (gridDim.z); k_split: the K of one split, a multiple of 64
// with splits * k_split >= K > (splits - 1) * k_split. With splits > 1, ws
// holds splits * M * N f32 and counters one zeroed int per (M, N) tile,
// which the kernel leaves zeroed. vec: 1 when K % 16 == 0 and x and wq are
// 16-byte aligned (the wrapper decides), else 0. Returns the launch's error
// (cudaErrorInvalidValue for a size or split it does not take).
extern "C" int bigdl_w8a16(const void* x, const void* wq, const void* scale,
                           const void* bias, void* out, void* ws,
                           void* counters, int M, int N, int K, int splits,
                           int k_split, int x_bf16, int out_bf16, int vec,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || k_split <= 0 ||
      k_split % kDepth != 0 ||
      static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (vec && K % 16 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    return launch<bf16, bf16>(x, wq, scale, bias, out, ws, counters, M, N, K,
                              splits, k_split, vec, s);
  if (x_bf16)
    return launch<bf16, float>(x, wq, scale, bias, out, ws, counters, M, N,
                               K, splits, k_split, vec, s);
  if (out_bf16)
    return launch<float, bf16>(x, wq, scale, bias, out, ws, counters, M, N,
                               K, splits, k_split, vec, s);
  return launch<float, float>(x, wq, scale, bias, out, ws, counters, M, N, K,
                              splits, k_split, vec, s);
}
