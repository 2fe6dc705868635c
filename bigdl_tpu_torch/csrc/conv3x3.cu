// 3x3 stride-1 SAME convolution (cross-correlation), NHWC, for Hopper
// (sm_90a), with a plain C entry point.
//
// Replaces the Pallas TPU kernel of benchmarks/pallas_conv3x3_experiment.py:
//   _kernel (:49, entry pallas_conv3x3 :72) -> conv3x3_kernel:
//   out[n, y, x, k] = sum_{dy, dx, c} xp[n, y+dy, x+dx, c] * w9[3dy+dx, c, k]
// with xp the input zero-padded by 1 row on top, 2 rows at the bottom and 1
// column on each side (the wrapper pads, as the JAX function pads outside its
// pallas_call), w9 (9, C, K) the HWIO weight with its taps flattened, f32
// accumulation, and the result rounded to the input's dtype.
//
// The tap-shift form (the TPU kernel's, kept here): flatten each padded image
// to ((H+3)*(W+2), C) rows. Output row r = y*(W+2) + x lives in padded-width
// space; tap t = 3*dy + dx is then the CONTIGUOUS row slab that starts at
// r + dy*(W+2) + dx, so the convolution is 9 row-shifted matrix products
// accumulated in f32: an implicit GEMM with no im2col gather. Columns W and
// W+1 of each padded-width row are computed and thrown away (2 of W+2
// columns: 3.4% of the work at 56x56, 22% at 7x7).
//
// Bound on the H100 SXM: at ResNet-50's four 3x3 shapes (batch 256, bf16,
// C = K = 64..512) the 2*N*H*W*C*K*9 operations take 0.0599 ms at
// 989 TFLOP/s and the bytes (x, w9, out once each) 0.0614 ms at 56x56 and
// 0.009-0.031 ms deeper: about operation-bound throughout, bytes first at
// 56x56. So the product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate); f32 takes a scalar FMA path (the tensor cores have no
// full-f32 mode).
//
// Design (simple and right first; wgmma, TMA and cp.async pipelining, and
// loads that skip the padding copy, are later work):
//   * One block owns 64 padded-width output rows of one image and 64 output
//     channels: grid (N * ceil(H*(W+2) / 64), ceil(K / 64)), 4 warps.
//   * The reduction loops over the 9 taps and, inside, over C in chunks of
//     32. The A tile is the slab's 64 rows x 32 channels, the B tile
//     w9[t, c0:c0+32, n0:n0+64]; both are staged in shared memory and
//     multiplied by mma_tile.cuh's tile product (shared with
//     fused_conv.cu): bf16 mma.sync from ldmatrix fragments, or scalar f32
//     FMAs.
//   * The f32 accumulator goes to shared memory, and the epilogue stores
//     only rows below H*(W+2) whose column is below W, rounded once.
//   * Ragged C and K are masked (zero-filled tiles, masked stores); 16-byte
//     loads and stores where C or K is a multiple of 8. Offsets into the
//     image, the weights and the output are 64-bit.
// The kernel allocates nothing and launches on the caller's stream.

#include "mma_tile.cuh"

namespace {

// dst[e] = src[e] for e < valid, zero past it (src is not read when valid
// is 0); one or two 16-byte copies when the whole chunk is valid and
// aligned (vec)
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src, int valid,
                                      bool vec) {
  if (vec && valid == 8) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)) / 2; ++i) d[i] = s[i];
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = e < valid ? src[e] : from_f<T>(0.f);
}

// ------------------------------------------------------------------ kernel

// xp (N, H+3, W+2, C), w9 (9, C, K), out (N, H, W, K), all contiguous;
// row_tiles = ceil(H*(W+2) / kTM)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ xp, const T* __restrict__ w9,
                   T* __restrict__ out, int H, int W, int C, int K,
                   int row_tiles) {
  __shared__ __align__(16) unsigned char smem_a[kTM * kLdA * sizeof(T)];
  __shared__ __align__(16) unsigned char smem_b[kBK * kLdKN * sizeof(T)];
  __shared__ __align__(16) float sO[kTM * kLdO];
  T* sA = reinterpret_cast<T*>(smem_a);
  T* sB = reinterpret_cast<T*>(smem_b);
  const int tid = threadIdx.x;
  const int n = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - n * row_tiles) * kTM;
  const int n0 = blockIdx.y * kTN;
  const int wp2 = W + 2;
  const int rows = H * wp2;  // padded-width output rows of one image
  const T* img = xp + static_cast<size_t>(n) * (H + 3) * wp2 * C;
  const bool vecC = (C % 8) == 0, vecK = (K % 8) == 0;

  float acc[8][4];
  zero_acc(acc);
  for (int t = 0; t < 9; ++t) {
    const int shift = (t / 3) * wp2 + t % 3;  // the tap's slab offset
    const T* wt = w9 + static_cast<size_t>(t) * C * K;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      // A = slab rows r0 + shift.., channels c0..; rows past the image's
      // output rows are zero (their stores are masked too)
      for (int i = tid; i < kTM * (kBK / 8); i += kThreads) {
        const int rr = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
        const int r = r0 + rr, c = c0 + cc;
        const int valid = r < rows && c < C ? min(8, C - c) : 0;
        copy8(sA + rr * kLdA + cc,
              img + (valid ? static_cast<size_t>(r + shift) * C + c : 0),
              valid, vecC);
      }
      // B = w9[t] rows c0.., columns n0.. (held (k, n))
      for (int i = tid; i < kBK * (kTN / 8); i += kThreads) {
        const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
        const int c = c0 + rr, k = n0 + cc;
        const int valid = c < C && k < K ? min(8, K - k) : 0;
        copy8(sB + rr * kLdKN + cc,
              wt + (valid ? static_cast<size_t>(c) * K + k : 0), valid,
              vecK);
      }
      __syncthreads();
      tile_product<true>(acc, sA, sB, tid);
      __syncthreads();
    }
  }

  acc_to_smem<T>(sO, acc, tid);
  __syncthreads();
  // keep rows below H*(W+2) whose column is below W
  for (int i = tid; i < kTM * (kTN / 8); i += kThreads) {
    const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
    const int r = r0 + rr, k = n0 + cc;
    if (r >= rows || k >= K) continue;
    const int oy = r / wp2, ox = r - oy * wp2;
    if (ox >= W) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sO[rr * kLdO + cc + e];
    const size_t at =
        ((static_cast<size_t>(n) * H + oy) * W + ox) * K + k;
    store8(out + at, v, min(8, K - k), vecK);
  }
}

template <typename T>
cudaError_t launch(const void* xp, const void* w9, void* out, int N, int H,
                   int W, int C, int K, cudaStream_t st) {
  const int row_tiles = (H * (W + 2) + kTM - 1) / kTM;
  const dim3 grid(static_cast<unsigned>(N) * row_tiles, (K + kTN - 1) / kTN);
  conv3x3_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(xp), static_cast<const T*>(w9),
      static_cast<T*>(out), H, W, C, K, row_tiles);
  return cudaGetLastError();
}

}  // namespace

// xp: the input padded to (N, H+3, W+2, C); w9 (9, C, K); out (N, H, W, K);
// all contiguous and 16-byte aligned. dtype: 0 = float32 (scalar FMA),
// 1 = bfloat16 (tensor cores). Returns the cudaError_t of the launch
// (0 = launched). The caller keeps N * ceil(H*(W+2)/64) and
// (H+3)*(W+2) below 2^31 and every dimension positive.
extern "C" int bigdl_conv3x3(const void* xp, const void* w9, void* out,
                             int N, int H, int W, int C, int K, int dtype,
                             void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 1 ? launch<bf16>(xp, w9, out, N, H, W, C, K, st)
                 : launch<float>(xp, w9, out, N, H, W, C, K, st));
}
