// 3x3 stride-1 SAME convolution (cross-correlation), NHWC, for Hopper
// (sm_90a), with a plain C entry point.
//
// Replaces the Pallas TPU kernel of benchmarks/pallas_conv3x3_experiment.py:
//   _kernel (:49, entry pallas_conv3x3 :72) -> conv3x3_wgmma (bf16) and
//   conv3x3_f32:
//   out[n, y, x, k] =
//       sum_{dy, dx, c} x[n, y+dy-1, x+dx-1, c] * w9[3dy+dx, c, k]
// with zeros outside the image, w9 (9, C, K) the HWIO weight with its taps
// flattened, f32 accumulation, and the result rounded to the input's dtype.
// The TPU kernel pads the input (1 row on top, 2 at the bottom, 1 column
// each side) and multiplies contiguous row slabs of the padded-width image;
// here the padding is never materialised: each tap's rows are the true
// pixels' rows shifted in place, and a pixel outside the image is a zero
// row.
//
// Bound on the H100 SXM: at ResNet-50's four 3x3 shapes (batch 256, bf16,
// C = K = 64..512) the 2*N*H*W*C*K*9 operations take 0.0599 ms at
// 989 TFLOP/s and the bytes (x, w9, out once each) 0.0614 ms at 56x56 and
// 0.009-0.031 ms deeper: about operation-bound throughout, bytes first at
// 56x56. So the bf16 product runs on the tensor cores through wgmma; f32
// takes a scalar FMA path (the tensor cores have no full-f32 mode).
//
// Design, bf16 (an implicit GEMM over true pixels, M = N*H*W rows):
//   * One block owns 128 output pixels, flattened over (n, y, x), by BN = 64
//     (K <= 64), 128 (K <= 128) or 256 output channels: grid ceil(M/128) *
//     ceil(K/BN), the channel tiles of one pixel tile adjacent. A tile may
//     straddle image rows and images; no padded column is computed.
//   * The reduction runs over C in chunks of 64 and, inside, over the 9
//     taps: 9 * ceil(C/64) steps. For tap (dy, dx) the A rows are the
//     tile's pixel range shifted by dy*W + dx in the (M, C) matrix x: one
//     TMA box of 128 rows x 64 channels (rows outside [0, M) and channels
//     past C arrive as zeros). Where the tap leaves the image the shifted
//     row holds a neighbouring row's or image's pixel instead of the zero
//     padding, so the consumers zero those rows in shared memory before the
//     products (a few rows per tap: x = 0 or W-1, y = 0 or H-1). The B
//     tile w9[t, c0:c0+64, n0:n0+BN] is BN/64 TMA boxes of w9 as (K, C, 9),
//     landing MN-major as it lies.
//   * A ring of 4 stages: one loader thread (its own warp) starts the TMA
//     boxes of each step into a free stage and the bytes complete on the
//     stage's "full" mbarrier; the stage is refilled once all 256 consumer
//     threads have arrived on its "empty" mbarrier. Staging the same tiles
//     with cp.async from every thread (zero fill by source size 0) was
//     slower at every ResNet-50 shape on the H100: the loop was bound by
//     starting the copies, not by the tensor cores or the memory.
//   * Two consumer warpgroups, each 64 pixel rows: per step 4 wgmma
//     m64nBNk16 (A and B from shared memory, B MN-major), f32 accumulators
//     in registers, one wgmma group left in flight behind the next.
//   * Rows that are not 16-byte aligned (C or K not a multiple of 8: TMA
//     needs 16-byte strides) are staged by the consumers with ordinary loads
//     instead, step by step.
//   * Epilogue: the accumulators round once to bf16 into shared memory, and
//     the tile leaves in 16-byte rows of the (M, K) output (masked at the
//     ragged pixel and channel edges; element stores where K % 8 != 0).
// Design, f32: the same tiles of true pixels with the scalar 64 x 64 tile
// product of mma_tile.cuh (loads through registers, one stage).
// Offsets into the image, the weights and the output are 64-bit. The kernel
// allocates nothing and launches on the caller's stream.

#include "mma_tile.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------ bf16 (wgmma)

constexpr int kWgRows = 128;        // output pixels per block
constexpr int kConvThreads = 288;   // 2 consumer warpgroups + a loader warp
constexpr int kChunk = 64;          // channels per reduction step
constexpr int kStages = 4;          // ring depth
constexpr int kATile = kWgRows * 128;  // bytes of one A tile
constexpr int kPanel = kChunk * 128;   // bytes of one 64-column B panel

template <int BN>
struct ConvSmem {
  static constexpr int kStage = kATile + (BN / 64) * kPanel;
  static constexpr int kBars = kStages * kStage;  // full[], then empty[]
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

// The A rows one consumer thread looks after: rows 64 wgi + (ct / 8) + 16 i
// of the tile (ct = its index in the warpgroup), 16-byte chunk ct % 8.
struct ARows {
  int y[4], x[4];  // the pixel's image row and column; past M: far outside
  int p[4];        // the pixel's index in (N, H, W)
};

// 8 channels (`valid` of them real, the rest zero) by ordinary loads: the
// path for rows that are not 16-byte aligned (C or K not a multiple of 8)
__device__ __forceinline__ void load8_by_hand(unsigned char* dst,
                                              const bf16* src, int valid) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = e < valid ? src[e] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// one step's products: 4 k16 slices of A (this warpgroup's 64 rows,
// K-major) x B (MN-major panels)
template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2],
                                         const unsigned char* sA,
                                         const unsigned char* sB) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const uint64_t da = wg::desc_k_major(sA + kk * 32);
    const uint64_t db = wg::desc_mn_major(sB + kk * 2048, kPanel);
    if constexpr (BN == 64)
      wg::mma_ss_n64<1>(acc, da, db, 1);
    else if constexpr (BN == 128)
      wg::mma_ss_n128<1>(acc, da, db, 1);
    else
      wg::mma_ss_n256<1>(acc, da, db, 1);
  }
}

// x (N, H, W, C), w9 (9, C, K), out (N, H, W, K), all contiguous;
// M = N*H*W. tx: x as the (C, M) matrix, boxes of 64 channels x 128 pixel
// rows; tw: w9 as (K, C, 9), boxes of 64 output x 64 input channels (each
// used only when its rows are 16-byte aligned: vecC, vecK).
template <int BN>
__global__ void __launch_bounds__(kConvThreads, BN == 64 ? 2 : 1)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const bf16* __restrict__ x, const bf16* __restrict__ w9,
                  bf16* __restrict__ out, int M, int H, int W, int C, int K,
                  int n_tiles) {
  using L = ConvSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int m0 = (blockIdx.x / n_tiles) * kWgRows;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const bool vecC = (C % 8) == 0, vecK = (K % 8) == 0;
  const int steps = 9 * ((C + kChunk - 1) / kChunk);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);  // every consumer thread is done
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {  // the loader warp: one thread keeps the ring full
    if (tid == 256) {
      const uint32_t bytes =
          (vecC ? kATile : 0) + (vecK ? BN / 64 * kPanel : 0);
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        const int c0 = (s / 9) * kChunk, t = s % 9;
        unsigned char* st = ring + slot * L::kStage;
        if (s >= kStages)
          wg::mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
        if (bytes == 0) {
          wg::mbar_arrive(full + slot);
          continue;
        }
        wg::mbar_expect_tx(full + slot, bytes);
        // tap t's rows are the tile's pixel range shifted by dy*W + dx;
        // rows outside [0, M) and channels past C arrive as zeros
        if (vecC)
          wg::tma_load_4d(st, &tx, full + slot, c0,
                          m0 + (t / 3 - 1) * W + t % 3 - 1, 0, 0);
        if (vecK)
          for (int p = 0; p < BN / 64; ++p)
            wg::tma_load_4d(st + kATile + p * kPanel, &tw, full + slot,
                            n0 + 64 * p, c0, t, 0);
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns pixel rows 64 wgi .. 64 wgi + 63
  const int ct = tid & 127, cc = ct & 7;
  ARows ar;
  {
    const int hw = H * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = m0 + 64 * wgi + (ct >> 3) + 16 * i;
      const int rem = p % hw;
      ar.y[i] = p < M ? rem / W : -(1 << 20);  // past M: never stored
      ar.x[i] = rem % W;
      ar.p[i] = p;
    }
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    const int c0 = (s / 9) * kChunk, t = s % 9;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    unsigned char* st = ring + slot * L::kStage;
    wg::mbar_wait(full + slot, (s / kStages) & 1);
    // A: the loaded shifted range holds the wrong pixel wherever the tap
    // leaves the image (it wraps to a neighbouring row or image): zero
    // those rows; without TMA (C % 8 != 0) load the rows by hand
    const int c = c0 + cc * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = ar.y[i] + dy, xx = ar.x[i] + dx;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
      unsigned char* dst = st + wg::sw128(64 * wgi + (ct >> 3) + 16 * i, cc);
      if (vecC) {
        if (!inside && ar.y[i] > -(1 << 19))
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const bool ok = inside && c < C;
        load8_by_hand(
            dst, ok ? x + (static_cast<long long>(ar.p[i]) + dy * W + dx) *
                              C + c
                    : x,
            ok ? min(8, C - c) : 0);
      }
    }
    if (!vecK) {  // B by hand, shared by both warpgroups
      constexpr int kRowChunks = BN / 8;
      const bf16* wt = w9 + static_cast<long long>(t) * C * K;
      for (int i = tid; i < kChunk * kRowChunks; i += 256) {
        const int r = i / kRowChunks, j = i % kRowChunks, k = n0 + 8 * j;
        const bool ok = c0 + r < C && k < K;
        load8_by_hand(st + kATile + (j >> 3) * kPanel + wg::sw128(r, j & 7),
                      ok ? wt + static_cast<long long>(c0 + r) * K + k : w9,
                      ok ? min(8, K - k) : 0);
      }
    }
    wg::fence_proxy_async();  // those stores, to wgmma's proxy
    if (vecK)
      wg::named_barrier(2 + wgi, 128);  // this warpgroup's rows are ready
    else
      wg::named_barrier(1, 256);  // and both warpgroups' B rows
    wg::fence_acc(acc);
    wg::fence();
    mma_step<BN>(acc, st + wgi * 64 * 128, st + kATile);
    wg::commit();
    wg::wait<1>();  // step s-1's products are done reading their stage
    if (s > 0) wg::mbar_arrive(empty + (s - 1) % kStages);
  }
  wg::wait<0>();
  wg::fence_acc(acc);
  wg::named_barrier(1, 256);  // both consumer warpgroups are off the ring

  // epilogue: round once to bf16 into shared memory, then 16-byte rows
  constexpr int kLdOut = BN + 8;  // bf16 elements per staged row
  bf16* sO = reinterpret_cast<bf16*>(ring);
  {
    const int w = (tid >> 5) & 3, l = tid & 31;
    const int row = wgi * 64 + 16 * w + (l >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(
            sO + (row + 8 * i) * kLdOut + 8 * j + 2 * (l & 3)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  wg::named_barrier(1, 256);
  for (int i = tid; i < kWgRows * (BN / 8); i += 256) {
    const int r = i / (BN / 8), j = i % (BN / 8);
    const int p = m0 + r, k = n0 + 8 * j;
    if (p >= M || k >= K) continue;
    const bf16* src = sO + r * kLdOut + 8 * j;
    bf16* dst = out + static_cast<long long>(p) * K + k;
    if (vecK) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const int valid = min(8, K - k);
      for (int e = 0; e < valid; ++e) dst[e] = src[e];
    }
  }
}

// ------------------------------------------------------------ f32 (scalar)

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

// x (N, H, W, C), w9 (9, C, K), out (N, H, W, K), all contiguous; one block
// per 64 pixels x 64 output channels (mma_tile.cuh's tile)
__global__ void __launch_bounds__(kThreads)
    conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w9,
                float* __restrict__ out, int M, int H, int W, int C, int K) {
  __shared__ __align__(16) float sA[kTM * kLdA];
  __shared__ __align__(16) float sB[kBK * kLdKN];
  __shared__ __align__(16) float sO[kTM * kLdO];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int hw = H * W;
  const bool vecC = (C % 8) == 0, vecK = (K % 8) == 0;

  float acc[8][4];
  zero_acc(acc);
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    const float* wt = w9 + static_cast<long long>(t) * C * K;
    for (int c0 = 0; c0 < C; c0 += kBK) {
      // A = the tile's pixels shifted by the tap; outside the image: zero
      for (int i = tid; i < kTM * (kBK / 8); i += kThreads) {
        const int rr = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
        const int p = m0 + rr, c = c0 + cc;
        const int rem = p % hw, yy = rem / W + dy, xx = rem % W + dx;
        const bool ok = p < M && c < C && yy >= 0 && yy < H && xx >= 0 &&
                        xx < W;
        const int valid = ok ? min(8, C - c) : 0;
        copy8(sA + rr * kLdA + cc,
              x + (valid ? (static_cast<long long>(p) + dy * W + dx) * C + c
                         : 0),
              valid, vecC);
      }
      // B = w9[t] rows c0.., columns n0.. (held (k, n))
      for (int i = tid; i < kBK * (kTN / 8); i += kThreads) {
        const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
        const int c = c0 + rr, k = n0 + cc;
        const int valid = c < C && k < K ? min(8, K - k) : 0;
        copy8(sB + rr * kLdKN + cc,
              wt + (valid ? static_cast<long long>(c) * K + k : 0), valid,
              vecK);
      }
      __syncthreads();
      tile_product<true>(acc, sA, sB, tid);
      __syncthreads();
    }
  }

  acc_to_smem<float>(sO, acc, tid);
  __syncthreads();
  for (int i = tid; i < kTM * (kTN / 8); i += kThreads) {
    const int rr = i / (kTN / 8), cc = (i % (kTN / 8)) * 8;
    const int p = m0 + rr, k = n0 + cc;
    if (p >= M || k >= K) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = sO[rr * kLdO + cc + e];
    store8(out + static_cast<long long>(p) * K + k, v, min(8, K - k), vecK);
  }
}

template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w9, void* out, int M,
                         int H, int W, int C, int K, cudaStream_t st) {
  // tensor maps only where the rows are 16-byte aligned; the kernel loads
  // the other operand by hand and never reads the map left empty
  CUtensorMap tx = {}, tw = {};
  cudaError_t e = cudaSuccess;
  if (C % 8 == 0) {
    const uint64_t dims[4] = {static_cast<uint64_t>(C),
                              static_cast<uint64_t>(M), 1, 1};
    const uint64_t strides[3] = {2ull * C, 2ull * C * M, 2ull * C * M};
    const uint32_t box[4] = {kChunk, kWgRows, 1, 1};
    e = wg::tensor_map_bf16(&tx, x, dims, strides, box);
  }
  if (e == cudaSuccess && K % 8 == 0) {
    const uint64_t dims[4] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(C), 9, 1};
    const uint64_t strides[3] = {2ull * K, 2ull * K * C, 18ull * K * C};
    const uint32_t box[4] = {64, kChunk, 1, 1};
    e = wg::tensor_map_bf16(&tw, w9, dims, strides, box);
  }
  constexpr int bytes = ConvSmem<BN>::kBytes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv3x3_wgmma<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (e != cudaSuccess) return e;
  const int n_tiles = (K + BN - 1) / BN;
  const long long blocks =
      static_cast<long long>((M + kWgRows - 1) / kWgRows) * n_tiles;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  conv3x3_wgmma<BN><<<static_cast<unsigned>(blocks), kConvThreads, bytes,
                       st>>>(tx, tw, static_cast<const bf16*>(x),
                             static_cast<const bf16*>(w9),
                             static_cast<bf16*>(out), M, H, W, C, K, n_tiles);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* w9, void* out, int M,
                       int H, int W, int C, int K, cudaStream_t st) {
  const dim3 grid((M + kTM - 1) / kTM, (K + kTN - 1) / kTN);
  conv3x3_f32<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w9),
      static_cast<float*>(out), M, H, W, C, K);
  return cudaGetLastError();
}

}  // namespace

// x: the input (N, H, W, C), unpadded; w9 (9, C, K); out (N, H, W, K); all
// contiguous and 16-byte aligned. dtype: 0 = float32 (scalar FMA),
// 1 = bfloat16 (wgmma). Returns the cudaError_t of the launch (0 =
// launched). The caller keeps N*H*W below 2^31 and every dimension
// positive (and K below 65536 * 64 for float32).
extern "C" int bigdl_conv3x3(const void* x, const void* w9, void* out, int N,
                             int H, int W, int C, int K, int dtype,
                             void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(N) * H * W;
  if (m >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = static_cast<int>(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return static_cast<int>(launch_f32(x, w9, out, M, H, W, C, K, st));
  if (K <= 64) return static_cast<int>(launch_wgmma<64>(x, w9, out, M, H, W,
                                                       C, K, st));
  if (K <= 128) return static_cast<int>(launch_wgmma<128>(x, w9, out, M, H,
                                                         W, C, K, st));
  return static_cast<int>(launch_wgmma<256>(x, w9, out, M, H, W, C, K, st));
}
