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
// bf16 copy of every weight and rounds the product to bf16. Every int8 code
// is exact in bf16 and a product of two bf16 values is exact in f32, so the
// kernel differs from the plain version only by the order of the f32 sums.
//
// Bound on the H100 SXM: at decode (M of 1-16 rows) bytes: the N * K int8
// weights, read once (2.36 MB for the 137m LM's fc1 or fc2, 25.2 MB for its
// head: 0.70 / 7.5 us at 3.35 TB/s); at prefill (M in the thousands)
// operations: 2 * M * N * K at the bf16 tensor-core peak (989 TFLOP/s).
//
// Two kernels; the Python wrapper's launch_plan picks one by M:
//
// * w8a16_rows (M <= 16, "decode", 16-row tiles; and M > 16 when x is f32
//   or TMA cannot read the operands, "rows", 64-row tiles): 4 warps own a
//   BM x BN output tile over one K range. Thread 0, before anything else,
//   requests the block's share of weight_q and x as TMA boxes into a ring
//   of shared-memory stages, one mbarrier each, refilled in place when the
//   share is deeper than the ring (decode: stages of 256 K, whose 256-byte
//   weight rows take a quarter of the TMA requests of 64-byte ones, and a
//   ring of two; rows: stages of 64 K in the 128-byte swizzle). The scales
//   and bias come into shared memory while the stages are in flight. The
//   warps multiply on mma.sync m16n8k16 (bf16, f32 accumulate) with the
//   int8 codes converted in registers where the fragment is loaded: K is
//   permuted alike for x and weight_q within each 64 K, so a thread's four
//   codes of one k16 step are one 32-bit word of shared memory (a 16-byte
//   load covers four steps), and four codes become two bf16 pairs by byte
//   permutes and f32 subtractions of 2^23 + 128 (CUTLASS's int8 -> bf16
//   converter). When the output tiles are too few to fill the card, K is
//   split over the blocks of one thread-block cluster (<= 8): every block
//   pushes its f32 partials into the shared memory of the block that
//   finishes them (distributed shared memory, stores only), and after one
//   cluster barrier each block sums its share of the tile's outputs over
//   the splits in order (no workspace, no counters: the sum repeats
//   bitwise). Rows of x are rounded to bf16 where they are loaded, so f32
//   x costs one convert per pair of values.
// * w8a16_wgmma (M > 16, bf16 x, K % 16 == 0, 16-byte aligned operands,
//   "prefill"): out-tile^T = weight_q-tile . x-tile^T on wgmma m64n128k16
//   with the weight tile as the register-sourced A operand, over tiles of
//   128 x rows and 128 or 256 weight rows (the wrapper's plan), one
//   persistent CTA per SM walking the tiles. One loader thread keeps a TMA
//   ring of int8 weight tiles (64 K, 64-byte swizzle) and bf16 x tiles
//   (128 rows x 64 K, 128-byte swizzle, K-major B) in flight, running
//   ahead into the next tile; two consumer warpgroups (the loader's
//   registers handed to them by setmaxnreg) read their A fragments from
//   the int8 tile (two 16-bit loads per row and k16 step), convert them as
//   above and issue four wgmma per m64 tile and stage. The epilogue (scale,
//   casts, bias) runs in registers and goes through a shared-memory tile
//   of its own, so the (M, N) output is written row-major with 16-byte
//   stores while the loader fills the ring for the next tile.
// Host side, every tensor map is cached by what it encodes, so a call
// with a weight and an activation buffer seen before encodes nothing.
//
// Probe builds (tools/torch_w8a16_probe.py, never the package's):
// -DW8_NO_CONVERT gives w8a16_wgmma constant A fragments (no int8 code read
// or converted), -DW8_NO_MMA issues no wgmma; both leave the TMA ring and
// the epilogue, to time the feed alone.
//
// Rows past M, columns past N and depths past K arrive as zeros (TMA's
// out-of-bounds fill, or the by-hand loads when K % 16 != 0 or a pointer
// is not 16-byte aligned), so no dimension needs to be a multiple of a
// tile. The kernels allocate nothing and launch on the caller's stream.

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "wgmma.cuh"

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kDepth = 64;        // K per stage
constexpr int kMaxSplits = 8;     // a portable cluster holds at most 8 blocks
constexpr int kRowsThreads = 128; // 4 warps
constexpr int kPfThreads = 384;   // 2 consumer warpgroups + 1 loader
constexpr int kPfRows = 128;      // x rows of a prefill tile
constexpr int kPfX = kPfRows * 128;            // x tile bytes (bf16)

// A prefill tile: WR (128 or 256) weight rows x 128 x rows, a stage of 64
// K holding the x tile and the weight tile (64-byte rows), in a ring of
// kStages; the epilogue's out[m][n] tile of type O beside the ring.
template <int WR, typename O>
struct PfSmem {
  static constexpr int kW = WR * kDepth;
  static constexpr int kStage = kPfX + kW;               // 1024-aligned
  static constexpr int kStages = WR == 128 ? 6 : 4;
  static constexpr int kLdO = WR + 16 / static_cast<int>(sizeof(O));
  static constexpr int kOut = kPfRows * kLdO * static_cast<int>(sizeof(O));
  static constexpr int kBytes = 1024 + kStages * kStage + kOut +
                                2 * kStages * 8;
};

// ------------------------------------------------------------ conversions

// four int8 codes (byte i of w is code i) -> lo = bf16x2(code0, code1),
// hi = bf16x2(code2, code3), exactly: the code + 128 goes into the low byte
// of 2^23 as an f32 bit pattern, 2^23 + 128 is subtracted (exact), and the
// high halves of the two f32 results are the bf16 values (exact: |code|
// needs at most 8 significant bits)
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;   // 2^23
  constexpr float kBias = 8388736.0f;        // 2^23 + 128
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7650)),
                             kBias);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7651)),
                             kBias);
  const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7652)),
                             kBias);
  const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, kMagic, 0x7653)),
                             kBias);
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// the epilogue of one output: acc * scale, then the out dtype and bias (a
// bf16 bias arrives widened to f32, exactly)
__device__ __forceinline__ void finish(float acc, float scale, bool has_bias,
                                       float bias, float* out) {
  float v = __fmul_rn(acc, scale);
  if (has_bias) v = __fadd_rn(v, bias);
  *out = v;
}

__device__ __forceinline__ void finish(float acc, float scale, bool has_bias,
                                       float bias, bf16* out) {
  bf16 v = __float2bfloat16_rn(__fmul_rn(acc, scale));
  if (has_bias) v = __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), bias));
  *out = v;
}

__device__ __forceinline__ float bias_at(const void* bias, int n, float) {
  return static_cast<const float*>(bias)[n];
}
__device__ __forceinline__ float bias_at(const void* bias, int n, bf16) {
  return __bfloat162float(static_cast<const bf16*>(bias)[n]);
}

// thread-block cluster barrier, split: arrive (release), then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------- w8a16_rows (mma.sync)

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage layout of w8a16_rows, a stage SUB x 64 deep in K. SUB 1 (64 K, the
// 64-row tiles):
// x first, as XP panels of BM rows x 128 bytes in the 128-byte swizzle
// (bf16: one panel of 64 K; f32: two of 32 K), then weight_q as BN rows x
// 64 bytes, unswizzled (a quarter warp's 16-byte loads cover two whole
// rows: no bank conflict). SUB 4 (256 K: TMA boxes of 256-byte weight
// rows, a quarter of the requests of 64-byte ones; the 16-row tiles): x as
// BM rows of 256 values, then weight_q as BN rows of 256 bytes, both
// unswizzled.
template <typename T, int BM, int BN, int SUB>
struct RowsSmem {
  static constexpr int kXPanels = static_cast<int>(sizeof(T)) / 2;
  static constexpr int kK = kDepth * SUB;                  // K per stage
  static constexpr int kXRow = kK * static_cast<int>(sizeof(T));
  static constexpr int kX = BM * kXRow;
  static constexpr int kW = BN * kK;
  static constexpr int kStage = (kX + kW + 1023) / 1024 * 1024;
  // the partials other blocks of the cluster push: splits x share floats
  static constexpr int kRecv = (BM * BN + kMaxSplits) * 4;
  static int bytes(int ring) { return 1024 + ring * kStage + kRecv + ring * 8; }
  // byte offset of weight row r's 16 codes for thread t4 in sub-stage u
  static __device__ __forceinline__ int w_at(int r, int u, int t4) {
    return kX + r * kK + u * kDepth + 16 * t4;
  }
};

// Thread (g, t4) of a warp (g = lane / 4, t4 = lane % 4) holds, for the
// k16 step s of a 64-deep sub-stage, the mma slots {2 t4, 2 t4 + 1} and
// {2 t4 + 8, 2 t4 + 9}; they take the sub-stage's K positions 16 t4 + 4 s
// + {0, 1} and + {2, 3}, for x (A) and weight_q (B) alike, so the sum
// covers the sub-stage's 64 positions once. x row r of sub-stage u: the 16
// positions 16 t4 .. 16 t4 + 15 as bf16 pairs, a[2 s] (positions 4 s,
// 4 s + 1) and a[2 s + 1].
template <typename T, int BM, int SUB>
__device__ __forceinline__ void x_frag(const unsigned char* sx, int r, int u,
                                       int t4, uint32_t (&a)[8]) {
  if constexpr (SUB == 1) {
    const int sw = r & 7;
    if constexpr (sizeof(T) == 2) {
      const unsigned char* row = sx + r * 128;
      const uint4 c0 =
          *reinterpret_cast<const uint4*>(row + (((2 * t4) ^ sw) << 4));
      const uint4 c1 =
          *reinterpret_cast<const uint4*>(row + (((2 * t4 + 1) ^ sw) << 4));
      a[0] = c0.x; a[1] = c0.y; a[2] = c0.z; a[3] = c0.w;
      a[4] = c1.x; a[5] = c1.y; a[6] = c1.z; a[7] = c1.w;
    } else {
      const unsigned char* row = sx + (t4 >> 1) * BM * 128 + r * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = *reinterpret_cast<const float4*>(
            row + ((((t4 & 1) * 4 + i) ^ sw) << 4));
        a[2 * i] = wg::pack_bf16(f.x, f.y);
        a[2 * i + 1] = wg::pack_bf16(f.z, f.w);
      }
    }
  } else {
    const T* row = reinterpret_cast<const T*>(sx) + r * kDepth * SUB +
                   u * kDepth + 16 * t4;
    if constexpr (sizeof(T) == 2) {
      const uint4 c0 = reinterpret_cast<const uint4*>(row)[0];
      const uint4 c1 = reinterpret_cast<const uint4*>(row)[1];
      a[0] = c0.x; a[1] = c0.y; a[2] = c0.z; a[3] = c0.w;
      a[4] = c1.x; a[5] = c1.y; a[6] = c1.z; a[7] = c1.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = reinterpret_cast<const float4*>(row)[i];
        a[2 * i] = wg::pack_bf16(f.x, f.y);
        a[2 * i + 1] = wg::pack_bf16(f.z, f.w);
      }
    }
  }
}

// one stage by hand into st (when TMA cannot read the operands): zeros
// past M, N and K, the same layout TMA writes
template <typename T, int BM, int BN, int SUB>
__device__ void fill_by_hand(unsigned char* st, const T* x, const int8_t* wq,
                             int M, int N, int K, int m0, int n0, int k0,
                             int tid) {
  using L = RowsSmem<T, BM, BN, SUB>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values a chunk
  constexpr int kRowChunks = L::kXRow / 16;
  for (int i = tid; i < BM * kRowChunks; i += kRowsThreads) {
    const int r = i / kRowChunks, c = i % kRowChunks;
    int k, at;
    if constexpr (SUB == 1) {   // chunk c of 8 in panel p (swizzled)
      const int p = c / 8, cc = c % 8;
      k = k0 + p * (64 / L::kXPanels) + cc * kPer;
      at = p * BM * 128 + r * 128 + ((cc ^ (r & 7)) << 4);
    } else {
      k = k0 + c * kPer;
      at = r * L::kXRow + c * 16;
    }
    const int m = m0 + r;
    __align__(16) T v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      v[e] = (m < M && k + e < K) ? x[static_cast<size_t>(m) * K + k + e]
                                  : T(0.0f);
    *reinterpret_cast<uint4*>(st + at) = *reinterpret_cast<const uint4*>(v);
  }
  constexpr int kWChunks = L::kK / 16;
  for (int i = tid; i < BN * kWChunks; i += kRowsThreads) {
    const int r = i / kWChunks, c = i % kWChunks;
    const int n = n0 + r, k = k0 + c * 16;
    __align__(16) int8_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      v[e] = (n < N && k + e < K) ? wq[static_cast<size_t>(n) * K + k + e]
                                  : int8_t(0);
    *reinterpret_cast<uint4*>(st + L::kX + r * L::kK + c * 16) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// stage s of a split starting at stage st0 into slot s % ring: thread 0
// requests x and the weight tile by TMA on the slot's barrier, or every
// thread loads them by hand (the caller then meets at a barrier)
template <typename T, int BM, int BN, int SUB>
__device__ __forceinline__ void fill_stage(
    unsigned char* ring_base, int s, int ring, int st0, uint64_t* full,
    const CUtensorMap* tx, const CUtensorMap* tw, const T* x,
    const int8_t* wq, int M, int N, int K, int m0, int n0, int tma, int tid) {
  using L = RowsSmem<T, BM, BN, SUB>;
  unsigned char* st = ring_base + (s % ring) * L::kStage;
  const int k0 = (st0 + s) * L::kK;
  if (!tma) {
    fill_by_hand<T, BM, BN, SUB>(st, x, wq, M, N, K, m0, n0, k0, tid);
    return;
  }
  if (tid == 0) {
    uint64_t* bar = full + s % ring;
    wg::mbar_expect_tx(bar, L::kX + L::kW);
    if constexpr (SUB == 1) {
#pragma unroll
      for (int p = 0; p < L::kXPanels; ++p)
        wg::tma_load_4d(st + p * BM * 128, tx, bar,
                        k0 + p * (64 / L::kXPanels), m0, 0, 0);
    } else {
      wg::tma_load_4d(st, tx, bar, k0, m0, 0, 0);
    }
    wg::tma_load_4d(st + L::kX, tw, bar, k0, n0, 0, 0);
  }
}

// WM: warps along M (1: BM 16, the 4 warps side by side along N; 4: BM 64,
// each warp 16 rows and every column). T: x's type; O: out's and bias's
// type (bias may be null). Grid: (splits * column tiles, row tiles), the
// splits of one tile one cluster. tma: 1 when the maps are valid (K % 16
// == 0 and x, weight_q 16-byte aligned), else the stages are filled by
// hand.
template <typename T, typename O, int WM, int BN, int SUB>
__global__ void __launch_bounds__(kRowsThreads)
w8a16_rows(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw, const T* __restrict__ x,
           const int8_t* __restrict__ wq, const float* __restrict__ scale,
           const void* __restrict__ bias, O* __restrict__ out, int M, int N,
           int K, int k_split, int ring, int tma) {
  constexpr int BM = 16 * WM;
  constexpr int WN = 4 / WM;          // warps along N
  constexpr int CW = BN / WN;         // columns per warp
  constexpr int NT = CW / 8;          // n8 accumulators per warp
  using L = RowsSmem<T, BM, BN, SUB>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float s_scale[BN], s_bias[BN];
  unsigned char* ring_base = wg::align1024(smem_raw);
  float* recv = reinterpret_cast<float*>(ring_base + ring * L::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_base + ring * L::kStage +
                                               L::kRecv);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * BM;
  const int per = k_split / L::kK;
  const int st0 = split * per;
  const int nst = max(0, min((K + L::kK - 1) / L::kK, st0 + per) - st0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % WM, wn = warp / WM;

  // thread 0 requests the first stages before anything else; the other
  // threads meet its barriers only after the __syncthreads below
  const int first = min(ring, nst);
  if (tma && tid == 0) {
    prefetch_map(&tx);
    prefetch_map(&tw);
    for (int i = 0; i < ring; ++i) wg::mbar_init(full + i, 1);
    wg::mbar_init_fence();
    for (int s = 0; s < first; ++s)
      fill_stage<T, BM, BN, SUB>(ring_base, s, ring, st0, full, &tx, &tw, x, wq,
                            M, N, K, m0, n0, 1, 0);
  }
  if (S > 1) cluster_arrive_relaxed();   // every block of the cluster runs
  // the epilogue's scales and bias, read while the stages are in flight
  for (int c = tid; c < BN; c += kRowsThreads) {
    const int n = n0 + c;
    s_scale[c] = n < N ? scale[n] : 0.f;
    s_bias[c] = bias != nullptr && n < N ? bias_at(bias, n, O()) : 0.f;
  }
  if (!tma)
    for (int s = 0; s < first; ++s)
      fill_stage<T, BM, BN, SUB>(ring_base, s, ring, st0, full, &tx, &tw, x, wq,
                            M, N, K, m0, n0, 0, tid);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int s = 0; s < nst; ++s) {
    const int slot = s % ring;
    const unsigned char* st = ring_base + slot * L::kStage;
    if (tma) wg::mbar_wait(full + slot, (s / ring) & 1);
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      uint32_t a0[8], a1[8];
      x_frag<T, BM, SUB>(st, wm * 16 + g, u, t4, a0);
      x_frag<T, BM, SUB>(st, wm * 16 + g + 8, u, t4, a1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            st + L::w_at(wn * CW + 8 * j + g, u, t4));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t b0, b1;
          i8x4_to_bf16x4(words[k], b0, b1);
          mma16816(acc[j], a0[2 * k], a1[2 * k], a0[2 * k + 1],
                   a1[2 * k + 1], b0, b1);
        }
      }
    }
    if (s + ring < nst) {   // a share deeper than the ring: refill the slot
      __syncthreads();
      fill_stage<T, BM, BN, SUB>(ring_base, s + ring, ring, st0, full, &tx, &tw,
                            x, wq, M, N, K, m0, n0, tma, tid);
      if (!tma) __syncthreads();
    }
  }

  // accumulator e of n8 tile j: row g + 8 (e >> 1), column 8 j + 2 t4 +
  // (e & 1) of the warp's 16 x CW sub-tile
  const int r0 = wm * 16 + g, c0 = wn * CW + 2 * t4;
  const bool has_bias = bias != nullptr;
  if (S == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), c = c0 + 8 * j + (e & 1);
        if (m0 + r < M && n0 + c < N)
          finish(acc[j][e], s_scale[c], has_bias, s_bias[c],
                 out + static_cast<size_t>(m0 + r) * N + n0 + c);
      }
    return;
  }
  // the tile's outputs are shared out in split order: block b finishes
  // outputs [b share, (b + 1) share). Each block pushes every partial it
  // holds into the finishing block's recv[split][.] through distributed
  // shared memory (stores only), and after one cluster barrier each block
  // sums its share over the splits in order
  constexpr int E = BM * BN;
  const int share = (E + S - 1) / S;
  cluster_wait();   // (the arrival at the start) every block has started
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (r0 + 8 * (e >> 1)) * BN + c0 + 8 * j + (e & 1);
      const int owner = i / share;
      *cluster.map_shared_rank(recv + split * share + (i - owner * share),
                               owner) = acc[j][e];
    }
  cluster_arrive();
  cluster_wait();
  const int begin = split * share, end = min(E, begin + share);
  for (int i = begin + tid; i < end; i += kRowsThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r >= M || n0 + c >= N) continue;
    float sum = 0.f;
    for (int q = 0; q < S; ++q) sum += recv[q * share + (i - begin)];
    finish(sum, s_scale[c], has_bias, s_bias[c],
           out + static_cast<size_t>(m0 + r) * N + n0 + c);
  }
}

// -------------------------------------------------- w8a16_wgmma (prefill)

// out (M, N) = finish(x . weight_q^T) over WR x 128 tiles, tile t owning
// weight rows WR (t % col_tiles).. and x rows 128 (t / col_tiles)..; CTA b
// (persistent, one per SM) takes tiles b, b + gridDim.x, .., and its loader
// runs ahead into the next tile while the consumers finish one. Consumer
// warpgroup c owns weight rows c WR / 2 .. as WR / 128 m64 tiles; the
// loader gives up its registers to them (setmaxnreg). tx: x (M, K) bf16 in
// boxes of 64 K x 128 rows (128-byte swizzle); tw: weight_q (N, K) int8 in
// boxes of 64 K x WR rows (64-byte swizzle).
template <int WR, typename O>
__global__ void __launch_bounds__(kPfThreads, 1)
w8a16_wgmma(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const float* __restrict__ scale, const void* __restrict__ bias,
            O* __restrict__ out, int M, int N, int K, int col_tiles,
            int tiles, int vec_out) {
  using L = PfSmem<WR, O>;
  constexpr int MT = WR / 128;     // m64 tiles per consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = wg::align1024(smem_raw);
  O* so = reinterpret_cast<O*>(ring + L::kStages * L::kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + L::kStages * L::kStage + L::kOut);
  uint64_t* empty = full + L::kStages;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int steps = (K + kDepth - 1) / kDepth;
  if (tid == 0) {
    prefetch_map(&tx);
    prefetch_map(&tw);
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 256);   // every consumer thread is done
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 2) {   // the loader: one thread keeps the ring full
    wg::setmaxnreg_dec<40>();
    if (tid == 256) {
      int g = 0;    // stages loaded so far, over every tile of this CTA
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % col_tiles) * WR;
        const int m0 = (t / col_tiles) * kPfRows;
        for (int s = 0; s < steps; ++s, ++g) {
          const int slot = g % L::kStages;
          unsigned char* st = ring + slot * L::kStage;
          if (g >= L::kStages)
            wg::mbar_wait(empty + slot, ((g / L::kStages) & 1) ^ 1);
          wg::mbar_expect_tx(full + slot, L::kStage);
          wg::tma_load_4d(st, &tx, full + slot, s * kDepth, m0, 0, 0);
          wg::tma_load_4d(st + kPfX, &tw, full + slot, s * kDepth, n0, 0, 0);
        }
      }
    }
  } else {
    wg::setmaxnreg_inc<232>();
    // m64 tile mt of this warpgroup: weight rows ra(mt) = c WR / 2 + 64 mt +
    // 16 w + g (and + 8: the same swizzle); its A fragment of k16 step kk
    // holds codes kk * 16 + 2 t4 (+1) and + 8 (+1)
    const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int rbase = wgi * (WR / 2) + 16 * w + g;
    int gs = 0;   // stages consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % col_tiles) * WR;
      const int m0 = (t / col_tiles) * kPfRows;
      float acc[MT][64];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
      uint32_t af[MT][4][4];
      for (int s = 0; s < steps; ++s, ++gs) {
        const int slot = gs % L::kStages;
        const unsigned char* st = ring + slot * L::kStage;
        wg::mbar_wait(full + slot, (gs / L::kStages) & 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {   // m64 tile mt's products run
          const int ra = rbase + 64 * mt;   // while tile mt + 1 converts
          const int sw = (ra >> 1) & 3;     // 64-byte swizzle of the row
          const unsigned char* w0 = st + kPfX + ra * 64 + 2 * t4;
          const unsigned char* w1 = w0 + 8 * 64;
#ifndef W8_NO_CONVERT
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int off = (kk ^ sw) << 4;
            const uint32_t lo0 = *reinterpret_cast<const uint16_t*>(w0 + off);
            const uint32_t hi0 =
                *reinterpret_cast<const uint16_t*>(w0 + off + 8);
            const uint32_t lo1 = *reinterpret_cast<const uint16_t*>(w1 + off);
            const uint32_t hi1 =
                *reinterpret_cast<const uint16_t*>(w1 + off + 8);
            i8x4_to_bf16x4(lo0 | (hi0 << 16), af[mt][kk][0], af[mt][kk][2]);
            i8x4_to_bf16x4(lo1 | (hi1 << 16), af[mt][kk][1], af[mt][kk][3]);
          }
#else
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) af[mt][kk][r] = 0x3f803f80u + sw;
#endif
#ifndef W8_NO_MMA
          wg::fence_acc(acc[mt]);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg::mma_rs_n128<0>(acc[mt], af[mt][kk],
                               wg::desc_k_major(st + kk * 32), 1);
          wg::commit();
#else
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[mt][kk * 4 + r] += __uint_as_float(af[mt][kk][r]);
#endif
        }
        wg::wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          wg::fence_acc(acc[mt]);
          wg::fence_frag(af[mt]);
        }
        wg::mbar_arrive(empty + slot);
      }

      // acc[mt][4 j + 2 i + e]: weight row (output column) ra(mt) + 8 i, x
      // row (output row) 8 j + 2 t4 + e; finished in registers, staged as
      // out[m][n] once the last tile's rows have left the staging tile
      wg::named_barrier(1, 256);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nl = rbase + 64 * mt + 8 * i, n = n0 + nl;
          const float sc = n < N ? scale[n] : 0.f;
          const bool has_bias = bias != nullptr && n < N;
          const float bv = has_bias ? bias_at(bias, n, O()) : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              finish(acc[mt][4 * j + 2 * i + e], sc, has_bias, bv,
                     so + (8 * j + 2 * t4 + e) * L::kLdO + nl);
        }
      wg::named_barrier(1, 256);
      constexpr int kPer = 16 / static_cast<int>(sizeof(O));
      constexpr int kRowChunks = WR / kPer;
      for (int i = tid; i < kPfRows * kRowChunks; i += 256) {
        const int r = i / kRowChunks, c = (i % kRowChunks) * kPer;
        const int m = m0 + r, n = n0 + c;
        if (m >= M || n >= N) continue;
        const O* src = so + r * L::kLdO + c;
        O* dst = out + static_cast<size_t>(m) * N + n;
        if (vec_out && n + kPer <= N) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kPer && n + e < N; ++e) dst[e] = src[e];
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

// a 2-d tensor (outer x inner elements, rows packed) read in boxes of
// box_outer x box_inner; out-of-bounds elements arrive as zeros
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                          int elem_bytes, const void* base, uint64_t inner,
                          uint64_t outer, uint32_t box_inner,
                          uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  const wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {inner, outer, 1, 1};
  const cuuint64_t rows = inner * static_cast<uint64_t>(elem_bytes);
  const cuuint64_t strides[3] = {rows, rows * outer, rows * outer};
  const cuuint32_t box[4] = {box_inner, box_outer, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// tensor maps by everything they encode: a projection's weights keep their
// address from call to call and the caching allocator hands activations the
// same few addresses, and a map holds nothing but what its key holds, so a
// map found here is the one an encode would give (and skips the encode's
// host time)
struct MapKey {
  const void* p;
  uint64_t inner, outer;
  uint32_t box_inner, box_outer;
  int type, swizzle;
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && outer == o.outer &&
           box_inner == o.box_inner && box_outer == o.box_outer &&
           type == o.type && swizzle == o.swizzle;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    for (uint64_t v : {k.inner, k.outer, static_cast<uint64_t>(k.box_inner),
                       static_cast<uint64_t>(k.box_outer),
                       static_cast<uint64_t>(k.type),
                       static_cast<uint64_t>(k.swizzle)})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};

cudaError_t cached_map(CUtensorMap* map, CUtensorMapDataType type,
                       int elem_bytes, const void* base, uint64_t inner,
                       uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                       CUtensorMapSwizzle swizzle) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{base, inner, outer, box_inner, box_outer,
                   static_cast<int>(type), static_cast<int>(swizzle)};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const cudaError_t e = tensor_map_2d(map, type, elem_bytes, base, inner,
                                      outer, box_inner, box_outer, swizzle);
  if (e != cudaSuccess) return e;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return cudaSuccess;
}

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void* x;
  const void* wq;
  const float* scale;
  const void* bias;
  void* out;
  int M, N, K, splits, k_split, ring;
  cudaStream_t stream;
};

template <typename T, typename O, int WM, int BN, int SUB>
cudaError_t launch_rows(const Args& a) {
  constexpr int BM = 16 * WM;
  using L = RowsSmem<T, BM, BN, SUB>;
  const bool tma = a.K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.wq) % 16 == 0;
  CUtensorMap tx = {}, tw = {};
  cudaError_t e = cudaSuccess;
  if (tma) {
    const CUtensorMapDataType xt = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (SUB == 1)
      e = cached_map(&tx, xt, sizeof(T), a.x, a.K, a.M, 64 / L::kXPanels,
                     BM, CU_TENSOR_MAP_SWIZZLE_128B);
    else
      e = cached_map(&tx, xt, sizeof(T), a.x, a.K, a.M, L::kK, BM,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess)
      e = cached_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.wq, a.K, a.N,
                     L::kK, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  const int bytes = L::bytes(a.ring);
  if (bytes > 232448) return cudaErrorInvalidValue;
  static int allowed = 0;   // the largest size set so far
  if (bytes > allowed) {
    e = allow_smem(w8a16_rows<T, O, WM, BN, SUB>, bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  const long long cols = (a.N + BN - 1) / BN;
  const long long gx = cols * a.splits;
  const long long gy = (a.M + BM - 1) / BM;
  if (gx >= (1ll << 31) || gy >= 65536) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w8a16_rows<T, O, WM, BN, SUB>, tx, tw,
                         static_cast<const T*>(a.x),
                         static_cast<const int8_t*>(a.wq), a.scale, a.bias,
                         static_cast<O*>(a.out), a.M, a.N, a.K, a.k_split,
                         a.ring, tma ? 1 : 0);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int WR, typename O>
cudaError_t launch_wgmma(const Args& a) {
  using L = PfSmem<WR, O>;
  static_assert(L::kBytes <= 232448, "the prefill ring and tile fit an SM");
  if (a.K % 16 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.wq) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tx = {}, tw = {};
  cudaError_t e =
      cached_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.K, a.M, 64,
                 kPfRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = cached_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.wq, a.K, a.N,
                   kDepth, WR, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return e;
  static bool allowed = false;
  if (!allowed) {
    e = allow_smem(w8a16_wgmma<WR, O>, L::kBytes);
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  const long long col_tiles = (a.N + WR - 1) / WR;
  const long long tiles = col_tiles * ((a.M + kPfRows - 1) / kPfRows);
  if (tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const int vec_out = a.N % (16 / static_cast<int>(sizeof(O))) == 0 &&
                      reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  w8a16_wgmma<WR, O><<<grid, kPfThreads, L::kBytes, a.stream>>>(
      tx, tw, a.scale, a.bias, static_cast<O*>(a.out), a.M, a.N, a.K,
      static_cast<int>(col_tiles), static_cast<int>(tiles), vec_out);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t by_regime(int regime, int bn, int stage_k, const Args& a) {
  if (regime == 0 && stage_k == 4 * kDepth) {
    switch (bn) {
      case 32: return launch_rows<T, O, 1, 32, 4>(a);
      case 64: return launch_rows<T, O, 1, 64, 4>(a);
      case 128: return launch_rows<T, O, 1, 128, 4>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (regime == 1 && bn == 64 && stage_k == kDepth)
    return launch_rows<T, O, 4, 64, 1>(a);
  if (regime == 2 && sizeof(T) == 2 && a.splits == 1 && stage_k == kDepth) {
    if (bn == 128) return launch_wgmma<128, O>(a);
    if constexpr (sizeof(O) == 2)   // an f32 staging tile would not fit
      if (bn == 256) return launch_wgmma<256, O>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (M, K) contiguous, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); wq: (N, K)
// int8, contiguous; scale: (N,) f32; out: (M, N), contiguous, f32
// (out_bf16 = 0) or bf16 (out_bf16 = 1); bias: null or (N,) of out's type.
// regime: 0 = w8a16_rows with 16-row tiles (bn 32, 64 or 128; stage_k
// 256), 1 = w8a16_rows with 64-row tiles (bn 64, stage_k 64), 2 =
// w8a16_wgmma (bf16 x, bn 128 or 256 weight rows, stage_k 64, one split,
// K % 16 == 0, x and wq 16-byte aligned). splits: blocks that share one output tile's K (one
// cluster, 1..8); k_split: the K of one split, a multiple of stage_k with
// splits * k_split >= K (a split wholly past K adds zeros); ring:
// shared-memory stages of a rows block (>= 1). Returns the launch's error
// (cudaErrorInvalidValue for a size, plan or dtype it does not take).
extern "C" int bigdl_w8a16(const void* x, const void* wq, const void* scale,
                           const void* bias, void* out, int M, int N, int K,
                           int regime, int bn, int splits, int k_split,
                           int stage_k, int ring, int x_bf16, int out_bf16,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || splits > kMaxSplits ||
      stage_k <= 0 || k_split <= 0 || k_split % stage_k != 0 || ring <= 0 ||
      static_cast<long long>(splits) * k_split < K)
    return cudaErrorInvalidValue;
  const Args a{x, wq, static_cast<const float*>(scale), bias, out, M, N, K,
               splits, k_split, ring, static_cast<cudaStream_t>(stream)};
  if (x_bf16 && out_bf16)
    return by_regime<bf16, bf16>(regime, bn, stage_k, a);
  if (x_bf16) return by_regime<bf16, float>(regime, bn, stage_k, a);
  if (out_bf16) return by_regime<float, bf16>(regime, bn, stage_k, a);
  return by_regime<float, float>(regime, bn, stage_k, a);
}
