// X7: the block-sparse ("one-hot MXU") SpMM over occupied [t, t] tiles.
//
// Replaces: tf_geometric_tpu/ops/tiled_spmm.py, _tiled_pass (the pass of
// tiled_spmm's forward and, on the transpose packing, of its dh).
//
// Contract, for output row tile rt, the tiles b in [row_ptr[rt], row_ptr[rt+1])
// sorted by row tile, each a dense block a[b] of A (t x t, row-major) whose
// columns are the source rows col_tile[b] * t + k:
//   out[rt * t + r] = sum_b sum_k a[b][r][k] * cast(h[col_tile[b] * t + k])
// for every row below num_out_rows; source rows at or past n_src read as 0
// (the JAX pass pads h to whole tiles). cast() is the tiles' dtype, as the
// JAX pass casts its gathered operand tiles (bf16 tiles round h to bf16,
// float32 tiles widen a bf16 h). Accumulation is float32; out has h's dtype.
// A row tile with no tile writes exact zeros. t is a multiple of 16 up to
// 256. The result is the same bit for bit from run to run.
//
// Bound on the H100: bytes. A pass must read every tile whole (B * t^2
// elements: ~2.1 GB on the community arxiv graph at t = 128, bf16), the
// operand rows they name and write the output once: ~0.63 ms at 3.35 TB/s.
// Its 2 * B * t^2 * F flops need ~0.25 ms at the bf16 tensor-core rate.
//
// Design (bf16 tiles, tiled_spmm_tma_kernel):
// - Blocks take the row tiles with the most tiles first (order, from the
//   wrapper): the last blocks to start are the shortest, so the pass does
//   not end on a long row tile started late (25 to 72 tiles per row tile
//   on the community graph).
// - One block owns one output row tile and all of F up to 256 columns at
//   t <= 128 (128 at t = 256), so each tile is read once; wider F takes F
//   chunks in grid.y, the only case that reads a tile again. The block sums
//   its row tile's tiles in row-pointer order: no split over k, no atomics,
//   the same bits every run.
// - The wrapper casts h to bf16 once per call (ops/tiled_spmm.py), padded to
//   whole tiles of rows and to a multiple of 8 columns (a 16-byte row
//   stride), so the ~45 reads of each operand block come from a 43 MB bf16
//   copy the 50 MB L2 can hold, not from the 87 MB float32 h.
// - One producer warp keeps a ring of shared-memory stages full with TMA
//   (cp.async.bulk.tensor, mbarrier full/empty pairs): a stage is a 64-deep
//   k chunk of the tile (3-D tensor map over a_tiles [B, t, t]: rows and
//   columns past t read as 0, so every t of the contract runs) and the
//   matching 64 source rows of the cast operand (3-D map over [tiles, t,
//   F_pad]: rows past the tile read as 0), both 128-byte swizzled. Tiles
//   load with an evict-first L2 policy, the operand with evict-last, so the
//   streamed tiles do not push the operand out of L2.
// - Two consumer warpgroups (one at t <= 64) run wgmma.mma_async
//   m64n64k16 (bf16 in, float32 accumulators in registers) on the stages
//   that have arrived: warpgroup g owns the 64-row slices g, g + 2 of the
//   tile; A is K-major from shared memory, B the operand rows as stored,
//   MN-major (the transpose bit). A stage's products stay in flight while
//   the warpgroup waits for the next stage; the one before goes back to
//   the producer. The epilogue converts to h's dtype and stores with masks
//   on the ragged edge.
// - A wait on a barrier that outlasts ~4 s of clock traps (a lost copy
//   fails the launch instead of hanging the card).
// Times below: device ms of one pass on the community graph (t = 128,
// F = 128, bf16 tiles, float32 h, the cast included), H100 80GB HBM3, 700 W,
// chip_smoke.py --trial / --against in turns. This design: ~0.93.
// Tried and lost: the first port, a grid of row tiles x 64-column
// slices with mma.sync m16n8k16 on 32-deep chunks staged synchronously and
// the operand read as scalar float32 loads per tile: 5.52, each tile read
// twice at F = 128. Row tiles in id order: 1.09 (against 1.01 in order of
// their tiles); each stage released only once its products are done: 1.01
// (against 0.93); one block an SM with 6 stages: 1.03 (against 1.01 with 2
// blocks of 3); the operand with the evict-normal L2 policy: 0.94, and no
// L2 policy on either copy: 1.03 (against 0.93); one m64n128k16 over two
// boxes (leading offset 8 KiB, the MN-atom stride; swapped with the stride
// offset the results are wrong): 0.93, no gain.
//
// float32 tiles (tiled_spmm_fma_kernel) stay on the FMA units, no TF32: a
// grid of row tiles x 64-column slices, 32-deep chunks in shared memory,
// each thread 16 rows x 4 columns.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace tfg;

constexpr int kMaxTile = 256;

// ---------------------------------------------------------------------------
// bf16 tiles: TMA ring into wgmma
// ---------------------------------------------------------------------------

constexpr int kKC = 64;             // k per stage: one 128-byte swizzled row of bf16
constexpr int kAtomN = 64;          // output columns per wgmma (m64n64k16)
constexpr int kSlice = 64;          // output rows per wgmma
constexpr int kBoxBytes = 64 * 64 * 2;       // one 64 x 64 bf16 box: 8 KiB
constexpr int kConsumerThreads = 256;        // two warpgroups at most
constexpr int kTmaThreads = kConsumerThreads + kWarp;  // and one producer warp
constexpr int kMaxStages = 6;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed; trap
// after ~4 s of clock (a copy that never lands fails the launch).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// One box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] += A[64 x 16] (K-major) * B[16 x 64] (MN-major), bf16 in, float32 out
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// SLICES 64-row slices per warpgroup, NA 64-column atoms per block. A stage
// holds the tile's k chunk ([m_slices * 64 rows][64 k], K-major) and NA
// operand boxes ([64 k][64 f] each, MN-major), 128-byte swizzled, each
// 1024-byte aligned.
template <typename OutT, int SLICES, int NA>
__global__ void __launch_bounds__(kTmaThreads, SLICES * NA <= 2 ? 2 : 1)
tiled_spmm_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap h_map, const int* __restrict__ order,
                      const int* __restrict__ row_ptr, const int* __restrict__ col_tile,
                      OutT* __restrict__ out, int t,
                      int num_out_rows, int F, int wgs, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int m_slices = (t + kSlice - 1) / kSlice;
  const int a_bytes = m_slices * kSlice * kKC * 2;
  const int stage_bytes = a_bytes + NA * kBoxBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int consumers = wgs * 128;
  const int rt = order[blockIdx.x];  // row tiles with the most tiles first
  const int f0 = blockIdx.y * NA * kAtomN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers / kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int begin = row_ptr[rt], end = row_ptr[rt + 1];
  const int kchunks = (t + kKC - 1) / kKC;
  const int steps = (end - begin) * kchunks;

  if (threadIdx.x >= consumers) {  // the producer warp: one lane issues the copies
    if (threadIdx.x == consumers) {
      const uint64_t evict_first = l2_policy_evict_first();
      const uint64_t evict_last = l2_policy_evict_last();
      int stage = 0, phase = 0, ct = 0;
      for (int i = 0; i < steps; ++i) {
        const int b = begin + i / kchunks, kc = (i % kchunks) * kKC;
        if (kc == 0) ct = col_tile[b];
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* sa = base + stage * stage_bytes;
        mbar_expect_tx(&full[stage], stage_bytes);
        tma_load_3d(sa, &a_map, &full[stage], kc, 0, b, evict_first);
#pragma unroll
        for (int a = 0; a < NA; ++a)
          tma_load_3d(sa + a_bytes + a * kBoxBytes, &h_map, &full[stage], f0 + a * kAtomN, kc,
                      ct, evict_last);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % kWarp, warp_in_wg = (threadIdx.x % 128) / kWarp;
  float acc[SLICES][NA][32];
#pragma unroll
  for (int si = 0; si < SLICES; ++si)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[si][a][q] = 0.f;

  int stage = 0, phase = 0, prev = -1;
  for (int i = 0; i < steps; ++i) {
    mbar_wait(&full[stage], phase);
    const uint32_t sa = smem_u32(base + stage * stage_bytes);
    const uint32_t sb = sa + a_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
#pragma unroll
      for (int si = 0; si < SLICES; ++si) {
        const int slice = wg + wgs * si;
        if (slice < m_slices) {  // uniform over the warpgroup
          // A: rows of 128 bytes, 8-row groups 1024 bytes apart; k16 = 32 bytes
          const uint64_t da = smem_desc(sa + slice * kSlice * 128 + kk * 32, 16, 1024);
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            // B: k rows of 128 bytes (64 columns), 8-row k groups 1024 bytes
            // apart; k16 = 2048 bytes
            const uint64_t db = smem_desc(sb + a * kBoxBytes + kk * 2048, 1024, 1024);
            wgmma_m64n64k16(acc[si][a], da, db);
          }
        }
      }
    }
    wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done,
    // so its buffers go back to the producer
    wgmma_wait_one();
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  wgmma_wait_all();
  // accumulator fragment of m64nN: warp w of the group holds rows 16 w ..;
  // value 4 j + q sits at row lane / 4 (+ 8 for q >= 2), column 8 j +
  // 2 (lane % 4) + (q & 1)
#pragma unroll
  for (int si = 0; si < SLICES; ++si) {
    const int slice = wg + wgs * si;
    if (slice >= m_slices) continue;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int j = 0; j < kAtomN / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = slice * kSlice + warp_in_wg * 16 + lane / 4 + (q >> 1) * 8;
          const long long row = static_cast<long long>(rt) * t + r;
          const int f = f0 + a * kAtomN + j * 8 + (lane % 4) * 2 + (q & 1);
          if (r < t && row < num_out_rows && f < F)
            out[row * F + f] = from_f32<OutT>(acc[si][a][j * 4 + q]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 tiles on the FMA units, no TF32: thread (ty, tx) of 16 x 16 keeps
// rows ty + 16 i (i < t / 16) and columns tx + 16 j (j < 4)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaCols = 64;  // output columns per block
constexpr int kFmaKC = 32;    // k rows staged per chunk

template <typename HT>
__global__ void __launch_bounds__(kFmaThreads)
tiled_spmm_fma_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col_tile,
                      const float* __restrict__ a, const HT* __restrict__ h,
                      HT* __restrict__ out, int t, int n_src, int num_out_rows, int F) {
  __shared__ __align__(16) float sA[kMaxTile][kFmaKC + 4];
  __shared__ __align__(16) float sH[kFmaKC][kFmaCols];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int rt = blockIdx.x;
  const int f0 = blockIdx.y * kFmaCols;
  const int rows_per_thread = t / 16;
  const long long tt = static_cast<long long>(t) * t;

  float acc[kMaxTile / 16][4];
#pragma unroll
  for (int i = 0; i < kMaxTile / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int begin = row_ptr[rt], end = row_ptr[rt + 1];
  for (int b = begin; b < end; ++b) {
    const float* ab = a + b * tt;
    const long long src0 = static_cast<long long>(col_tile[b]) * t;
    for (int kc0 = 0; kc0 < t; kc0 += kFmaKC) {
      __syncthreads();
      for (int v = tid; v < t * (kFmaKC / 4); v += kFmaThreads) {
        const int r = v / (kFmaKC / 4), c = (v % (kFmaKC / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kc0 + c < t) x = *reinterpret_cast<const float4*>(ab + r * t + kc0 + c);
        *reinterpret_cast<float4*>(&sA[r][c]) = x;
      }
      for (int e = tid; e < kFmaKC * kFmaCols; e += kFmaThreads) {
        const int k = e / kFmaCols, n = e % kFmaCols;
        const long long src = src0 + kc0 + k;
        float x = 0.f;
        if (kc0 + k < t && src < n_src && f0 + n < F) x = to_f32(h[src * F + f0 + n]);
        sH[k][n] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kFmaKC; ++k) {
        float hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = sH[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMaxTile / 16; ++i) {
          if (i < rows_per_thread) {
            const float av = sA[ty + 16 * i][k];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, hv[j], acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxTile / 16; ++i) {
    if (i >= rows_per_thread) continue;
    const long long row = static_cast<long long>(rt) * t + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (row < num_out_rows && f < F) out[row * F + f] = from_f32<HT>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda's), fetched through the runtime's entry-point
// query, so nothing links -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map (dims innermost first, byte strides of dims 1 and 2), boxes
// of box0 x box1 x 1, 128-byte swizzle, out-of-range elements read as 0.
bool encode_3d(CUtensorMap* map, const void* ptr, unsigned long long d0, unsigned long long d1,
               unsigned long long d2, unsigned long long s1, unsigned long long s2, int box0,
               int box1) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16-tile kernel for (out dtype, slices per warpgroup, atoms), or null.
const void* tma_kernel(int out_dtype, int slices, int atoms) {
#define TFG_TMA(T, S, A) reinterpret_cast<const void*>(&tiled_spmm_tma_kernel<T, S, A>)
#define TFG_TMA_ALL(T)                                                              \
  if (slices == 1 && atoms == 1) return TFG_TMA(T, 1, 1);                           \
  if (slices == 1 && atoms == 2) return TFG_TMA(T, 1, 2);                           \
  if (slices == 1 && atoms == 3) return TFG_TMA(T, 1, 3);                           \
  if (slices == 1 && atoms == 4) return TFG_TMA(T, 1, 4);                           \
  if (slices == 2 && atoms == 1) return TFG_TMA(T, 2, 1);                           \
  if (slices == 2 && atoms == 2) return TFG_TMA(T, 2, 2);                           \
  return nullptr;
  if (out_dtype == kFloat32) { TFG_TMA_ALL(float) }
  if (out_dtype == kBFloat16) { TFG_TMA_ALL(__nv_bfloat16) }
#undef TFG_TMA_ALL
#undef TFG_TMA
  return nullptr;
}

// Stages of the plan (ops/tiled_spmm.py mma_plan) that fit the block's
// shared memory; the same rule, checked here.
int tma_smem_bytes(int t, int atoms, int stages) {
  const int m_slices = (t + kSlice - 1) / kSlice;
  return 1024 + stages * (m_slices * kSlice * kKC * 2 + atoms * kBoxBytes) + 16 * stages;
}

template <typename HT>
int launch_fma(dim3 grid, cudaStream_t s, const int* rp, const int* ct, const float* a,
               const HT* h, HT* out, int t, int n_src, int num_out_rows, int F) {
  tiled_spmm_fma_kernel<HT><<<grid, kFmaThreads, 0, s>>>(rp, ct, a, h, out, t, n_src,
                                                         num_out_rows, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 tiles. order int32 [num_out_tiles] (the row tiles in launch order,
// a permutation), row_ptr int32 [num_out_tiles + 1], col_tile int32 [B], a bf16
// [B, t, t], hc bf16 [n_src_tiles * t, f_pad] (h cast by the caller, zero
// past its rows and columns), out [num_out_rows, F] of out_dtype (0 float32,
// 1 bfloat16), written in full. The plan (slices per warpgroup, atoms of 64
// columns, F chunks, warpgroups, stages) is the caller's, ops/tiled_spmm.py
// mma_plan; a plan this file has no kernel for, or whose shared memory does
// not fit, is refused.
extern "C" int tfg_tiled_spmm_tma(const void* order, const void* row_ptr, const void* col_tile,
                                  const void* a,
                                  int num_tiles, const void* hc, int n_src_tiles, int f_pad,
                                  void* out, int out_dtype, int num_out_tiles, int t,
                                  int num_out_rows, int F, int slices, int atoms, int chunks,
                                  int wgs, int stages, void* stream) {
  if (t % 16 != 0 || t <= 0 || t > kMaxTile || f_pad % 8 != 0 || f_pad < F || wgs < 1 ||
      wgs > kConsumerThreads / 128 || stages < 2 || stages > kMaxStages ||
      wgs * slices * kSlice < t || chunks * atoms * kAtomN < F)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_out_tiles <= 0 || F <= 0 || num_out_rows <= 0) return static_cast<int>(cudaSuccess);
  const void* kernel = tma_kernel(out_dtype, slices, atoms);
  const int smem = tma_smem_bytes(t, atoms, stages);
  if (kernel == nullptr || smem > max_smem_optin())
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map{}, h_map{};
  const int m_slices = (t + kSlice - 1) / kSlice;
  // a_tiles [B][t][t]: dims (k, row, tile); boxes of 64 k x the slices' rows
  if (num_tiles > 0 &&
      !encode_3d(&a_map, a, t, t, num_tiles, 2ull * t, 2ull * t * t, kKC, m_slices * kSlice))
    return static_cast<int>(cudaErrorInvalidValue);
  // hc [n_src_tiles][t][f_pad]: dims (f, k, tile); boxes of 64 f x 64 k
  if (n_src_tiles > 0 && !encode_3d(&h_map, hc, f_pad, t, n_src_tiles, 2ull * f_pad,
                                    2ull * f_pad * t, kAtomN, kKC))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int* od = static_cast<const int*>(order);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ct = static_cast<const int*>(col_tile);
  void* args[] = {&a_map, &h_map, const_cast<int**>(&od), const_cast<int**>(&rp),
                  const_cast<int**>(&ct), &out, &t, &num_out_rows, &F, &wgs, &stages};
  const dim3 grid(static_cast<unsigned>(num_out_tiles), static_cast<unsigned>(chunks));
  const dim3 block(static_cast<unsigned>(wgs * 128 + kWarp));
  const cudaError_t e = cudaLaunchKernel(kernel, grid, block, args, static_cast<size_t>(smem),
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static shared memory and resident blocks per SM of the
// bf16-tile kernel a plan launches (a launch's threads and dynamic shared
// memory); returns a cudaError code.
extern "C" int tfg_tiled_spmm_tma_info(int out_dtype, int slices, int atoms, int t, int wgs,
                                       int stages, int* registers, int* static_smem,
                                       int* blocks_per_sm) {
  const void* kernel = tma_kernel(out_dtype, slices, atoms);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tma_smem_bytes(t, atoms, stages);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, wgs * 128 + kWarp,
                                                      static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// float32 tiles. row_ptr int32 [num_out_tiles + 1], col_tile int32 [B], a
// float32 [B, t, t], h [n_src, F] (h_dtype), out [num_out_rows, F] (h_dtype),
// written in full.
extern "C" int tfg_tiled_spmm_fma(const void* row_ptr, const void* col_tile, const void* a,
                                  const void* h, int h_dtype, void* out, int num_out_tiles, int t,
                                  int n_src, int num_out_rows, int F, void* stream) {
  if (t % 16 != 0 || t <= 0 || t > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  if (num_out_tiles <= 0 || F <= 0 || num_out_rows <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(num_out_tiles),
                  static_cast<unsigned>((F + kFmaCols - 1) / kFmaCols));
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto ct = static_cast<const int*>(col_tile);
  auto af = static_cast<const float*>(a);
  if (h_dtype == kFloat32)
    return launch_fma<float>(grid, s, rp, ct, af, static_cast<const float*>(h),
                             static_cast<float*>(out), t, n_src, num_out_rows, F);
  if (h_dtype == kBFloat16)
    return launch_fma<__nv_bfloat16>(grid, s, rp, ct, af, static_cast<const __nv_bfloat16*>(h),
                                     static_cast<__nv_bfloat16*>(out), t, n_src, num_out_rows, F);
  return static_cast<int>(cudaErrorInvalidValue);
}
