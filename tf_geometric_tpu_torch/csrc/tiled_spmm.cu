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
// A row tile with no tile writes exact zeros.
//
// Bound on the H100: bytes. A pass must read the tiles (B * t^2 elements),
// the operand rows they name and write the output once; its 2 * B * t^2 * F
// flops need ~0.25 ms at the bf16 tensor-core rate where the tiles alone
// need ~0.6 ms of memory time on the community arxiv graph (t = 128, F = 128).
//
// Design: the XLA pass gathers [B, t, F] operand tiles to memory, contracts,
// then segment-sums the partials. Here one block owns one output row tile
// and one 64-column slice of F (grid = row tiles x F slices); it walks its
// row tile's sorted tiles through the row pointers, stages a KC-deep chunk
// of the A tile and the matching operand rows in shared memory, and keeps
// the [t, 64] sum in float32 registers. Nothing is written but the output,
// and with no atomics the result is the same bit for bit from run to run.
// bf16 tiles run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate): each of the 8 warps owns up to two 16-row slices of the
// tile. float32 tiles run a SIMT FMA loop (no TF32), each thread 16 rows x 4
// columns. t must be a multiple of 16 and at most 256; a chunk past the
// tile's edge is zero-filled. wgmma, TMA and a persistent grid are left for
// later work.
#include "common.cuh"

namespace {

using namespace tfg;

constexpr int kThreads = 256;  // 8 warps
constexpr int kCols = 64;      // output columns per block
constexpr int kKC = 32;        // k rows staged per chunk
constexpr int kPad = 8;        // shared-memory row padding (bank spread)
constexpr int kMaxTile = 256;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 tiles on the tensor cores. Shared memory per chunk: sA[t][KC] (the
// tile's rows, k contiguous: the row-major A fragment) and sB[64][KC] (the
// operand chunk transposed, k contiguous: the column-major B fragment).
template <typename HT>
__global__ void __launch_bounds__(kThreads)
tiled_spmm_mma_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col_tile,
                      const __nv_bfloat16* __restrict__ a, const HT* __restrict__ h,
                      HT* __restrict__ out, int t, int n_src, int num_out_rows, int F) {
  __shared__ __align__(16) __nv_bfloat16 sA[kMaxTile][kKC + kPad];
  __shared__ __align__(16) __nv_bfloat16 sB[kCols][kKC + kPad];
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int group = lane >> 2, tig = lane & 3;
  const int rt = blockIdx.x;
  const int f0 = blockIdx.y * kCols;
  const int mtiles = t / 16;
  const long long tt = static_cast<long long>(t) * t;

  float acc[2][kCols / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kCols / 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int begin = row_ptr[rt], end = row_ptr[rt + 1];
  for (int b = begin; b < end; ++b) {
    const __nv_bfloat16* ab = a + b * tt;
    const long long src0 = static_cast<long long>(col_tile[b]) * t;
    for (int kc0 = 0; kc0 < t; kc0 += kKC) {
      __syncthreads();
      // A chunk: t rows of KC bf16, 16-byte vectors of 8
      for (int v = tid; v < t * (kKC / 8); v += kThreads) {
        const int r = v / (kKC / 8), c = (v % (kKC / 8)) * 8;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (kc0 + c < t) x = *reinterpret_cast<const uint4*>(ab + r * t + kc0 + c);
        *reinterpret_cast<uint4*>(&sA[r][c]) = x;
      }
      // operand chunk: KC source rows x 64 columns, rounded to bf16
      for (int e = tid; e < kKC * kCols; e += kThreads) {
        const int k = e / kCols, n = e % kCols;
        const long long src = src0 + kc0 + k;
        __nv_bfloat16 x = __float2bfloat16(0.f);
        if (kc0 + k < t && src < n_src && f0 + n < F) x = to_bf16(h[src * F + f0 + n]);
        sB[n][k] = x;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        unsigned bf[kCols / 8][2];
#pragma unroll
        for (int ni = 0; ni < kCols / 8; ++ni) {
          const __nv_bfloat16* p = &sB[ni * 8 + group][ks + tig * 2];
          bf[ni][0] = *reinterpret_cast<const unsigned*>(p);
          bf[ni][1] = *reinterpret_cast<const unsigned*>(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int m = warp + mi * (kThreads / kWarp);
          if (m >= mtiles) continue;  // warp-uniform
          const __nv_bfloat16* p0 = &sA[m * 16 + group][ks + tig * 2];
          const __nv_bfloat16* p1 = &sA[m * 16 + group + 8][ks + tig * 2];
          unsigned af[4];
          af[0] = *reinterpret_cast<const unsigned*>(p0);
          af[1] = *reinterpret_cast<const unsigned*>(p1);
          af[2] = *reinterpret_cast<const unsigned*>(p0 + 8);
          af[3] = *reinterpret_cast<const unsigned*>(p1 + 8);
#pragma unroll
          for (int ni = 0; ni < kCols / 8; ++ni) mma_bf16(acc[mi][ni], af, bf[ni]);
        }
      }
    }
  }

  // C fragment: c0, c1 at (group, 2 tig + {0, 1}); c2, c3 eight rows lower
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = warp + mi * (kThreads / kWarp);
    if (m >= mtiles) continue;
#pragma unroll
    for (int ni = 0; ni < kCols / 8; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long row = static_cast<long long>(rt) * t + m * 16 + group + (q >> 1) * 8;
        const int f = f0 + ni * 8 + tig * 2 + (q & 1);
        if (row < num_out_rows && f < F) out[row * F + f] = from_f32<HT>(acc[mi][ni][q]);
      }
    }
  }
}

// float32 tiles on the FMA units, no TF32: thread (ty, tx) of 16 x 16 keeps
// rows ty + 16 i (i < t / 16) and columns tx + 16 j (j < 4).
template <typename HT>
__global__ void __launch_bounds__(kThreads)
tiled_spmm_fma_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col_tile,
                      const float* __restrict__ a, const HT* __restrict__ h,
                      HT* __restrict__ out, int t, int n_src, int num_out_rows, int F) {
  __shared__ __align__(16) float sA[kMaxTile][kKC + 4];
  __shared__ __align__(16) float sH[kKC][kCols];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int rt = blockIdx.x;
  const int f0 = blockIdx.y * kCols;
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
    for (int kc0 = 0; kc0 < t; kc0 += kKC) {
      __syncthreads();
      for (int v = tid; v < t * (kKC / 4); v += kThreads) {
        const int r = v / (kKC / 4), c = (v % (kKC / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kc0 + c < t) x = *reinterpret_cast<const float4*>(ab + r * t + kc0 + c);
        *reinterpret_cast<float4*>(&sA[r][c]) = x;
      }
      for (int e = tid; e < kKC * kCols; e += kThreads) {
        const int k = e / kCols, n = e % kCols;
        const long long src = src0 + kc0 + k;
        float x = 0.f;
        if (kc0 + k < t && src < n_src && f0 + n < F) x = to_f32(h[src * F + f0 + n]);
        sH[k][n] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
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

template <typename HT>
int launch(int a_dtype, dim3 grid, cudaStream_t s, const int* rp, const int* ct,
           const void* a, const HT* h, HT* out, int t, int n_src, int num_out_rows, int F) {
  if (a_dtype == kBFloat16) {
    tiled_spmm_mma_kernel<HT><<<grid, kThreads, 0, s>>>(
        rp, ct, static_cast<const __nv_bfloat16*>(a), h, out, t, n_src, num_out_rows, F);
  } else if (a_dtype == kFloat32) {
    tiled_spmm_fma_kernel<HT><<<grid, kThreads, 0, s>>>(
        rp, ct, static_cast<const float*>(a), h, out, t, n_src, num_out_rows, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ptr int32 [num_out_tiles + 1], col_tile int32 [B], a [B, t, t] (a_dtype),
// h [n_src, F] (h_dtype), out [num_out_rows, F] (h_dtype), written in full.
extern "C" int tfg_tiled_spmm(const void* row_ptr, const void* col_tile, const void* a,
                              int a_dtype, const void* h, int h_dtype, void* out,
                              int num_out_tiles, int t, int n_src, int num_out_rows, int F,
                              void* stream) {
  if (t % 16 != 0 || t <= 0 || t > kMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  if (num_out_tiles <= 0 || F <= 0 || num_out_rows <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(num_out_tiles),
                  static_cast<unsigned>((F + kCols - 1) / kCols));
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto ct = static_cast<const int*>(col_tile);
  if (h_dtype == kFloat32) {
    return launch<float>(a_dtype, grid, s, rp, ct, a, static_cast<const float*>(h),
                         static_cast<float*>(out), t, n_src, num_out_rows, F);
  }
  if (h_dtype == kBFloat16) {
    return launch<__nv_bfloat16>(a_dtype, grid, s, rp, ct, a,
                                 static_cast<const __nv_bfloat16*>(h),
                                 static_cast<__nv_bfloat16*>(out), t, n_src, num_out_rows, F);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
