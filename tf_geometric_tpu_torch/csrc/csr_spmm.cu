// Kernel A: CSR SpMM with a split-off diagonal and split hub rows.
//
// Replaces: tf_geometric_tpu/ops/ell_bucketed.py, bucketed_spmm (its
// _side_matmul, run forward on the fwd side and, in the VJP, on the
// transposed side).
//
// Contract, over R ordinary rows followed by Nv virtual rows (row_ptr has
// R + Nv + 1 entries):
//   out[r]     = diag[r] * h[r] + sum_{e in row r} val[e] * h[col[e]]   r < R
//   partial[v] =                  sum_{e in row R + v} val[e] * h[col[e]]
// A hub row (in-degree above the split width) owns no edges of its own: its
// edges sit in its virtual rows, and Kernel B (sorted_segment.cu) adds their
// partials into out afterwards. Accumulation is float32; out has h's dtype,
// partial is float32.
//
// Bound on the H100: bytes. Each edge moves 8 bytes of index and value and
// gathers one row of h (F * 4 or F * 2 bytes) for 2 * F flops, far below
// the ~20 flops per byte where float32 FMA throughput would bind. The least
// traffic is h, out, row_ptr, col and val once each.
//
// Design: one warp per row; col and val are read once per edge, coalesced 32
// at a time, and broadcast by shuffle; lanes stride the features, so each
// gathered row of h is read as contiguous 32-element runs. Splitting hubs
// into rows of at most 256 edges keeps one warp from walking a 2,838-edge
// row while the rest of the grid idles. No atomics: the result does not
// depend on scheduling.
#include "common.cuh"

namespace {

using namespace tfg;

template <typename T, int NK>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const T* __restrict__ h,
                const float* __restrict__ diag, T* __restrict__ out,
                float* __restrict__ partial, int num_rows, int num_virtual, int F) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (r >= static_cast<long long>(num_rows) + num_virtual) return;  // warp-uniform
  const int start = row_ptr[r];
  const int end = row_ptr[r + 1];

  for (int f0 = 0; f0 < F; f0 += kWarp * NK) {
    float acc[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[k] = 0.f;

    for (int base = start; base < end; base += kWarp) {
      int c = 0;
      float v = 0.f;
      if (base + lane < end) {
        c = col[base + lane];
        v = val[base + lane];
      }
      const int n = min(kWarp, end - base);  // warp-uniform
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(0xffffffffu, c, j);
        const float vj = __shfl_sync(0xffffffffu, v, j);
        const T* hrow = h + static_cast<size_t>(cj) * F;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int f = f0 + k * kWarp + lane;
          if (f < F) acc[k] += vj * to_f32(hrow[f]);
        }
      }
    }

    if (r < num_rows) {
      const float d = diag != nullptr ? diag[r] : 0.f;
      const T* hr = h + static_cast<size_t>(r) * F;
      T* o = out + static_cast<size_t>(r) * F;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int f = f0 + k * kWarp + lane;
        if (f < F) {
          float x = acc[k];
          if (diag != nullptr) x += d * to_f32(hr[f]);
          o[f] = from_f32<T>(x);
        }
      }
    } else {
      float* p = partial + static_cast<size_t>(r - num_rows) * F;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int f = f0 + k * kWarp + lane;
        if (f < F) p[f] = acc[k];
      }
    }
  }
}

template <typename T>
void launch(int nk, unsigned grid, cudaStream_t stream, const int* row_ptr,
            const int* col, const float* val, const T* h, const float* diag,
            T* out, float* partial, int num_rows, int num_virtual, int F) {
  const dim3 block(kWarp * kWarpsPerBlock);
  switch (nk) {
    case 1:
      csr_spmm_kernel<T, 1><<<grid, block, 0, stream>>>(
          row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F);
      break;
    case 2:
      csr_spmm_kernel<T, 2><<<grid, block, 0, stream>>>(
          row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F);
      break;
    case 4:
      csr_spmm_kernel<T, 4><<<grid, block, 0, stream>>>(
          row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F);
      break;
    default:
      csr_spmm_kernel<T, kMaxNK><<<grid, block, 0, stream>>>(
          row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F);
      break;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). diag may be
// null; partial may be null when num_virtual == 0.
extern "C" int tfg_csr_spmm(const void* row_ptr, const void* col, const void* val,
                            const void* h, int dtype, const void* diag, void* out,
                            void* partial, int num_rows, int num_virtual, int F,
                            void* stream) {
  const long long rows = static_cast<long long>(num_rows) + num_virtual;
  if (rows <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for_rows(rows);
  const int nk = pick_nk(F);
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto c = static_cast<const int*>(col);
  auto v = static_cast<const float*>(val);
  auto d = static_cast<const float*>(diag);
  auto p = static_cast<float*>(partial);
  if (dtype == kFloat32) {
    launch<float>(nk, grid, s, rp, c, v, static_cast<const float*>(h), d,
                  static_cast<float*>(out), p, num_rows, num_virtual, F);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(nk, grid, s, rp, c, v, static_cast<const __nv_bfloat16*>(h),
                          d, static_cast<__nv_bfloat16*>(out), p, num_rows,
                          num_virtual, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
