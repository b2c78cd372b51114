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
// A hub row (in-degree above the split width, ops/csr_spmm.py SPLIT_WIDTH)
// owns no edges of its own: its edges sit in its virtual rows, and Kernel B
// (sorted_segment.cu) adds their partials into out afterwards. Accumulation
// is float32, each row's edges in their stored order, then the diagonal; out
// has h's dtype, partial is float32.
//
// Bound on the H100: bytes. Each edge moves 8 bytes of index and value and
// gathers one row of h (F * 4 or F * 2 bytes) for 2 * F flops, far below
// the ~20 flops per byte where float32 FMA throughput would bind. The least
// traffic is h, out, row_ptr, col and val once each; the gathers read a row
// of h once per edge, which the 50 MB L2 absorbs only while h fits in it.
//
// Design. A row costs latency more than bandwidth: its edges are few (6.9
// on average on the arxiv graph) and each gather waits for the index load
// before it. So:
// - A group of L lanes owns one row (L = the next power of two of the row's
//   lane vectors, at most 32), so several narrow rows share a warp and an
//   empty row costs a lane group, not a warp. Each lane loads vectors of VEC
//   elements, up to 16 bytes (a 512-byte bf16 row at F = 256 is one load
//   instruction per warp), and rows wider than L * NV vectors take several
//   passes.
// - The group's lanes read L of the row's indices and values at once,
//   coalesced, and broadcast them by shuffle; U edges' rows are loaded before
//   any is added, so U gathers per lane are in flight.
// - No group walks more than SPLIT_WIDTH (64) edges: longer rows are virtual
//   rows of at most 64 edges each, and their groups come first in the grid
//   (the ordinary rows' groups follow), so the blocks that hold the longest
//   walks start first and overlap the rest.
// No atomics: the sums run in a fixed order, so two runs give the same bits.
#include "common.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;

template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const T* __restrict__ h,
                const float* __restrict__ diag, T* __restrict__ out,
                float* __restrict__ partial, int num_rows, int num_virtual, int F,
                int lanes_log2) {
  const int L = 1 << lanes_log2;
  const int lig = threadIdx.x & (L - 1);
  const long long g =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> lanes_log2;
  const long long total = static_cast<long long>(num_rows) + num_virtual;
  // lanes of a missing row still join the shuffles
  const bool valid = g < total;
  const long long r = !valid ? 0 : g < num_virtual ? num_rows + g : g - num_virtual;
  int start = 0, count = 0;
  if (valid) {
    start = row_ptr[r];
    count = row_ptr[r + 1] - start;
  }
  const int most = __reduce_max_sync(kFull, count);  // the warp's loop bound
  const int nvec = F / VEC;
  for (int v0 = 0; v0 < nvec; v0 += L * NV) {
    float acc[NV * VEC];
#pragma unroll
    for (int i = 0; i < NV * VEC; ++i) acc[i] = 0.f;
    for (int base = 0; base < most; base += L) {
      // lane lig holds edge base + lig's column and value
      int c_lane = 0;
      float w_lane = 0.f;
      if (base + lig < count) {
        c_lane = col[start + base + lig];
        w_lane = val[start + base + lig];
      }
      const int batch = min(L, most - base);
      for (int j0 = 0; j0 < batch; j0 += U) {
        RawT<T, VEC> raw[U][NV];
        float wu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = __shfl_sync(kFull, c_lane, (j0 + u) & (L - 1), L);
          const float wt = __shfl_sync(kFull, w_lane, (j0 + u) & (L - 1), L);
          const bool ok = j0 + u < batch && base + j0 + u < count;
          wu[u] = ok ? wt : 0.f;
          const T* row = h + static_cast<size_t>(c) * F;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int v = v0 + q * L + lig;
            raw[u][q] = (ok && v < nvec)
                            ? *reinterpret_cast<const RawT<T, VEC>*>(row + v * VEC)
                            : RawT<T, VEC>{};
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            float x[VEC];
            unpack<T, VEC>(raw[u][q], x);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[q * VEC + i] += wu[u] * x[i];
          }
        }
      }
    }
    if (!valid) continue;
    if (r < num_rows) {
      const T* hr = h + static_cast<size_t>(r) * F;
      T* orow = out + static_cast<size_t>(r) * F;
      const float d = diag != nullptr ? diag[r] : 0.f;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int v = v0 + q * L + lig;
        if (v >= nvec) continue;
        if (diag != nullptr) {
          float x[VEC];
          unpack<T, VEC>(*reinterpret_cast<const RawT<T, VEC>*>(hr + v * VEC), x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[q * VEC + i] += d * x[i];
        }
        store_vec<T, VEC>(orow + v * VEC, acc + q * VEC);
      }
    } else {
      float* prow = partial + static_cast<size_t>(r - num_rows) * F;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int v = v0 + q * L + lig;
        if (v < nvec) store_vec<float, VEC>(prow + v * VEC, acc + q * VEC);
      }
    }
  }
}

// in-flight gathers per lane for NV vectors per lane
constexpr int unroll_for(int nv) { return nv == 1 ? 8 : nv == 2 ? 4 : 2; }

template <typename T, int VEC>
void launch_nv(int nv, unsigned grid, cudaStream_t st, const int* row_ptr, const int* col,
               const float* val, const T* h, const float* diag, T* out, float* partial,
               int num_rows, int num_virtual, int F, int ll) {
  if (nv == 1)
    csr_spmm_kernel<T, VEC, 1, unroll_for(1)><<<grid, kBlock, 0, st>>>(
        row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F, ll);
  else if (nv == 2)
    csr_spmm_kernel<T, VEC, 2, unroll_for(2)><<<grid, kBlock, 0, st>>>(
        row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F, ll);
  else
    csr_spmm_kernel<T, VEC, 4, unroll_for(4)><<<grid, kBlock, 0, st>>>(
        row_ptr, col, val, h, diag, out, partial, num_rows, num_virtual, F, ll);
}

template <typename T>
void launch_vec(int vec, int nv, unsigned grid, cudaStream_t st, const int* row_ptr,
                const int* col, const float* val, const void* h, const float* diag, void* out,
                float* partial, int num_rows, int num_virtual, int F, int ll) {
  auto hh = static_cast<const T*>(h);
  auto o = static_cast<T*>(out);
  switch (vec) {
    case 1: launch_nv<T, 1>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, num_rows, num_virtual, F, ll); break;
    case 2: launch_nv<T, 2>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, num_rows, num_virtual, F, ll); break;
    case 4: launch_nv<T, 4>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, num_rows, num_virtual, F, ll); break;
    default:
      if constexpr (sizeof(T) == 2)
        launch_nv<T, 8>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, num_rows, num_virtual, F, ll);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). diag may be
// null; partial may be null when num_virtual == 0. vec: elements per lane
// vector, a power of two dividing F, at most 16 bytes of h's dtype, with h,
// out and partial aligned to it.
extern "C" int tfg_csr_spmm(const void* row_ptr, const void* col, const void* val,
                            const void* h, int dtype, const void* diag, void* out,
                            void* partial, int num_rows, int num_virtual, int F, int vec,
                            void* stream) {
  const long long rows = static_cast<long long>(num_rows) + num_virtual;
  const int max_vec = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 8 : 0;
  if (num_rows < 0 || num_virtual < 0 || F < 0 || vec <= 0 || vec > max_vec ||
      (vec & (vec - 1)) || (F > 0 && F % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || F == 0) return static_cast<int>(cudaSuccess);
  const int nvec = F / vec;
  const int ll = pick_lanes_log2(nvec);
  const int nv = pick_nv(nvec, 1 << ll);
  const unsigned grid = grid_for_groups(rows, ll);
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int*>(row_ptr);
  auto c = static_cast<const int*>(col);
  auto v = static_cast<const float*>(val);
  auto d = static_cast<const float*>(diag);
  auto p = static_cast<float*>(partial);
  if (dtype == kFloat32)
    launch_vec<float>(vec, nv, grid, s, rp, c, v, h, d, out, p, num_rows, num_virtual, F, ll);
  else
    launch_vec<__nv_bfloat16>(vec, nv, grid, s, rp, c, v, h, d, out, p, num_rows, num_virtual,
                              F, ll);
  return static_cast<int>(cudaGetLastError());
}
