// Kernel A: CSR SpMM with a split-off diagonal and split hub rows, and the
// hub merge in its epilogue.
//
// Replaces: tf_geometric_tpu/ops/ell_bucketed.py, bucketed_spmm (its
// _side_matmul, run forward on the fwd side and, in the VJP, on the
// transposed side), and on this path the sorted segment sum that merges the
// hub partials (tf_geometric_tpu/ops/pallas_segment.py,
// pallas_sorted_segment_sum).
//
// Contract, over R ordinary rows followed by Nv virtual rows (row_ptr has
// R + Nv + 1 entries):
//   out[r]     = diag[r] * h[r] + sum_{e in row r} val[e] * h[col[e]]   r < R
//   partial[v] =                  sum_{e in row R + v} val[e] * h[col[e]]
// A hub row (in-degree above the split width, ops/csr_spmm.py SPLIT_WIDTH)
// owns no edges of its own: its edges sit in its virtual rows
// owner_ptr[i] .. owner_ptr[i + 1] (hub i is row owner_rows[i]).
// Accumulation is float32, each row's edges in their stored order, then the
// diagonal; out has h's dtype, partial is float32.
// - With tickets null, a hub row gets diag * h like any edgeless row, and
//   Kernel B (sorted_segment.cu) adds the partials into it afterwards.
// - With tickets (int32 [H], all 0 before the launch, all 0 after it), the
//   launch merges the hubs itself:
//     out[hub] = S + (0 + diag[hub] * h[hub]),  S = ((0 + p_0) + p_1) + ...
//   over the hub's partials in virtual-row order, each step rounded once
//   (no contraction into an FMA): in float32 the bits of the two launches,
//   in bf16 one rounding where the two launches round twice. The owner's
//   own group writes nothing; out[hub] has one writer.
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
// - The hub merge costs no second launch: a virtual row's group stores its
//   partial, fences, and takes a ticket of its hub; the group that takes a
//   hub's last ticket reads the hub's partials from L2 (past L1, which may
//   hold stale lines) with several rows' loads in flight, and writes the hub
//   row. Hubs' groups come first, so their merges overlap ordinary rows.
// No float atomics: the sums run in a fixed order, so two runs give the
// same bits (which group merges a hub changes, the sum it computes does
// not).
#include "common.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;
// Partial values a lane of the merge keeps in flight (rows of VEC each):
// as many as fit beside the main loop without raising the kernel's
// registers at the main path's widths, whose count sets the blocks an SM
// holds (ptxas on the H100 machine: 32 registers at F = 40 float32 with 8,
// 48 with 16; 48 at F = 256 bf16 with 16, as without the merge). The
// merge's loops are not unrolled further.
template <typename T>
constexpr int kMergeFloats = sizeof(T) == 2 ? 16 : 8;

// x[0 .. VEC) = the VEC float32 values at p, read from L2 (ld.global.cg):
// rows other blocks wrote during this launch. volatile with a memory
// clobber, so no load moves above the ticket that makes the rows complete.
template <int VEC>
__device__ __forceinline__ void load_f32_l2(const float* p, float* x) {
  if constexpr (VEC == 1) {
    asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(x[0]) : "l"(p) : "memory");
  } else if constexpr (VEC == 2) {
    asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];"
                 : "=f"(x[0]), "=f"(x[1]) : "l"(p) : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]) : "l"(p) : "memory");
  } else {
    load_f32_l2<VEC / 2>(p, x);
    load_f32_l2<VEC / 2>(p + VEC / 2, x + VEC / 2);
  }
}

// is row r one of the n sorted hub rows?
__device__ __forceinline__ bool is_hub_row(const int* owner_rows, int n, long long r) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (owner_rows[mid] < r) lo = mid + 1; else hi = mid;
  }
  return lo < n && owner_rows[lo] == r;
}

// the hub that owns virtual row v: owner_ptr[i] <= v < owner_ptr[i + 1]
__device__ __forceinline__ int hub_of(const int* owner_ptr, int n, int v) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (owner_ptr[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The merge of one hub: out[row] = S + (0 + diag[row] * h[row]) over the
// partials first .. last - 1, S summed in their order; each lane of the
// group takes every L-th lane vector.
template <typename T, int VEC>
__device__ __forceinline__ void merge_hub(const T* __restrict__ h, const float* __restrict__ diag,
                                          T* __restrict__ out, const float* partial,
                                          long long row, int first, int last, int F, int nvec,
                                          int lig, int L) {
  const T* hr = h + static_cast<size_t>(row) * F;
  T* orow = out + static_cast<size_t>(row) * F;
  const float d = diag != nullptr ? diag[row] : 0.f;
  constexpr int R = kMergeFloats<T> / VEC;
#pragma unroll 1
  for (int v = lig; v < nvec; v += L) {
    float s[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int i0 = first; i0 < last; i0 += R) {
      float x[R][VEC];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (i0 + u < last)
          load_f32_l2<VEC>(partial + static_cast<size_t>(i0 + u) * F + v * VEC, x[u]);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (i0 + u < last) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) s[i] = __fadd_rn(s[i], x[u][i]);
        }
      }
    }
    float own[VEC];
    if (diag != nullptr) {
      unpack<T, VEC>(*reinterpret_cast<const RawT<T, VEC>*>(hr + v * VEC), own);
#pragma unroll
      for (int i = 0; i < VEC; ++i) own[i] = __fadd_rn(0.f, __fmul_rn(d, own[i]));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) own[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = __fadd_rn(s[i], own[i]);
    store_vec<T, VEC>(orow + v * VEC, s);
  }
}

// MERGE: the launch merges the hubs (tickets non-null). Without it the
// kernel is the plain SpMM, so a side without hubs pays nothing for them.
template <typename T, int VEC, int NV, int U, bool MERGE>
__global__ void __launch_bounds__(kBlock)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ val, const T* __restrict__ h,
                const float* __restrict__ diag, T* __restrict__ out,
                float* __restrict__ partial, const int* __restrict__ owner_rows,
                const int* __restrict__ owner_ptr, int* __restrict__ tickets, int num_hubs,
                int num_rows, int num_virtual, int F, int lanes_log2) {
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
      // with the merge, a hub row is written by the group that merges it
      // (only edgeless rows look)
      if (MERGE && count == 0 && is_hub_row(owner_rows, num_hubs, r)) continue;
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
  if (!MERGE || !valid || r < num_rows) return;  // group-uniform

  // the hub merge: the group that stores its hub's last partial merges it;
  // the lanes of this row's group (other groups of the warp may be elsewhere)
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned group = L == kWarp ? kFull : ((1u << L) - 1) << (lane & ~(L - 1));
  const int hub = hub_of(owner_ptr, num_hubs, static_cast<int>(r - num_rows));
  const int first = owner_ptr[hub], last = owner_ptr[hub + 1];
  __threadfence();  // this lane's partial is visible on the device ...
  __syncwarp(group);  // ... for every lane of the group, before the ticket
  int ticket = 0;
  if (lig == 0) ticket = atomicAdd(tickets + hub, 1);
  ticket = __shfl_sync(group, ticket, 0, L);
  if (ticket != last - first - 1) return;
  if (lig == 0) tickets[hub] = 0;  // ready for the next launch
  __threadfence();
  merge_hub<T, VEC>(h, diag, out, partial, owner_rows[hub], first, last, F, nvec, lig, L);
}

struct Hubs {
  const int* owner_rows;
  const int* owner_ptr;
  int* tickets;  // null: no merge
  int count;
};

// in-flight gathers per lane for NV vectors per lane
constexpr int unroll_for(int nv) { return nv == 1 ? 8 : nv == 2 ? 4 : 2; }

template <typename T, int VEC, int NV>
void launch_merge(unsigned grid, cudaStream_t st, const int* row_ptr, const int* col,
                  const float* val, const T* h, const float* diag, T* out, float* partial,
                  const Hubs& hubs, int num_rows, int num_virtual, int F, int ll) {
  if (hubs.tickets != nullptr)
    csr_spmm_kernel<T, VEC, NV, unroll_for(NV), true><<<grid, kBlock, 0, st>>>(
        row_ptr, col, val, h, diag, out, partial, hubs.owner_rows, hubs.owner_ptr,
        hubs.tickets, hubs.count, num_rows, num_virtual, F, ll);
  else
    csr_spmm_kernel<T, VEC, NV, unroll_for(NV), false><<<grid, kBlock, 0, st>>>(
        row_ptr, col, val, h, diag, out, partial, nullptr, nullptr, nullptr, 0, num_rows,
        num_virtual, F, ll);
}

template <typename T, int VEC>
void launch_nv(int nv, unsigned grid, cudaStream_t st, const int* row_ptr, const int* col,
               const float* val, const T* h, const float* diag, T* out, float* partial,
               const Hubs& hubs, int num_rows, int num_virtual, int F, int ll) {
  if (nv == 1)
    launch_merge<T, VEC, 1>(grid, st, row_ptr, col, val, h, diag, out, partial, hubs, num_rows,
                            num_virtual, F, ll);
  else if (nv == 2)
    launch_merge<T, VEC, 2>(grid, st, row_ptr, col, val, h, diag, out, partial, hubs, num_rows,
                            num_virtual, F, ll);
  else
    launch_merge<T, VEC, 4>(grid, st, row_ptr, col, val, h, diag, out, partial, hubs, num_rows,
                            num_virtual, F, ll);
}

template <typename T>
void launch_vec(int vec, int nv, unsigned grid, cudaStream_t st, const int* row_ptr,
                const int* col, const float* val, const void* h, const float* diag, void* out,
                float* partial, const Hubs& hubs, int num_rows, int num_virtual, int F,
                int ll) {
  auto hh = static_cast<const T*>(h);
  auto o = static_cast<T*>(out);
  switch (vec) {
    case 1: launch_nv<T, 1>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, hubs, num_rows, num_virtual, F, ll); break;
    case 2: launch_nv<T, 2>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, hubs, num_rows, num_virtual, F, ll); break;
    case 4: launch_nv<T, 4>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, hubs, num_rows, num_virtual, F, ll); break;
    default:
      if constexpr (sizeof(T) == 2)
        launch_nv<T, 8>(nv, grid, st, row_ptr, col, val, hh, diag, o, partial, hubs, num_rows, num_virtual, F, ll);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). diag may be
// null; partial may be null when num_virtual == 0. vec: elements per lane
// vector, a power of two dividing F, at most 16 bytes of h's dtype, with h,
// out and partial aligned to it. tickets null: no merge (owner_rows,
// owner_ptr and num_hubs unread); otherwise owner_rows [num_hubs] (sorted),
// owner_ptr [num_hubs + 1] and tickets [num_hubs] (all 0) describe every
// virtual row, and no other launch may use the same tickets meanwhile.
extern "C" int tfg_csr_spmm(const void* row_ptr, const void* col, const void* val,
                            const void* h, int dtype, const void* diag, void* out,
                            void* partial, const void* owner_rows, const void* owner_ptr,
                            void* tickets, int num_hubs, int num_rows, int num_virtual, int F,
                            int vec, void* stream) {
  const long long rows = static_cast<long long>(num_rows) + num_virtual;
  const int max_vec = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 8 : 0;
  if (num_rows < 0 || num_virtual < 0 || F < 0 || vec <= 0 || vec > max_vec ||
      (vec & (vec - 1)) || (F > 0 && F % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tickets != nullptr && (owner_rows == nullptr || owner_ptr == nullptr || num_hubs <= 0 ||
                             num_virtual == 0 || partial == nullptr))
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
  const Hubs hubs{static_cast<const int*>(owner_rows), static_cast<const int*>(owner_ptr),
                  static_cast<int*>(tickets), num_hubs};
  if (dtype == kFloat32)
    launch_vec<float>(vec, nv, grid, s, rp, c, v, h, d, out, p, hubs, num_rows, num_virtual, F,
                      ll);
  else
    launch_vec<__nv_bfloat16>(vec, nv, grid, s, rp, c, v, h, d, out, p, hubs, num_rows,
                              num_virtual, F, ll);
  return static_cast<int>(cudaGetLastError());
}
