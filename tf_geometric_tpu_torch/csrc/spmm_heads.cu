// H-head SpMM and SDDMM over a CSR view: the products of the COO SpMM and of
// the multi-head SpMM, forward and backward.
//
// Replaces:
//   spmm   tf_geometric_tpu/ops/spmm.py, spmm (spmm_xla; in the custom VJP,
//          dh = A^T dy on the swapped index) with H = 1, and
//          tf_geometric_tpu/ops/ell.py, ell_spmm_multihead (_mh_forward; in
//          _mh_bwd, dV = A_att^T dy on the transposed layout);
//   sddmm  tf_geometric_tpu/ops/spmm.py, sddmm and the custom VJP's
//          dv[e] = <dy[row_e], h[col_e]> with H = 1, and _mh_bwd's
//          d_att[e, h] = <dy[r_e] block h, v[c_e] block h>.
//
// The view: rows 0 .. R - 1, row r's entries at row_ptr[r] .. row_ptr[r + 1];
// entry i names a row nbr[i] of the gathered operand (the SDDMM clamps it
// to [0, n - 1]; the SpMM reads it as is: build_csr_view clamps its views'
// ids and a CsrGatLayout side holds in-range edges only) and an edge id
// eid[i], the row of the [E, H] weight (spmm) or output (sddmm) array. Dense operands are [rows, H * d] row-major, head h
// in columns h * d .. h * d + d - 1. Float32 or bfloat16; sums in float32,
// in the view's entry order.
//   spmm:  out[r, h * d + j] = sum_{i in row r} w[eid_i, h] * src[nbr_i, h * d + j]
//   sddmm: out[eid_i, h]    = sum_j a[r, h * d + j] * b[nbr_i, h * d + j]
// sddmm writes only the entries of the view; the caller zeroes the rest.
//
// Bound on the H100: bytes. Each entry gathers one row of H * d elements for
// 2 * H * d flops, far under the ~20 flops per byte where float32 FMA
// throughput would bind.
//
// Design. The view is a stable sort of the COO edge list by row (built by
// the caller), so every row's entries come in one fixed order and no float
// atomics are needed: both kernels give the same bits in every run. Each
// lane holds vectors of VEC elements, up to 16 bytes, where VEC divides d, so
// a vector lies in one head; rows wider than the lanes' vectors take several
// passes.
//
// spmm. The lane-group weighted gather of lane_gather.cuh with one output:
// a group of L lanes owns one row (L = the next power of two of the row's
// lane vectors, at most 32), so several narrow rows share a warp and an
// empty row costs a lane group, with U entries in flight per lane. A row with
// more than kChunk (64) entries is long (the arxiv graph's largest has
// 2,839): spmm_heads_chunk_kernel gives a lane group to each kChunk-entry
// chunk of the view; the chunk's row is the row of its first entry, read
// from the view's row of each entry (entry_row, which the caller's sort
// already made), and when that row is long the group sums the row's entries
// inside the chunk into the chunk's float32 partial. spmm_heads_kernel then
// sums each row as lane_gather.cuh's RowSplit says: its entries before its
// first chunk boundary, then the partials of the chunks that start inside
// it, in chunk order. So no group reads more than 64 entries of a row in
// sequence (and at most 45 partials on the arxiv graph), with no search and
// no sync.
//
// sddmm. Each entry's output is written once, by its own edge id, from its
// own row of a and of b: no value crosses entries, so the view's entries can
// be cut anywhere. A lane group of L lanes (the next power of two of a row's
// lane vectors, at most 32) takes one chunk of kChunk consecutive entries of
// the view, whatever rows they belong to; so no group walks more than kChunk
// entries (the arxiv graph's longest row has 2,839), narrow rows share a
// warp, an empty row costs nothing, and there are no partials, no second
// launch and no atomics. Each entry's
// row is read from the view's entry_row (the sorted keys a view is built
// from; the wrapper finds it from row_ptr for a view without it), so the
// kernel reads no row pointers. The group walks its chunk U entries at a
// time: the U entries' ids, then their rows of a and b, all loaded before any
// is used (a row of a comes from L1 or L2 for the entries after a row's
// first, which the view keeps together). Per entry, each lane's products are
// summed over the lanes of each head: when a head's vectors lie in one group
// (the vectors per head a power of two, at most L), one segmented butterfly
// sums every head of a slice at once; otherwise a butterfly over the group
// per head. Shuffles name the group's lanes only. One lane writes each head's
// value (a head split over two passes adds the second pass's part to its own
// first write).
#include "lane_gather.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;

// One lane group per chunk of kChunk entries: the part of a long row inside
// the chunk, as its float32 partial [chunks, H * d]. The chunk's row is the
// row of its first entry (entry_row, the view's row of each entry); a chunk
// whose row is short writes nothing.
template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
spmm_heads_chunk_kernel(const int* __restrict__ row_ptr, const int* __restrict__ entry_row,
                        Gather<T, 1> g, float* __restrict__ partial, int rows, int chunks,
                        int lanes_log2) {
  GroupLane gl = group_lane(lanes_log2);
  gl.g = (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> lanes_log2;
  if (gl.g >= chunks) return;  // no shuffles below: lanes may leave
  const int lo = static_cast<int>(gl.g) * kChunk;
  if (lo >= row_ptr[rows]) return;
  const int r = entry_row[lo];
  const int end = row_ptr[r + 1];
  if (end - row_ptr[r] <= kChunk) return;  // a short row: spmm_heads_kernel's
  const int hi = min(end, lo + kChunk);
  const int nvec = g.F / VEC;
  float* const prow[1] = {partial + static_cast<size_t>(gl.g) * g.F};
  for (int v0 = 0; v0 < nvec; v0 += gl.L * NV) {
    float acc[1][NV * VEC] = {};
    add_entries<T, VEC, NV, U, 1>(acc, gl, v0, nvec, lo, hi, g);
    store_rows<float, VEC, NV, 1>(prow, acc, gl, v0, nvec);
  }
}

// One lane group per row: a short row from its entries; a long row from its
// entries before its first chunk boundary, then the partials of the chunks
// that start inside it (written by spmm_heads_chunk_kernel), in chunk order.
template <typename T, typename OutT, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
spmm_heads_kernel(const int* __restrict__ row_ptr, Gather<T, 1> g,
                  const float* __restrict__ partial, OutT* __restrict__ out, int rows,
                  int lanes_log2) {
  // as many bytes of partials in flight as of the entries' rows
  constexpr int UP = U * static_cast<int>(sizeof(T)) / 4 > 0
                         ? U * static_cast<int>(sizeof(T)) / 4 : 1;
  GroupLane gl = group_lane(lanes_log2);
  gl.g = (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> lanes_log2;
  if (gl.g >= rows) return;  // no shuffles below: lanes may leave
  const int nvec = g.F / VEC;
  const int start = row_ptr[gl.g];
  const RowSplit split(start, row_ptr[gl.g + 1]);
  OutT* const orow[1] = {out + static_cast<size_t>(gl.g) * g.F};
  for (int v0 = 0; v0 < nvec; v0 += gl.L * NV) {
    float acc[1][NV * VEC] = {};
    add_entries<T, VEC, NV, U, 1>(acc, gl, v0, nvec, start, split.direct_end, g);
    add_partials<VEC, NV, UP, 1>(acc, gl, v0, nvec, split.c_lo, split.c_hi, partial, g.F);
    store_rows<OutT, VEC, NV, 1>(orow, acc, gl, v0, nvec);
  }
}

template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
sddmm_heads_kernel(const int* __restrict__ entry_row, const int* __restrict__ nbr,
                   const int* __restrict__ eid, const T* __restrict__ a,
                   const T* __restrict__ b, int n_b, int H, int d, float* __restrict__ out,
                   int rows, int entries, int lanes_log2) {
  const GroupLane gl = group_lane(lanes_log2);
  const long long lo =
      ((static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> lanes_log2) * kChunk;
  if (lo >= entries) return;  // group-uniform: the shuffles below name the group's lanes only
  const int hi = static_cast<int>(min(static_cast<long long>(entries), lo + kChunk));
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned mask = gl.L == kWarp ? kFull : ((1u << gl.L) - 1) << (lane & ~(gl.L - 1));
  const int F = H * d;
  const int nvec = F / VEC;
  const int vpd = d / VEC;
  // a head's vectors in one group: one segmented butterfly per slice
  const bool segmented = (vpd & (vpd - 1)) == 0 && vpd <= gl.L;
  for (int v0 = 0; v0 < nvec; v0 += gl.L * NV) {
    int head[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int v = v0 + q * gl.L + gl.lig;
      head[q] = v < nvec ? v / vpd : -1;
    }
    // the heads this pass touches (group-uniform)
    const int h_lo = v0 / vpd;
    const int h_hi = min(H - 1, (v0 + gl.L * NV - 1) / vpd);
    for (int jb = static_cast<int>(lo); jb < hi; jb += U) {
      RawT<T, VEC> ra[U][NV], rb[U][NV];
      int eu[U];
      bool oku[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = jb + u;
        const bool in = j < hi;
        // the three ids in one trip; an entry past the view's (a dropped
        // edge) has the row count as its row
        const int r = in ? __ldg(entry_row + j) : rows;
        const int c = in ? __ldg(nbr + j) : 0;
        eu[u] = in ? __ldg(eid + j) : 0;
        oku[u] = r < rows;
        const T* arow = a + static_cast<size_t>(oku[u] ? r : 0) * F;
        const T* brow = b + static_cast<size_t>(oku[u] ? min(max(c, 0), n_b - 1) : 0) * F;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int v = v0 + q * gl.L + gl.lig;
          const bool vok = oku[u] && v < nvec;
          ra[u][q] = vok ? __ldg(reinterpret_cast<const RawT<T, VEC>*>(arow + v * VEC))
                         : RawT<T, VEC>{};
          rb[u][q] = vok ? __ldg(reinterpret_cast<const RawT<T, VEC>*>(brow + v * VEC))
                         : RawT<T, VEC>{};
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          float x[VEC], y[VEC];
          unpack<T, VEC>(ra[u][q], x);
          unpack<T, VEC>(rb[u][q], y);
          part[q] = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) part[q] += x[i] * y[i];
        }
        float* orow = out + static_cast<size_t>(eu[u]) * H;
        if (segmented) {
          // slice q holds L / vpd whole heads of vpd lanes each; the lane
          // at each head's first vector writes it
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            float s = part[q];
            for (int o = vpd >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(mask, s, o, gl.L);
            const int v = v0 + q * gl.L + gl.lig;
            if (oku[u] && v < nvec && (gl.lig & (vpd - 1)) == 0) orow[v / vpd] = s;
          }
        } else {
          for (int h = h_lo; h <= h_hi; ++h) {
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < NV; ++q) s += head[q] == h ? part[q] : 0.f;
            for (int o = gl.L >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(mask, s, o, gl.L);
            // head h's first vector, h * vpd, lies in this pass or an earlier one
            if (oku[u] && gl.lig == 0) orow[h] = h * vpd >= v0 ? s : orow[h] + s;
          }
        }
      }
    }
  }
}

// the SpMM's operands, as the C entry receives them
struct SpmmArgs {
  const int* row_ptr;
  const int* entry_row;
  const int* nbr;
  const int* eid;
  const float* w;
  int H, d;
  const void* src;
  float* partial;
  void* out;
  int rows, chunks, ll;
};

template <typename T, typename OutT, int VEC, int NV>
void launch_spmm_nv(const SpmmArgs& a, cudaStream_t st) {
  constexpr int U = unroll_for(NV, 1);
  const Gather<T, 1> g{a.nbr, a.eid, a.w, a.H, {0}, {static_cast<const T*>(a.src)},
                       a.H * a.d, a.d / VEC};
  if (a.chunks > 0)
    spmm_heads_chunk_kernel<T, VEC, NV, U><<<grid_for_groups(a.chunks, a.ll), kBlock, 0, st>>>(
        a.row_ptr, a.entry_row, g, a.partial, a.rows, a.chunks, a.ll);
  spmm_heads_kernel<T, OutT, VEC, NV, U><<<grid_for_groups(a.rows, a.ll), kBlock, 0, st>>>(
      a.row_ptr, g, a.partial, static_cast<OutT*>(a.out), a.rows, a.ll);
}

template <typename T, typename OutT, int VEC>
void launch_spmm_vec(int nv, const SpmmArgs& a, cudaStream_t st) {
  if (nv == 1) launch_spmm_nv<T, OutT, VEC, 1>(a, st);
  else if (nv == 2) launch_spmm_nv<T, OutT, VEC, 2>(a, st);
  else launch_spmm_nv<T, OutT, VEC, 4>(a, st);
}

template <typename T, typename OutT>
void launch_spmm(int vec, int nv, const SpmmArgs& a, cudaStream_t st) {
  switch (vec) {
    case 1: launch_spmm_vec<T, OutT, 1>(nv, a, st); break;
    case 2: launch_spmm_vec<T, OutT, 2>(nv, a, st); break;
    case 4: launch_spmm_vec<T, OutT, 4>(nv, a, st); break;
    default:
      if constexpr (sizeof(T) == 2) launch_spmm_vec<T, OutT, 8>(nv, a, st);
  }
}

// the SDDMM's operands, as the C entry receives them
struct SddmmArgs {
  const int* entry_row;
  const int* nbr;
  const int* eid;
  const void* a;
  const void* b;
  int n_b, H, d;
  float* out;
  int rows, entries, ll;
};

template <typename T, int VEC, int NV>
void launch_sddmm_nv(const SddmmArgs& s, cudaStream_t st) {
  constexpr int U = unroll_for(NV, 2);  // rows of a and of b in flight: as two outputs
  const long long chunks = (static_cast<long long>(s.entries) + kChunk - 1) / kChunk;
  sddmm_heads_kernel<T, VEC, NV, U><<<grid_for_groups(chunks, s.ll), kBlock, 0, st>>>(
      s.entry_row, s.nbr, s.eid, static_cast<const T*>(s.a), static_cast<const T*>(s.b), s.n_b,
      s.H, s.d, s.out, s.rows, s.entries, s.ll);
}

template <typename T, int VEC>
void launch_sddmm_vec(int nv, const SddmmArgs& s, cudaStream_t st) {
  if (nv == 1) launch_sddmm_nv<T, VEC, 1>(s, st);
  else if (nv == 2) launch_sddmm_nv<T, VEC, 2>(s, st);
  else launch_sddmm_nv<T, VEC, 4>(s, st);
}

template <typename T>
void launch_sddmm(int vec, int nv, const SddmmArgs& s, cudaStream_t st) {
  switch (vec) {
    case 1: launch_sddmm_vec<T, 1>(nv, s, st); break;
    case 2: launch_sddmm_vec<T, 2>(nv, s, st); break;
    case 4: launch_sddmm_vec<T, 4>(nv, s, st); break;
    default:
      if constexpr (sizeof(T) == 2) launch_sddmm_vec<T, 8>(nv, s, st);
  }
}

// vec elements per lane vector: a power of two dividing d, at most 16 bytes
// of the narrower dtype's elements
bool bad_shape(int rows, int n, int H, int d, int vec, int max_vec) {
  return rows < 0 || n <= 0 || H <= 0 || d <= 0 || vec <= 0 || vec > max_vec ||
         (vec & (vec - 1)) || d % vec != 0 || static_cast<long long>(H) * d >= (1LL << 31);
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch (0 on success).

// out [rows, H * d] (dtype out_dtype) = the view's rows of w-weighted rows of
// src [n_src, H * d] (dtype src_dtype): float32 -> float32, bfloat16 ->
// bfloat16 or float32. w float32 [E, H]. Row starts aligned to vec elements.
// chunks: 0 when the view holds at most kChunk entries (no row can be long),
// else ceil(E / kChunk), with entry_row [E] the row of each stored entry and
// partial float32 [chunks, H * d] as scratch; then two kernels are launched
// (the chunks', then the rows').
extern "C" int tfg_spmm_heads(const void* row_ptr, const void* entry_row, const void* nbr,
                              const void* eid, const void* w, int H, int d, const void* src,
                              int src_dtype, int n_src, void* out, int out_dtype, int rows,
                              int vec, void* partial, int chunks, void* stream) {
  const int max_vec = src_dtype == kFloat32 ? 4 : src_dtype == kBFloat16 ? 8 : 0;
  if (bad_shape(rows, n_src, H, d, vec, max_vec) ||
      (src_dtype == kFloat32 && out_dtype != kFloat32) ||
      (out_dtype != kFloat32 && out_dtype != kBFloat16) || chunks < 0 ||
      (chunks > 0 && (partial == nullptr || entry_row == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int nvec = H * d / vec;
  const int ll = pick_lanes_log2(nvec);
  const int nv = pick_nv(nvec, 1 << ll);
  const SpmmArgs a{static_cast<const int*>(row_ptr), static_cast<const int*>(entry_row),
                   static_cast<const int*>(nbr), static_cast<const int*>(eid),
                   static_cast<const float*>(w), H, d, src,
                   static_cast<float*>(partial), out, rows, chunks, ll};
  auto st = static_cast<cudaStream_t>(stream);
  if (src_dtype == kFloat32)
    launch_spmm<float, float>(vec, nv, a, st);
  else if (out_dtype == kBFloat16)
    launch_spmm<__nv_bfloat16, __nv_bfloat16>(vec, nv, a, st);
  else
    launch_spmm<__nv_bfloat16, float>(vec, nv, a, st);
  return static_cast<int>(cudaGetLastError());
}

// out float32 [E, H]: out[eid_i, h] = <a[r] block h, b[nbr_i] block h> for
// each entry i of row r; a [rows, H * d] and b [n_b, H * d] of one dtype.
// entry_row, nbr and eid hold `entries` entries; an entry whose row is
// `rows` (or more) is not one of the view's and is skipped.
extern "C" int tfg_sddmm_heads(const void* entry_row, const void* nbr, const void* eid,
                               const void* a, const void* b, int dtype, int n_b, int H, int d,
                               void* out, int rows, int entries, int vec, void* stream) {
  const int max_vec = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 8 : 0;
  if (bad_shape(rows, n_b, H, d, vec, max_vec) || entries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || entries == 0) return static_cast<int>(cudaSuccess);
  const int nvec = H * d / vec;
  const int ll = pick_lanes_log2(nvec);
  const SddmmArgs s{static_cast<const int*>(entry_row), static_cast<const int*>(nbr),
                    static_cast<const int*>(eid), a, b, n_b, H, d, static_cast<float*>(out),
                    rows, entries, ll};
  const int nv = pick_nv(nvec, 1 << ll);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) launch_sddmm<float>(vec, nv, s, st);
  else launch_sddmm<__nv_bfloat16>(vec, nv, s, st);
  return static_cast<int>(cudaGetLastError());
}
