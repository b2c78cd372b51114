// The lane-group weighted gather of spmm_heads.cu (the H-head SpMM: one
// output) and gat_attention.cu (the GAT backward's source pass: two outputs,
// dK from Q and dV from dy).
//
// Lanes. A group of L = 2^lanes_log2 lanes (the next power of two of a row's
// lane vectors, at most 32) owns one output row, so several narrow rows share
// a warp; each lane holds NV vectors of VEC elements (up to 16 bytes, inside
// one head) per pass, and rows wider than that take several passes. Output o
// of entry i (neighbour c, edge id e) adds w[e * w_stride + w_off[o] + h] *
// src_o[c] to head h's columns. The group walks its entries in order, U at a
// time: it loads U entries' ids, then all their rows and weights, before it
// adds any (the weight rides beside the row: a transaction, not a trip to
// memory); every load goes through the read-only path (__ldg). Sums are
// float32, in entry order. Neighbour ids are read as they are: the views'
// builders keep them in range (build_csr_view clamps them, a CsrGatLayout
// side drops out-of-range edges). (Measured on the H100: the read-only path
// gains 10-15% on the SpMM; loading the next batch's ids ahead lost 7% on
// the GAT source pass at 8 heads of 32 bf16; clamping each id in the gather
// cost 8-13% on both.)
//
// Long rows. A row with more than kChunk entries is long. The view's entries
// fall into chunks of kChunk at fixed boundaries (multiples of kChunk), and a
// long row is the sum of its entries before its first boundary, then of the
// float32 partials of the chunks that start inside it, in chunk order
// (RowSplit; ops/spmm_heads.py row_split is its host twin). spmm_heads.cu
// computes the partials in a kernel of their own, a lane group per chunk of
// the view; gat_attention.cu in the same launch, in a block per long row whose
// other lane groups take the row's chunks round robin. Either way no lane
// group walks more than kChunk entries of a row, the sum has one order, and
// no float atomics are used: every run gives the same bits.
#pragma once

#include "common.cuh"

namespace tfg {

// entries per chunk; the Python side reads this line (ops/_build.py)
constexpr int kChunk = 64;

// Where one lane sits: its group's row (or chunk) g and its lane in the
// group of L lanes.
struct GroupLane {
  long long g;
  int lig, L;
};

// g is the caller's to set
__device__ __forceinline__ GroupLane group_lane(int lanes_log2) {
  GroupLane gl;
  gl.L = 1 << lanes_log2;
  gl.lig = threadIdx.x & (gl.L - 1);
  gl.g = 0;
  return gl;
}

// How a row [start, end) of the view is summed: its entries [start,
// direct_end), then the partials of chunks [c_lo, c_hi) (none unless long).
struct RowSplit {
  int direct_end, c_lo, c_hi;
  __device__ RowSplit(int start, int end) {
    const bool is_long = end - start > kChunk;
    c_lo = is_long ? (start + kChunk - 1) / kChunk : 0;
    c_hi = is_long ? (end - 1) / kChunk + 1 : 0;
    direct_end = is_long ? c_lo * kChunk : end;
  }
};

// The gathered operands of NOUT outputs over one view.
template <typename T, int NOUT>
struct Gather {
  const int* nbr;      // [entries] neighbour: a row of src, not clamped (see above)
  const int* eid;      // [entries] edge id: the row of w
  const float* w;      // [E, w_stride] float32
  int w_stride;
  int w_off[NOUT];     // output o's first weight column
  const T* src[NOUT];  // output o's gathered rows, [rows, F]
  int F, vpd;          // row width, lane vectors per head
};

// acc[o] += the weighted rows of entries [lo, hi) on this lane's vectors of
// the pass from v0 (see the header)
template <typename T, int VEC, int NV, int U, int NOUT>
__device__ __forceinline__ void add_entries(float (&acc)[NOUT][NV * VEC], const GroupLane& gl,
                                            int v0, int nvec, int lo, int hi,
                                            const Gather<T, NOUT>& g) {
  int head[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) head[q] = (v0 + q * gl.L + gl.lig) / g.vpd;
  for (int jb = lo; jb < hi; jb += U) {
    RawT<T, VEC> raw[U][NOUT][NV];
    float wu[U][NOUT][NV];
    int c[U], e[U];  // the batch's neighbours and edge ids
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = jb + u < hi;
      c[u] = ok ? __ldg(g.nbr + jb + u) : 0;
      e[u] = ok ? __ldg(g.eid + jb + u) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = jb + u < hi;
      const float* wrow = g.w + static_cast<size_t>(e[u]) * g.w_stride;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        const T* row = g.src[o] + static_cast<size_t>(c[u]) * g.F;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int v = v0 + q * gl.L + gl.lig;
          const bool vok = ok && v < nvec;
          raw[u][o][q] = vok ? __ldg(reinterpret_cast<const RawT<T, VEC>*>(row + v * VEC))
                             : RawT<T, VEC>{};
          wu[u][o][q] = vok ? __ldg(wrow + g.w_off[o] + head[q]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          float x[VEC];
          unpack<T, VEC>(raw[u][o][q], x);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[o][q * VEC + i] += wu[u][o][q] * x[i];
        }
      }
    }
  }
}

// acc[o] += the float32 partials of chunks [c_lo, c_hi) (rows of NOUT * F
// floats, output o's at o * F) on this lane's vectors, in chunk order, UP
// chunks loaded before any is added. Plain loads: gat_attention.cu reads
// partials written earlier in the same launch.
template <int VEC, int NV, int UP, int NOUT>
__device__ __forceinline__ void add_partials(float (&acc)[NOUT][NV * VEC], const GroupLane& gl,
                                             int v0, int nvec, int c_lo, int c_hi,
                                             const float* partial, int F) {
  for (int cb = c_lo; cb < c_hi; cb += UP) {
    float x[UP][NOUT][NV * VEC];
#pragma unroll
    for (int u = 0; u < UP; ++u) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        const float* prow = partial + (static_cast<size_t>(cb + u) * NOUT + o) * F;
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int v = v0 + q * gl.L + gl.lig;
          if (cb + u < c_hi && v < nvec) {
            load_f32<VEC>(prow + v * VEC, x[u][o] + q * VEC);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) x[u][o][q * VEC + i] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UP; ++u) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
#pragma unroll
        for (int i = 0; i < NV * VEC; ++i) acc[o][i] += x[u][o][i];
      }
    }
  }
}

// acc[o] rounded to OutT and stored at rows[o] (output o's row) on this
// lane's vectors
template <typename OutT, int VEC, int NV, int NOUT>
__device__ __forceinline__ void store_rows(OutT* const (&rows)[NOUT],
                                           const float (&acc)[NOUT][NV * VEC],
                                           const GroupLane& gl, int v0, int nvec) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int v = v0 + q * gl.L + gl.lig;
    if (v >= nvec) continue;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) store_vec<OutT, VEC>(rows[o] + v * VEC, acc[o] + q * VEC);
  }
}

// in-flight entries per lane for NV vectors per lane and NOUT outputs
__host__ __device__ constexpr int unroll_for(int nv, int nout) {
  return (nv == 1 ? 8 : nv == 2 ? 4 : 2) / nout;
}

}  // namespace tfg
