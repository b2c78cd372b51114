// GAT attention over a CSR graph: the forward kernel and the two backward
// kernels (destination side: dQ; source side: dK and dV).
//
// Replaces: tf_geometric_tpu/ops/ell_attention_bucketed.py,
// gat_attention_bucketed (its _fused_core forward and _fused_bwd backward
// under jax.custom_vjp), and tf_geometric_tpu/ops/ell_attention.py,
// gat_attention_ell (the same passes over a rectangular layout: the
// graph-parallel GAT's local destination rows reading [local || received]
// source rows).
//
// Q, out, dy, dQ are [N, H*d] and K, V, dK, dV [S, H*d] (S = N for a square
// layout), row-major and head-blocked (head h owns columns h*d .. h*d + d -
// 1), float32 or bfloat16; lse and D are [N, H] float32; keep is null or
// [E, H] float32 (the dropout mask, its 1/(1 - rate) scale included),
// indexed by edge id. The destination side has N rows whose neighbours are
// source rows, the source side S rows whose neighbours are destination rows.
// Sums run in float32.
//
//   forward, per destination row r and head h, over r's in-edges e = (r <- c):
//     s_e    = <Q[r], K[c]>_h / sqrt(d)
//     lse[r] = max_e s_e + log(sum_e exp(s_e - max_e s_e) + 1e-16)
//     out[r] = sum_e a_e keep_e V[c],   a_e = exp(s_e - lse[r])
//   (one pass: an online softmax keeps the running max and sum).
//   backward, destination side, per row r:
//     D[r]  = <dy[r], out[r]>_h          (= sum_e a_e da_e, no second pass)
//     da_e  = keep_e <dy[r], V[c]>_h,    ds_e = a_e (da_e - D[r]) / sqrt(d)
//     dQ[r] = sum_e ds_e K[c]
//   backward, source side, per column c over c's out-edges (r <- c), with
//   the same recompute:  dV[c] = sum_e a_e keep_e dy[r],  dK[c] = sum_e ds_e Q[r]
// Every row of a side is written, so the outputs need no zero fill: a
// destination row without edges writes out = 0, lse = 0, dQ = 0 and D =
// <dy, 0> = 0, a source row without edges dK = dV = 0 (the halo layouts
// have many: padding rows, unaddressed received slots, nodes that are the
// source of no edge).
//
// Bound on the H100: bytes. Each edge gathers two rows of H*d elements and
// does ~4 flops per gathered element, under the ~20 flops per byte where
// float32 FMA throughput would bind. The least traffic is each dense
// operand read once, each output written once, the row pointers and
// neighbour ids, lse / D, and under dropout the edge ids and the keep mask.
//
// Design. A warp owns a row (for H * d up to 32 lanes x 2 slices x one
// vector, every row of the bench: one warp per row, all heads). Each lane
// holds VEC consecutive features of one head, loaded as one vector of up to
// 16 bytes, so a 256-wide bf16 row is one load instruction per warp; the
// lanes of a head are a power-of-two group, and a per-head dot product is
// VEC local products and an xor-shuffle reduction inside the group. Every
// lane of a head so holds its score and the online softmax state (running
// max and sum) without shared memory. Edges go U at a time: their gathered
// rows are all loaded, still packed, before any is used, so U row gathers
// per warp are in flight. Rows with more than hub_degree edges (29 on the
// arxiv graph, the largest 2,839) get a block of 8 warps, placed first in
// the grid so they start first; each warp walks one chunk of the row and
// warp 0 merges the chunks' states from a scratch buffer in a fixed order.
// No atomics: the result does not depend on scheduling.
#include <math.h>

#include "common.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;
constexpr int kMaxSlices = 2;  // 32-lane slices one warp covers

// Elements per lane vector: the largest power of two that divides d and
// fits in max_bytes (16, or less when a tensor is not 16-byte aligned).
__host__ __device__ inline int pick_vec(int d, int elt, int max_bytes) {
  int v = 1;
  while (2 * v * elt <= max_bytes && d % (2 * v) == 0) v *= 2;
  return v;
}

// How the heads of a row are laid over the lanes (same on host and device).
// A head of up to 32 vectors takes a power-of-two group of lanes, several
// heads to a 32-lane slice; a head of 33 to 64 vectors takes both slices
// of a warp ("wide").
struct HeadMap {
  int H, d, HD;
  int group;            // lanes per head within a slice: a power of two <= 32
  int heads_per_slice;  // 32 / group (1 when wide)
  int head_slices;      // slices per head: 1, or 2 when wide
  int slices;           // 32-lane slices per warp: 1 or kMaxSlices
  int tasks;            // warps per row
  bool supported;
  __host__ __device__ HeadMap(int H_, int d_, int vec) : H(H_), d(d_), HD(H_ * d_) {
    const int vectors = d / vec;
    group = 1;
    while (group < vectors) group <<= 1;
    supported = group <= kMaxSlices * kWarp;
    head_slices = group > kWarp ? kMaxSlices : 1;
    if (group > kWarp) group = kWarp;
    heads_per_slice = head_slices == 1 ? kWarp / group : 1;
    slices = (head_slices > 1 || H > heads_per_slice) ? kMaxSlices : 1;
    const int per_task = head_slices > 1 ? 1 : heads_per_slice * slices;
    tasks = (H + per_task - 1) / per_task;
  }
};

// What one lane holds in each of its NS slices: a head (>= H: idle), the
// first column of its vector (-1: none), whether it writes the head's
// statistics (lse / D).
template <int NS, int VEC>
struct LaneMap {
  int head[NS];
  int col[NS];
  bool leader[NS];
  __device__ LaneMap(const HeadMap& m, int task, int lane) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      int h, vi;
      if (m.head_slices > 1) {
        h = task;
        vi = j * kWarp + lane;
      } else {
        h = (task * NS + j) * m.heads_per_slice + lane / m.group;
        vi = lane % m.group;
      }
      head[j] = h;
      col[j] = (h < m.H && vi * VEC < m.d) ? h * m.d + vi * VEC : -1;
      leader[j] = h < m.H && vi == 0;
    }
  }
};

struct SideArgs {
  const int* row_ptr;  // [num_rows + 1]
  const int* nbr;      // [nnz] source (destination side) or destination (source side)
  const int* eid;      // [nnz] edge id, read only to index a keep mask
  const int* hubs;     // [num_hubs] rows with more than hub_degree edges
  int num_hubs;
  int num_rows;
  int hub_degree;
};

struct HeadArgs {
  int H;
  int d;
  float scale;        // 1 / sqrt(d)
  const float* keep;  // [E, H] or null
};

// The edges one warp walks: a whole row, or one chunk of a hub row.
struct Task {
  long long row;
  int task;
  int e0, e1;
  bool hub;
  bool active;
};

__device__ __forceinline__ Task resolve(const SideArgs& s, const HeadMap& m, int warp) {
  Task t;
  const long long hub_blocks = static_cast<long long>(s.num_hubs) * m.tasks;
  t.hub = blockIdx.x < hub_blocks;
  if (t.hub) {
    t.row = s.hubs[blockIdx.x / m.tasks];
    t.task = static_cast<int>(blockIdx.x % m.tasks);
    const int s0 = s.row_ptr[t.row], s1 = s.row_ptr[t.row + 1];
    const int chunk = (s1 - s0 + kWarpsPerBlock - 1) / kWarpsPerBlock;
    t.e0 = min(s1, s0 + warp * chunk);
    t.e1 = min(s1, t.e0 + chunk);
    t.active = true;
    return t;
  }
  const long long w = (static_cast<long long>(blockIdx.x) - hub_blocks) * kWarpsPerBlock + warp;
  t.active = w < static_cast<long long>(s.num_rows) * m.tasks;
  if (!t.active) return t;
  t.row = w / m.tasks;
  t.task = static_cast<int>(w % m.tasks);
  t.e0 = s.row_ptr[t.row];
  t.e1 = s.row_ptr[t.row + 1];
  t.active = t.e1 - t.e0 <= s.hub_degree;  // else a hub block owns the row
  return t;
}

template <typename T, int NS, int VEC>
__device__ __forceinline__ void load_raw(RawT<T, VEC> (&r)[NS], const T* __restrict__ row,
                                         const LaneMap<NS, VEC>& lm, bool ok) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
    r[j] = (ok && lm.col[j] >= 0) ? *reinterpret_cast<const RawT<T, VEC>*>(row + lm.col[j])
                                  : RawT<T, VEC>{};
}

// a row's vectors as floats, slice j at x[j * VEC]
template <typename T, int NS, int VEC>
__device__ __forceinline__ void load_row(float* x, const T* __restrict__ row,
                                         const LaneMap<NS, VEC>& lm) {
  RawT<T, VEC> r[NS];
  load_raw<T, NS, VEC>(r, row, lm, true);
#pragma unroll
  for (int j = 0; j < NS; ++j) unpack<T, VEC>(r[j], x + j * VEC);
}

template <typename T, int NS, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ row, const float* x,
                                          const LaneMap<NS, VEC>& lm, float scale = 1.f) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (lm.col[j] < 0) continue;
    RawT<T, VEC> r;
    T* p = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f32<T>(x[j * VEC + i] * scale);
    *reinterpret_cast<RawT<T, VEC>*>(row + lm.col[j]) = r;
  }
}

// out[j] = <a, b> over the head of the lane's slice j; every lane of a
// head gets the sum (a wide head adds its two slices first)
template <int NS, int VEC>
__device__ __forceinline__ void head_dots(float (&out)[NS], const float* a, const float* b,
                                          const HeadMap& m) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) v += a[j * VEC + i] * b[j * VEC + i];
    out[j] = v;
  }
  if (NS > 1 && m.head_slices > 1) {
    const float total = out[0] + out[1];
    out[0] = out[1] = total;
  }
  for (int o = m.group >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < NS; ++j) out[j] += __shfl_xor_sync(kFull, out[j], o);
  }
}

__device__ __forceinline__ float keep_of(const HeadArgs& h, int e, int head, bool ok) {
  return (h.keep != nullptr && ok && head < h.H)
             ? h.keep[static_cast<size_t>(e) * h.H + head] : 1.f;
}

__device__ __forceinline__ float stat_of(const float* __restrict__ st, const HeadArgs& h,
                                         long long row, int head, bool ok) {
  return (ok && head < h.H) ? st[row * h.H + head] : 0.f;
}

// Calls body(c, e, count) for the edges [e0, e1) in batches of U: the
// neighbour ids (and, under dropout, the edge ids that index the keep mask)
// are read 32 at a time, coalesced, and broadcast by shuffle; count
// (warp-uniform) is how many of the U are real.
template <int U, class F>
__device__ __forceinline__ void for_edge_batches(const SideArgs& s, const HeadArgs& h, int e0,
                                                 int e1, int lane, F&& body) {
  const bool with_eid = h.keep != nullptr;
  for (int base = e0; base < e1; base += kWarp) {
    int c_lane = 0, e_lane = 0;
    if (base + lane < e1) {
      c_lane = s.nbr[base + lane];
      if (with_eid) e_lane = s.eid[base + lane];
    }
    const int n = min(kWarp, e1 - base);
    for (int i0 = 0; i0 < n; i0 += U) {
      int c[U], e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = __shfl_sync(kFull, c_lane, (i0 + u) & (kWarp - 1));
        e[u] = with_eid ? __shfl_sync(kFull, e_lane, (i0 + u) & (kWarp - 1)) : 0;
      }
      body(c, e, min(U, n - i0));
    }
  }
}

// A hub block: every warp writes its N per-lane values to the scratch
// buffer; warp 0 reads them all back (slot w of value k at (w N + k) 32).
template <int N>
__device__ __forceinline__ const float* share_partials(const float (&x)[N],
                                                       float* __restrict__ scratch, int warp,
                                                       int lane) {
  float* blk = scratch + static_cast<size_t>(blockIdx.x) * kWarpsPerBlock * N * kWarp;
#pragma unroll
  for (int k = 0; k < N; ++k) blk[(warp * N + k) * kWarp + lane] = x[k];
  __syncthreads();
  return warp == 0 ? blk : nullptr;
}

// warp 0 of a hub block adds the other warps' partial sums to its own
template <int N>
__device__ __forceinline__ bool merge_sums(float (&acc)[N], float* __restrict__ scratch,
                                           int warp, int lane) {
  const float* blk = share_partials(acc, scratch, warp, lane);
  if (blk == nullptr) return false;
  for (int w = 1; w < kWarpsPerBlock; ++w) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += blk[(w * N + k) * kWarp + lane];
  }
  return true;
}

template <typename T, int NS, int VEC, int U>
__global__ void __launch_bounds__(kBlock)
gat_forward_kernel(SideArgs s, HeadArgs h, const T* __restrict__ Q, const T* __restrict__ K,
                   const T* __restrict__ V, T* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ scratch) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const HeadMap m(h.H, h.d, VEC);
  const Task t = resolve(s, m, warp);
  if (!t.active) return;  // warp-uniform; never taken in a hub block
  const LaneMap<NS, VEC> lm(m, t.task, lane);
  float q[NS * VEC];
  load_row<T, NS, VEC>(q, Q + t.row * m.HD, lm);
  // per slice j: st[j * (VEC + 2)] = running max, + 1 = sum, + 2.. = acc
  constexpr int W = VEC + 2;
  float st[NS * W];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    st[j * W] = -INFINITY;
#pragma unroll
    for (int i = 1; i < W; ++i) st[j * W + i] = 0.f;
  }

  for_edge_batches<U>(s, h, t.e0, t.e1, lane, [&](const auto& c, const auto& e, int cnt) {
    RawT<T, VEC> kr[U][NS], vr[U][NS];
    float kp[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = u < cnt;
      load_raw<T, NS, VEC>(kr[u], K + static_cast<size_t>(c[u]) * m.HD, lm, ok);
      load_raw<T, NS, VEC>(vr[u], V + static_cast<size_t>(c[u]) * m.HD, lm, ok);
#pragma unroll
      for (int j = 0; j < NS; ++j) kp[u][j] = keep_of(h, e[u], lm.head[j], ok);
    }
    float sc[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NS * VEC];
#pragma unroll
      for (int j = 0; j < NS; ++j) unpack<T, VEC>(kr[u][j], kf + j * VEC);
      head_dots<NS, VEC>(sc[u], q, kf, m);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float* sj = st + j * W;
      float mnew = sj[0];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < cnt) mnew = fmaxf(mnew, sc[u][j] * h.scale);
      const float corr = expf(sj[0] - mnew);  // 0 while the max is -inf
#pragma unroll
      for (int i = 1; i < W; ++i) sj[i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < cnt) {
          const float p = expf(sc[u][j] * h.scale - mnew);
          sj[1] += p;
          const float w = p * kp[u][j];
          float vf[VEC];
          unpack<T, VEC>(vr[u][j], vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sj[2 + i] += w * vf[i];
        }
      }
      sj[0] = mnew;
    }
  });

  if (t.hub) {
    const float* blk = share_partials(st, scratch, warp, lane);
    if (blk == nullptr) return;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float big = -INFINITY;
      for (int w = 0; w < kWarpsPerBlock; ++w)
        big = fmaxf(big, blk[(w * NS * W + j * W) * kWarp + lane]);
      float merged[W];
#pragma unroll
      for (int i = 1; i < W; ++i) merged[i] = 0.f;
      for (int w = 0; w < kWarpsPerBlock; ++w) {
        const float* p = blk + (w * NS * W + j * W) * kWarp + lane;
        const float f = expf(p[0] - big);  // 0 for an empty chunk (max -inf)
#pragma unroll
        for (int i = 1; i < W; ++i) merged[i] += f * p[i * kWarp];
      }
      st[j * W] = big;
#pragma unroll
      for (int i = 1; i < W; ++i) st[j * W + i] = merged[i];
    }
  }

  float o[NS * VEC];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float* sj = st + j * W;
    const bool any = sj[1] > 0.f;
    const float inv = any ? 1.f / (sj[1] + 1e-16f) : 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[j * VEC + i] = sj[2 + i] * inv;
    if (lm.leader[j]) lse[t.row * m.H + lm.head[j]] = any ? sj[0] + logf(sj[1] + 1e-16f) : 0.f;
  }
  store_row<T, NS, VEC>(out + t.row * m.HD, o, lm);
}

template <typename T, int NS, int VEC, int U>
__global__ void __launch_bounds__(kBlock)
gat_backward_dst_kernel(SideArgs s, HeadArgs h, const T* __restrict__ Q,
                        const T* __restrict__ K, const T* __restrict__ V,
                        const T* __restrict__ out, const T* __restrict__ dy,
                        const float* __restrict__ lse, T* __restrict__ dQ,
                        float* __restrict__ D, float* __restrict__ scratch) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const HeadMap m(h.H, h.d, VEC);
  const Task t = resolve(s, m, warp);
  if (!t.active) return;
  const LaneMap<NS, VEC> lm(m, t.task, lane);
  float q[NS * VEC], g[NS * VEC], acc[NS * VEC], dsum[NS], lse_r[NS];
  load_row<T, NS, VEC>(q, Q + t.row * m.HD, lm);
  load_row<T, NS, VEC>(g, dy + t.row * m.HD, lm);
  load_row<T, NS, VEC>(acc, out + t.row * m.HD, lm);
  head_dots<NS, VEC>(dsum, g, acc, m);
#pragma unroll
  for (int j = 0; j < NS; ++j) lse_r[j] = stat_of(lse, h, t.row, lm.head[j], true);
#pragma unroll
  for (int k = 0; k < NS * VEC; ++k) acc[k] = 0.f;

  for_edge_batches<U>(s, h, t.e0, t.e1, lane, [&](const auto& c, const auto& e, int cnt) {
    RawT<T, VEC> kr[U][NS], vr[U][NS];
    float kp[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = u < cnt;
      load_raw<T, NS, VEC>(kr[u], K + static_cast<size_t>(c[u]) * m.HD, lm, ok);
      load_raw<T, NS, VEC>(vr[u], V + static_cast<size_t>(c[u]) * m.HD, lm, ok);
#pragma unroll
      for (int j = 0; j < NS; ++j) kp[u][j] = keep_of(h, e[u], lm.head[j], ok);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NS * VEC], vf[NS * VEC], sc[NS], da[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        unpack<T, VEC>(kr[u][j], kf + j * VEC);
        unpack<T, VEC>(vr[u][j], vf + j * VEC);
      }
      head_dots<NS, VEC>(sc, q, kf, m);
      head_dots<NS, VEC>(da, g, vf, m);
      if (u < cnt) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float ds =
              expf(sc[j] * h.scale - lse_r[j]) * (da[j] * kp[u][j] - dsum[j]) * h.scale;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[j * VEC + i] += ds * kf[j * VEC + i];
        }
      }
    }
  });

  if (t.hub && !merge_sums(acc, scratch, warp, lane)) return;
  store_row<T, NS, VEC>(dQ + t.row * m.HD, acc, lm);
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (lm.leader[j]) D[t.row * m.H + lm.head[j]] = dsum[j];
}

template <typename T, int NS, int VEC, int U>
__global__ void __launch_bounds__(kBlock)
gat_backward_src_kernel(SideArgs s, HeadArgs h, const T* __restrict__ Q,
                        const T* __restrict__ K, const T* __restrict__ V,
                        const T* __restrict__ dy, const float* __restrict__ lse,
                        const float* __restrict__ D, T* __restrict__ dK,
                        T* __restrict__ dV, float* __restrict__ scratch) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const HeadMap m(h.H, h.d, VEC);
  const Task t = resolve(s, m, warp);  // t.row is a source column here
  if (!t.active) return;
  const LaneMap<NS, VEC> lm(m, t.task, lane);
  constexpr int N = NS * VEC;
  float k[N], v[N], acc[2 * N];  // acc[0, N): dK, acc[N, 2N): dV
  load_row<T, NS, VEC>(k, K + t.row * m.HD, lm);
  load_row<T, NS, VEC>(v, V + t.row * m.HD, lm);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) acc[i] = 0.f;

  for_edge_batches<U>(s, h, t.e0, t.e1, lane, [&](const auto& r, const auto& e, int cnt) {
    RawT<T, VEC> qr[U][NS], gr[U][NS];
    float kp[U][NS], lse_u[U][NS], d_u[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = u < cnt;
      load_raw<T, NS, VEC>(qr[u], Q + static_cast<size_t>(r[u]) * m.HD, lm, ok);
      load_raw<T, NS, VEC>(gr[u], dy + static_cast<size_t>(r[u]) * m.HD, lm, ok);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        kp[u][j] = keep_of(h, e[u], lm.head[j], ok);
        lse_u[u][j] = stat_of(lse, h, r[u], lm.head[j], ok);
        d_u[u][j] = stat_of(D, h, r[u], lm.head[j], ok);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float qf[N], gf[N], sc[NS], da[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        unpack<T, VEC>(qr[u][j], qf + j * VEC);
        unpack<T, VEC>(gr[u][j], gf + j * VEC);
      }
      head_dots<NS, VEC>(sc, qf, k, m);
      head_dots<NS, VEC>(da, gf, v, m);
      if (u < cnt) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float a = expf(sc[j] * h.scale - lse_u[u][j]);
          const float ds = a * (da[j] * kp[u][j] - d_u[u][j]) * h.scale;
          const float w = a * kp[u][j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[j * VEC + i] += ds * qf[j * VEC + i];
            acc[N + j * VEC + i] += w * gf[j * VEC + i];
          }
        }
      }
    }
  });

  if (t.hub && !merge_sums(acc, scratch, warp, lane)) return;
  store_row<T, NS, VEC>(dK + t.row * m.HD, acc, lm);
  store_row<T, NS, VEC>(dV + t.row * m.HD, acc + N, lm);
}

// floats of hub scratch per warp and lane, for pass 0 (forward), 1 or 2
__host__ __device__ constexpr int scratch_slots(int pass, int ns, int vec) {
  return pass == 0 ? ns * (vec + 2) : pass == 1 ? ns * vec : 2 * ns * vec;
}

unsigned grid_of(const SideArgs& s, const HeadMap& m) {
  const long long warps = static_cast<long long>(s.num_rows) * m.tasks;
  return static_cast<unsigned>(static_cast<long long>(s.num_hubs) * m.tasks +
                               (warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// pass: 0 forward, 1 backward destination side, 2 backward source side
template <typename T, int NS, int VEC>
void launch_pass(int pass, unsigned grid, cudaStream_t st, const SideArgs& s, const HeadArgs& h,
                 const void* const* in, void* const* outs, float* scratch) {
  constexpr int U = NS == 1 ? 4 : 2;  // edges per batch
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  if (pass == 0) {
    gat_forward_kernel<T, NS, VEC, U><<<grid, kBlock, 0, st>>>(
        s, h, I(0), I(1), I(2), static_cast<T*>(outs[0]), static_cast<float*>(outs[1]),
        scratch);
  } else if (pass == 1) {
    gat_backward_dst_kernel<T, NS, VEC, U><<<grid, kBlock, 0, st>>>(
        s, h, I(0), I(1), I(2), I(3), I(4), static_cast<const float*>(in[5]),
        static_cast<T*>(outs[0]), static_cast<float*>(outs[1]), scratch);
  } else {
    gat_backward_src_kernel<T, NS, VEC, U><<<grid, kBlock, 0, st>>>(
        s, h, I(0), I(1), I(2), I(3), static_cast<const float*>(in[4]),
        static_cast<const float*>(in[5]), static_cast<T*>(outs[0]),
        static_cast<T*>(outs[1]), scratch);
  }
}

template <typename T, int VEC>
void launch_vec(int pass, const HeadMap& m, unsigned grid, cudaStream_t st, const SideArgs& s,
                const HeadArgs& h, const void* const* in, void* const* outs, float* scratch) {
  if (m.slices == 1) {
    launch_pass<T, 1, VEC>(pass, grid, st, s, h, in, outs, scratch);
  } else {
    launch_pass<T, kMaxSlices, VEC>(pass, grid, st, s, h, in, outs, scratch);
  }
}

template <typename T>
int dispatch(int pass, int max_vec_bytes, const SideArgs& s, const HeadArgs& h,
             const void* const* in, void* const* outs, float* scratch, cudaStream_t st) {
  const int vec = pick_vec(h.d, static_cast<int>(sizeof(T)), max_vec_bytes);
  const HeadMap m(h.H, h.d, vec);
  if (!m.supported) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = grid_of(s, m);
  if (grid == 0) return static_cast<int>(cudaSuccess);
  switch (vec) {
    case 1: launch_vec<T, 1>(pass, m, grid, st, s, h, in, outs, scratch); break;
    case 2: launch_vec<T, 2>(pass, m, grid, st, s, h, in, outs, scratch); break;
    case 4: launch_vec<T, 4>(pass, m, grid, st, s, h, in, outs, scratch); break;
    default:
      if constexpr (sizeof(T) == 2) {
        launch_vec<T, 8>(pass, m, grid, st, s, h, in, outs, scratch);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(int pass, const void* row_ptr, const void* nbr, const void* eid, const void* hubs,
        int num_hubs, int num_rows, int hub_degree, int H, int d, float scale,
        const void* keep, int dtype, int max_vec_bytes, const void* const* in,
        void* const* outs, void* scratch, void* stream) {
  if (H <= 0 || d <= 0 || num_rows < 0 || num_hubs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SideArgs s{static_cast<const int*>(row_ptr), static_cast<const int*>(nbr),
                   static_cast<const int*>(eid), static_cast<const int*>(hubs),
                   num_hubs, num_rows, hub_degree};
  const HeadArgs h{H, d, scale, static_cast<const float*>(keep)};
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return dispatch<float>(pass, max_vec_bytes, s, h, in, outs, sc, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(pass, max_vec_bytes, s, h, in, outs, sc, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Floats of hub scratch that pass 0, 1 or 2 needs for these heads, element
// size and largest vector, or -1 when the head width is not supported (a
// head wider than 64 vectors).
extern "C" long long tfg_gat_scratch_floats(int pass, int num_hubs, int H, int d, int elt_bytes,
                                            int max_vec_bytes) {
  if (H <= 0 || d <= 0 || (elt_bytes != 2 && elt_bytes != 4)) return -1;
  const int vec = pick_vec(d, elt_bytes, max_vec_bytes);
  const HeadMap m(H, d, vec);
  if (!m.supported) return -1;
  return static_cast<long long>(num_hubs) * m.tasks * kWarpsPerBlock *
         scratch_slots(pass, m.slices, vec) * kWarp;
}

// Each returns cudaGetLastError() after its launch (0 on success). keep may
// be null; scratch may be null when num_hubs == 0. max_vec_bytes (16, 8, 4
// or 2) bounds the vector loads by the tensors' alignment.
extern "C" int tfg_gat_forward(const void* row_ptr, const void* nbr, const void* eid,
                               const void* hubs, int num_hubs, int num_rows, int hub_degree,
                               int H, int d, float scale, const void* keep, int dtype,
                               int max_vec_bytes, const void* Q, const void* K, const void* V,
                               void* out, void* lse, void* scratch, void* stream) {
  const void* in[] = {Q, K, V};
  void* outs[] = {out, lse};
  return run(0, row_ptr, nbr, eid, hubs, num_hubs, num_rows, hub_degree, H, d, scale, keep,
             dtype, max_vec_bytes, in, outs, scratch, stream);
}

extern "C" int tfg_gat_backward_dst(const void* row_ptr, const void* nbr, const void* eid,
                                    const void* hubs, int num_hubs, int num_rows,
                                    int hub_degree, int H, int d, float scale,
                                    const void* keep, int dtype, int max_vec_bytes,
                                    const void* Q, const void* K, const void* V,
                                    const void* out, const void* dy, const void* lse,
                                    void* dQ, void* D, void* scratch, void* stream) {
  const void* in[] = {Q, K, V, out, dy, lse};
  void* outs[] = {dQ, D};
  return run(1, row_ptr, nbr, eid, hubs, num_hubs, num_rows, hub_degree, H, d, scale, keep,
             dtype, max_vec_bytes, in, outs, scratch, stream);
}

extern "C" int tfg_gat_backward_src(const void* row_ptr, const void* nbr, const void* eid,
                                    const void* hubs, int num_hubs, int num_rows,
                                    int hub_degree, int H, int d, float scale,
                                    const void* keep, int dtype, int max_vec_bytes,
                                    const void* Q, const void* K, const void* V,
                                    const void* dy, const void* lse, const void* D, void* dK,
                                    void* dV, void* scratch, void* stream) {
  const void* in[] = {Q, K, V, dy, lse, D};
  void* outs[] = {dK, dV};
  return run(2, row_ptr, nbr, eid, hubs, num_hubs, num_rows, hub_degree, H, d, scale, keep,
             dtype, max_vec_bytes, in, outs, scratch, stream);
}
