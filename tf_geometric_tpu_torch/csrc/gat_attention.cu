// GAT attention over a CSR graph: the forward kernel and the two backward
// kernels (destination side: dQ, D and the per-edge weights w; source side:
// dK and dV from w).
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
// [E, H] float32 (the dropout mask, its 1/(1 - rate) scale included) and w
// [E, 2H] float32, both indexed by edge id. The destination side has N rows
// whose neighbours are source rows, the source side S rows whose neighbours
// are destination rows. Sums run in float32.
//
//   forward, per destination row r and head h, over r's in-edges e = (r <- c):
//     s_e    = <Q[r], K[c]>_h / sqrt(d)
//     lse[r] = max_e s_e + log(sum_e exp(s_e - max_e s_e) + 1e-16)
//     out[r] = sum_e a_e keep_e V[c],   a_e = exp(s_e - lse[r])
//   (one pass: an online softmax keeps the running max and sum).
//   backward, destination side, per row r:
//     D[r]  = <dy[r], out[r]>_h          (= sum_e a_e da_e, no second pass)
//     da_e  = keep_e <dy[r], V[c]>_h,    ds_e = a_e (da_e - D[r]) / sqrt(d)
//     dQ[r] = sum_e ds_e K[c],           w[e] = [a_e keep_e (H) | ds_e (H)]
//   backward, source side, per column c over c's out-edges (r <- c):
//     dV[c] = sum_e w[e, h] dy[r],       dK[c] = sum_e w[e, H + h] Q[r]
//   (the JAX package's _flat_weights: the per-edge weights move from the
//   destination pass to the source pass instead of being computed twice).
// Every row of a side is written, so the outputs need no zero fill: a
// destination row without edges writes out = 0, lse = 0, dQ = 0 and D =
// <dy, 0> = 0, a source row without edges dK = dV = 0 (the halo layouts
// have many: padding rows, unaddressed received slots, nodes that are the
// source of no edge). w is written on the side's edges only.
//
// Bound on the H100: bytes. Each edge gathers two rows of H*d elements and
// does ~4 flops per gathered element, under the ~20 flops per byte where
// float32 FMA throughput would bind. The least traffic is each dense
// operand read once, each output written once, the row pointers and
// neighbour ids, lse / D, and under dropout the edge ids and the keep mask;
// w (E * 2H floats written, then read) is the design's, outside that bound.
//
// Forward design. A warp owns a row (for H * d up to 32 lanes x 2 slices x
// one vector, every row of the bench: one warp per row, all heads). Each
// lane holds VEC consecutive features of one head, loaded as one vector of
// up to 16 bytes, so a 256-wide bf16 row is one load instruction per warp;
// the lanes of a head are a power-of-two group, and a per-head dot product
// is VEC local products and an xor-shuffle reduction inside the group.
// Every lane of a head so holds its score and the online softmax state
// (running max and sum) without shared memory. Rows with more than
// hub_degree edges (29 on the arxiv graph, the largest 2,839) get a block of
// 8 warps, placed first in the grid so they start first; each warp walks one
// chunk of the row and warp 0 merges the chunks' states from a scratch buffer
// in a fixed order. No atomics: the result does not depend on scheduling.
//
// The forward and the destination pass walk a row's edges alike (EdgeRing,
// walk_edges): (1) when a row's heads take one slice of fewer than 32 lanes
// (H = 8, d = 8 and H = 1, d = 64 in float32: 16 lanes), the free lane
// groups take further edges of the row ("edge groups"); (2) each warp keeps
// the next batches' K and V rows (and keep values) in flight in a ring in
// shared memory filled by cp.async: 3 stages of 2 edges per edge group for
// one-slice rows (2 stages for two-slice rows), so batch b + 2 is loading
// while batch b is used, and the gathered rows take no registers while in
// flight; (3) the first 32 ids go out with the row's own loads. Why a ring
// and not registers: every register buffer costs resident warps on the
// H100. Before this design the forward held 4 edges' K and V in registers
// (76 registers at H = 8, d = 32, bf16: 24 warps per SM) and the destination
// pass 94 (16 warps); the ring fits both under a 4-block bound, 64 registers
// and 54 KB of shared memory a block: 32 resident warps per SM (PERF.md,
// section 6). In the forward each edge group keeps its own online softmax
// state; the groups' states merge before the store in a fixed xor butterfly:
// m' = max(m_a, m_b), each side's sum and accumulator scaled by exp(m - m')
// and added. A side without edges (m = -inf: a row with fewer edges than
// groups, or none) adds nothing, so an empty row still writes out = 0 and
// lse = 0. In the destination pass the groups' dQ partials are added by the
// same butterfly.
//
// Source-pass design: lane_gather.cuh's lane-group weighted gather with two
// outputs (the gather of spmm_heads_kernel): a group of L lanes owns a source
// row and adds, per entry, w[e, H + h] Q[r] and w[e, h] dy[r], with one read
// of the entry ids for both; no K, V, lse, D or keep reads, no dot products,
// no exp. A row with more than kChunk (64) entries is long and listed as a
// hub (the layout's source side has hub_degree = kChunk): it gets a block of
// its own, placed first in the grid, in the same launch. The block's first
// lane group sums the row's entries before its first chunk boundary while the
// other groups take the row's chunks round robin and write their float32
// partials to scratch; after a barrier the first group adds the partials in
// chunk order (RowSplit, as spmm_heads_kernel does). No atomics.
#include <math.h>

#include "lane_gather.cuh"

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

// a row's vectors as floats, slice j at x[j * VEC] (0 where the lane has none)
template <typename T, int NS, int VEC>
__device__ __forceinline__ void load_row(float* x, const T* __restrict__ row,
                                         const LaneMap<NS, VEC>& lm) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const RawT<T, VEC> r =
        lm.col[j] >= 0 ? *reinterpret_cast<const RawT<T, VEC>*>(row + lm.col[j]) : RawT<T, VEC>{};
    unpack<T, VEC>(r, x + j * VEC);
  }
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

// ---------------------------------------------------------------------------
// The destination side's edge walk, shared by the forward and the backward's
// destination pass: edge groups and a cp.async ring
// ---------------------------------------------------------------------------

// Edge groups one warp splits into: when a row's heads take one slice of
// fewer than 32 lanes, the free lane groups take further edges of the same
// row (at most kWarp / U groups, so a batch of U edges per group stays inside
// one 32-edge run of ids).
__host__ __device__ inline int edge_groups(const HeadMap& m, int U) {
  if (m.slices > 1) return 1;
  int lanes = 1;
  while (lanes < m.H * m.group) lanes <<= 1;
  return kWarp / (lanes > U ? lanes : U);
}

// One lane vector of B bytes copied from device to shared memory without
// passing through registers (cp.async; zero-filled and not read when !ok).
// cp.async copies 4, 8 or 16 bytes: a 2-byte vector goes through a register.
template <int B>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, bool ok) {
  if constexpr (B >= 4) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = ok ? B : 0;
    if constexpr (B == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                   "r"(n)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                   "n"(B), "r"(n)
                   : "memory");
    }
  } else {
    *static_cast<unsigned short*>(smem) = ok ? *static_cast<const unsigned short*>(gmem) : 0;
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's ring in shared memory: kStages stages of U edges per edge
// group, each edge's K and V vectors of every lane, then each edge's keep
// values; and where the lane sits. P edge groups of gl lanes split the warp
// (edge_groups); group grp's u-th edge of batch b of a run of ids is
// b U P + u P + grp. A lane copies and reads only its own slots, so the ring
// needs no barrier.
template <typename T, int NS, int VEC, int U>
struct EdgeRing {
  static constexpr int kStages = NS == 1 ? 3 : 2;
  static constexpr int kVecBytes = VEC * static_cast<int>(sizeof(T));
  static constexpr int kRowBytes = NS * kWarp * kVecBytes;  // one row's vectors, all lanes
  static constexpr int kRowsBytes = kStages * U * 2 * kRowBytes;
  static constexpr int kWarpBytes = kRowsBytes + kStages * U * NS * kWarp * 4;
  unsigned char* base;
  int lane, P, gl, grp;
  LaneMap<NS, VEC> lm;  // the lane's place in its edge group
  const T* K;
  const T* V;
  const float* keep;
  int H, HD;

  __device__ EdgeRing(unsigned char* smem, const HeadMap& m, int task, int lane_, const T* K_,
                      const T* V_, const HeadArgs& h)
      : base(smem), lane(lane_), P(edge_groups(m, U)), gl(kWarp / P), grp(lane_ / gl),
        lm(m, task, lane_ % gl), K(K_), V(V_), keep(h.keep), H(h.H), HD(m.HD) {}

  __device__ int step() const { return U * P; }
  __device__ int edge(int b, int u) const { return b * U * P + u * P + grp; }
  __device__ void* slot(int stage, int u, int kv, int j) const {
    return base + ((stage * U + u) * 2 + kv) * kRowBytes + (j * kWarp + lane) * kVecBytes;
  }
  __device__ float* keep_slot(int stage, int u, int j) const {
    return reinterpret_cast<float*>(base + kRowsBytes) + ((stage * U + u) * NS + j) * kWarp +
           lane;
  }

  // batch b of a run of n ids (this lane's c_lane, e_lane) into stage b % kStages
  __device__ void fetch(int b, int n, int c_lane, int e_lane) const {
    const int stage = b % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = edge(b, u);
      const bool ok = i < n;
      const int c = __shfl_sync(kFull, c_lane, i & (kWarp - 1));
      const int e = keep != nullptr ? __shfl_sync(kFull, e_lane, i & (kWarp - 1)) : 0;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bool vok = ok && lm.col[j] >= 0;
        const size_t off = static_cast<size_t>(c) * HD + (vok ? lm.col[j] : 0);
        copy_async<kVecBytes>(slot(stage, u, 0, j), K + off, vok);
        copy_async<kVecBytes>(slot(stage, u, 1, j), V + off, vok);
        if (keep != nullptr) {
          const bool kok = ok && lm.head[j] < H;
          copy_async<4>(keep_slot(stage, u, j),
                        keep + static_cast<size_t>(e) * H + (kok ? lm.head[j] : 0), kok);
        }
      }
    }
  }

  // edge u's K (kv 0) or V (kv 1) vectors in stage as floats, slice j at x[j VEC]
  __device__ void unpack_row(int stage, int u, int kv, float* x) const {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      unpack<T, VEC>(*static_cast<const RawT<T, VEC>*>(slot(stage, u, kv, j)), x + j * VEC);
  }
  __device__ float keep_of(int stage, int u, int j) const {
    return keep != nullptr ? *keep_slot(stage, u, j) : 1.f;
  }
};

// This lane's entry of the run of up to kWarp ids from base: its neighbour
// and, when with_eid, its edge id (both 0 past e1).
__device__ __forceinline__ void load_ids(const SideArgs& s, int base, int e1, int lane,
                                         bool with_eid, int& c, int& e) {
  c = e = 0;
  if (base + lane < e1) {
    c = s.nbr[base + lane];
    if (with_eid) e = s.eid[base + lane];
  }
}

// A task's edges through the ring, in runs of kWarp ids read coalesced (the
// first run loaded by the caller, with the row's own loads); in each run,
// batch b + kStages - 1 is in flight while consume(stage, b, n, e_lane) uses
// batch b of the run's n edges.
template <class Ring, class Consume>
__device__ __forceinline__ void walk_edges(const Ring& ring, const SideArgs& s, const Task& t,
                                           bool with_eid, int c_lane, int e_lane,
                                           Consume&& consume) {
  constexpr int kStages = Ring::kStages;
  const int step = ring.step();
  for (int base = t.e0; base < t.e1; base += kWarp) {
    if (base != t.e0) load_ids(s, base, t.e1, ring.lane, with_eid, c_lane, e_lane);
    const int n = min(kWarp, t.e1 - base);
    const int nb = (n + step - 1) / step;
#pragma unroll
    for (int b = 0; b < kStages - 1; ++b) {
      if (b < nb) ring.fetch(b, n, c_lane, e_lane);
      async_commit();
    }
    for (int b = 0; b < nb; ++b) {
      if (b + kStages - 1 < nb) ring.fetch(b + kStages - 1, n, c_lane, e_lane);
      async_commit();
      async_wait<kStages - 1>();
      consume(b % kStages, b, n, e_lane);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int NS, int VEC, int U>
__global__ void __launch_bounds__(kBlock, NS == 1 ? 4 : 3)
gat_forward_kernel(SideArgs s, HeadArgs h, const T* __restrict__ Q, const T* __restrict__ K,
                   const T* __restrict__ V, T* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ scratch) {
  using Ring = EdgeRing<T, NS, VEC, U>;
  extern __shared__ __align__(16) unsigned char ring_mem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const HeadMap m(h.H, h.d, VEC);
  const Task t = resolve(s, m, warp);
  if (!t.active) return;  // warp-uniform; never taken in a hub block
  // the edge ids only index the keep mask; the first run goes out with Q[r]
  const bool with_eid = h.keep != nullptr;
  int c_lane, e_lane;
  load_ids(s, t.e0, t.e1, lane, with_eid, c_lane, e_lane);
  const Ring ring(ring_mem + warp * Ring::kWarpBytes, m, t.task, lane, K, V, h);
  const LaneMap<NS, VEC>& lm = ring.lm;
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

  walk_edges(ring, s, t, with_eid, c_lane, e_lane, [&](int stage, int b, int n, int) {
    float sc[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NS * VEC];
      ring.unpack_row(stage, u, 0, kf);
      head_dots<NS, VEC>(sc[u], q, kf, m);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float* sj = st + j * W;
      float mnew = sj[0];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ring.edge(b, u) < n) mnew = fmaxf(mnew, sc[u][j] * h.scale);
      // 0 while the max was -inf; 1 (no NaN) while the group has no edge yet
      const float corr = mnew == sj[0] ? 1.f : expf(sj[0] - mnew);
#pragma unroll
      for (int i = 1; i < W; ++i) sj[i] *= corr;
      sj[0] = mnew;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ring.edge(b, u) < n) {
          const float p = expf(sc[u][j] * h.scale - mnew);
          sj[1] += p;
          const float w = p * ring.keep_of(stage, u, j);
          float vf[VEC];
          unpack<T, VEC>(*static_cast<const RawT<T, VEC>*>(ring.slot(stage, u, 1, j)), vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) sj[2 + i] += w * vf[i];
        }
      }
    }
  });

  // the edge groups' states, merged in a fixed butterfly order: each side's
  // sum and acc scaled by exp(its max - the larger max); a side without edges
  // (max -inf) adds nothing, and two such sides stay at -inf, 0
  for (int o = ring.gl; o < kWarp; o <<= 1) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float* sj = st + j * W;
      const float mo = __shfl_xor_sync(kFull, sj[0], o);
      const float mnew = fmaxf(sj[0], mo);
      const float f = sj[0] == -INFINITY ? 0.f : expf(sj[0] - mnew);
      const float fo = mo == -INFINITY ? 0.f : expf(mo - mnew);
#pragma unroll
      for (int i = 1; i < W; ++i) sj[i] = sj[i] * f + __shfl_xor_sync(kFull, sj[i], o) * fo;
      sj[0] = mnew;
    }
  }

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
  if (ring.grp != 0) return;

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

// ---------------------------------------------------------------------------
// Backward, destination side
// ---------------------------------------------------------------------------

template <typename T, int NS, int VEC, int U>
__global__ void __launch_bounds__(kBlock, NS == 1 ? 4 : 3)
gat_backward_dst_kernel(SideArgs s, HeadArgs h, const T* __restrict__ Q,
                        const T* __restrict__ K, const T* __restrict__ V,
                        const T* __restrict__ out, const T* __restrict__ dy,
                        const float* __restrict__ lse, T* __restrict__ dQ,
                        float* __restrict__ D, float* __restrict__ w,
                        float* __restrict__ scratch) {
  using Ring = EdgeRing<T, NS, VEC, U>;
  extern __shared__ __align__(16) unsigned char ring_mem[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const HeadMap m(h.H, h.d, VEC);
  const Task t = resolve(s, m, warp);
  if (!t.active) return;
  // the first run of ids goes out with the row's own loads
  int c_lane, e_lane;
  load_ids(s, t.e0, t.e1, lane, true, c_lane, e_lane);
  const Ring ring(ring_mem + warp * Ring::kWarpBytes, m, t.task, lane, K, V, h);
  const LaneMap<NS, VEC>& lm = ring.lm;
  const int li = lane % ring.gl;
  float q[NS * VEC], g[NS * VEC], acc[NS * VEC], dsum[NS], lse_r[NS];
  load_row<T, NS, VEC>(q, Q + t.row * m.HD, lm);
  load_row<T, NS, VEC>(g, dy + t.row * m.HD, lm);
  load_row<T, NS, VEC>(acc, out + t.row * m.HD, lm);
#pragma unroll
  for (int j = 0; j < NS; ++j) lse_r[j] = lm.head[j] < h.H ? lse[t.row * h.H + lm.head[j]] : 0.f;
  head_dots<NS, VEC>(dsum, g, acc, m);
#pragma unroll
  for (int k = 0; k < NS * VEC; ++k) acc[k] = 0.f;
  // the lanes that write a head's a * keep and ds: its first and its second
  // vector's lane (the first, when a head has one lane)
  bool put_a[NS], put_ds[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int vi = m.head_slices > 1 ? j * kWarp + li : li % m.group;
    const bool mine = lm.head[j] < m.H;
    put_a[j] = mine && vi == 0;
    put_ds[j] = mine && vi == (m.group > 1 ? 1 : 0);
  }

  walk_edges(ring, s, t, true, c_lane, e_lane, [&](int stage, int b, int n, int e_run) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = ring.edge(b, u);
      const bool ok = i < n;
      const int e = __shfl_sync(kFull, e_run, i & (kWarp - 1));
      float kf[NS * VEC], vf[NS * VEC], sc[NS], da[NS];
      ring.unpack_row(stage, u, 0, kf);
      ring.unpack_row(stage, u, 1, vf);
      head_dots<NS, VEC>(sc, q, kf, m);
      head_dots<NS, VEC>(da, g, vf, m);
      if (ok) {
        float* wrow = w + static_cast<size_t>(e) * 2 * m.H;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float kp = ring.keep_of(stage, u, j);
          const float a = expf(sc[j] * h.scale - lse_r[j]);
          const float ds = a * (da[j] * kp - dsum[j]) * h.scale;
          if (put_a[j]) wrow[lm.head[j]] = a * kp;
          if (put_ds[j]) wrow[m.H + lm.head[j]] = ds;
#pragma unroll
          for (int i2 = 0; i2 < VEC; ++i2) acc[j * VEC + i2] += ds * kf[j * VEC + i2];
        }
      }
    }
  });

  // the edge groups' partials, added in a fixed butterfly order
  for (int o = ring.gl; o < kWarp; o <<= 1) {
#pragma unroll
    for (int k = 0; k < NS * VEC; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
  }
  if (t.hub && !merge_sums(acc, scratch, warp, lane)) return;
  if (ring.grp != 0) return;
  store_row<T, NS, VEC>(dQ + t.row * m.HD, acc, lm);
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (lm.leader[j]) D[t.row * m.H + lm.head[j]] = dsum[j];
}

// ---------------------------------------------------------------------------
// Backward, source side: a two-output weighted gather
// ---------------------------------------------------------------------------

// One lane group of L = 2^lanes_log2 lanes per source row (g.F = H d, w
// [E, 2H]: output 0 is dK from Q by w[e, H + h], output 1 dV from dy by
// w[e, h]). A row of more than kChunk entries is a hub and is summed by a
// block of its own, placed first in the grid (see the header); partial
// [ceil(nnz / kChunk), 2 H d] float32 scratch holds its chunks' sums, which
// the first lane group adds one at a time (a hub's few dozen partials do not
// pay for the registers of more in flight).
template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock, 3)
gat_backward_src_kernel(SideArgs s, Gather<T, 2> g, T* __restrict__ dK, T* __restrict__ dV,
                        float* partial, int lanes_log2) {
  const int nvec = g.F / VEC;
  const int groups = kBlock >> lanes_log2;
  const int group = threadIdx.x >> lanes_log2;
  const bool hub = blockIdx.x < static_cast<unsigned>(s.num_hubs);
  GroupLane gl = group_lane(lanes_log2);
  if (hub) {
    gl.g = s.hubs[blockIdx.x];
  } else {
    gl.g = (static_cast<long long>(blockIdx.x) - s.num_hubs) * groups + group;
    if (gl.g >= s.num_rows) return;  // no barrier below outside hub blocks: lanes may leave
  }
  const int start = s.row_ptr[gl.g];
  const int end = s.row_ptr[gl.g + 1];
  if (!hub && end - start > kChunk) return;  // a hub block owns the row
  for (int v0 = 0; v0 < nvec; v0 += gl.L * NV) {
    float acc[2][NV * VEC] = {};
    if (!hub) {
      add_entries<T, VEC, NV, U, 2>(acc, gl, v0, nvec, start, end, g);
    } else {
      const RowSplit split(start, end);
      if (group == 0) {
        add_entries<T, VEC, NV, U, 2>(acc, gl, v0, nvec, start, split.direct_end, g);
      } else {
        for (int c = split.c_lo + group - 1; c < split.c_hi; c += groups - 1) {
          const int lo = c * kChunk;
          add_entries<T, VEC, NV, U, 2>(acc, gl, v0, nvec, lo, min(end, lo + kChunk), g);
          float* const prow[2] = {partial + static_cast<size_t>(c) * 2 * g.F,
                                  partial + (static_cast<size_t>(c) * 2 + 1) * g.F};
          store_rows<float, VEC, NV, 2>(prow, acc, gl, v0, nvec);
#pragma unroll
          for (int i = 0; i < NV * VEC; ++i) acc[0][i] = acc[1][i] = 0.f;
        }
      }
      __syncthreads();  // the chunks' partials of this pass are written
      if (group != 0) continue;  // each pass writes other columns: no second barrier
      add_partials<VEC, NV, 1, 2>(acc, gl, v0, nvec, split.c_lo, split.c_hi, partial, g.F);
    }
    T* const rows[2] = {dK + gl.g * g.F, dV + gl.g * g.F};
    store_rows<T, VEC, NV, 2>(rows, acc, gl, v0, nvec);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the source pass's lanes per row (log2) and vectors per lane and pass
struct SrcPlan {
  int ll, nv;
};

inline SrcPlan src_plan(int H, int d, int vec) {
  const int nvec = H * d / vec;
  const int ll = pick_lanes_log2(nvec);
  return {ll, pick_nv(nvec, 1 << ll)};
}

// floats of hub scratch for pass 0 (forward) or 1, per warp and lane
__host__ __device__ constexpr int scratch_slots(int pass, int ns, int vec) {
  return pass == 0 ? ns * (vec + 2) : ns * vec;
}

unsigned grid_of(const SideArgs& s, const HeadMap& m) {
  const long long warps = static_cast<long long>(s.num_rows) * m.tasks;
  return static_cast<unsigned>(static_cast<long long>(s.num_hubs) * m.tasks +
                               (warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// registers per thread and resident warps per SM of one kernel instance
struct KernelInfo {
  int regs;
  int warps_per_sm;
};

template <class Kernel>
void query(Kernel kernel, KernelInfo* info, int smem = 0) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlock, smem);
  info->regs = a.numRegs;
  info->warps_per_sm = blocks * kWarpsPerBlock;
}

// pass 0 (forward) or 1 (backward, destination side); with info set, the
// instance that would launch is queried, not launched
template <typename T, int NS, int VEC>
void launch_pass(int pass, unsigned grid, cudaStream_t st, const SideArgs& s, const HeadArgs& h,
                 const void* const* in, void* const* outs, float* scratch, KernelInfo* info) {
  constexpr int U = 2;  // edges per stage and edge group
  constexpr int smem = EdgeRing<T, NS, VEC, U>::kWarpBytes * kWarpsPerBlock;
  const auto fwd = gat_forward_kernel<T, NS, VEC, U>;
  const auto dst = gat_backward_dst_kernel<T, NS, VEC, U>;
  static const bool sized =
      cudaFuncSetAttribute(fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ==
          cudaSuccess &&
      cudaFuncSetAttribute(dst, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess;
  (void)sized;
  auto I = [&](int i) { return static_cast<const T*>(in[i]); };
  if (pass == 0) {
    if (info != nullptr) return query(fwd, info, smem);
    fwd<<<grid, kBlock, smem, st>>>(s, h, I(0), I(1), I(2), static_cast<T*>(outs[0]),
                                    static_cast<float*>(outs[1]), scratch);
  } else {
    if (info != nullptr) return query(dst, info, smem);
    dst<<<grid, kBlock, smem, st>>>(s, h, I(0), I(1), I(2), I(3), I(4),
                                    static_cast<const float*>(in[5]), static_cast<T*>(outs[0]),
                                    static_cast<float*>(outs[1]), static_cast<float*>(outs[2]),
                                    scratch);
  }
}

template <typename T, int VEC, int NV>
void launch_src_nv(unsigned grid, cudaStream_t st, const SideArgs& s, const HeadArgs& h,
                   const void* const* in, void* const* outs, float* scratch, int ll,
                   KernelInfo* info) {
  constexpr int U = unroll_for(NV, 2);
  if (info != nullptr) return query(gat_backward_src_kernel<T, VEC, NV, U>, info);
  const int F = h.H * h.d;
  const Gather<T, 2> g{s.nbr, s.eid, static_cast<const float*>(in[2]), 2 * h.H, {h.H, 0},
                       {static_cast<const T*>(in[0]), static_cast<const T*>(in[1])}, F,
                       h.d / VEC};
  gat_backward_src_kernel<T, VEC, NV, U><<<grid, kBlock, 0, st>>>(
      s, g, static_cast<T*>(outs[0]), static_cast<T*>(outs[1]), scratch, ll);
}

template <typename T, int VEC>
void launch_vec(int pass, const HeadMap& m, unsigned grid, cudaStream_t st, const SideArgs& s,
                const HeadArgs& h, const void* const* in, void* const* outs, float* scratch,
                KernelInfo* info) {
  if (pass == 2) {
    const SrcPlan p = src_plan(h.H, h.d, VEC);
    if (p.nv == 1) launch_src_nv<T, VEC, 1>(grid, st, s, h, in, outs, scratch, p.ll, info);
    else if (p.nv == 2) launch_src_nv<T, VEC, 2>(grid, st, s, h, in, outs, scratch, p.ll, info);
    else launch_src_nv<T, VEC, 4>(grid, st, s, h, in, outs, scratch, p.ll, info);
  } else if (m.slices == 1) {
    launch_pass<T, 1, VEC>(pass, grid, st, s, h, in, outs, scratch, info);
  } else {
    launch_pass<T, kMaxSlices, VEC>(pass, grid, st, s, h, in, outs, scratch, info);
  }
}

template <typename T>
int dispatch(int pass, int max_vec_bytes, const SideArgs& s, const HeadArgs& h,
             const void* const* in, void* const* outs, float* scratch, cudaStream_t st,
             KernelInfo* info = nullptr) {
  const int vec = pick_vec(h.d, static_cast<int>(sizeof(T)), max_vec_bytes);
  const HeadMap m(h.H, h.d, vec);
  if (!m.supported) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      pass == 2 ? static_cast<unsigned>(s.num_hubs) +
                      grid_for_groups(s.num_rows, src_plan(h.H, h.d, vec).ll)
                : grid_of(s, m);
  if (grid == 0 && info == nullptr) return static_cast<int>(cudaSuccess);
  switch (vec) {
    case 1: launch_vec<T, 1>(pass, m, grid, st, s, h, in, outs, scratch, info); break;
    case 2: launch_vec<T, 2>(pass, m, grid, st, s, h, in, outs, scratch, info); break;
    case 4: launch_vec<T, 4>(pass, m, grid, st, s, h, in, outs, scratch, info); break;
    default:
      if constexpr (sizeof(T) == 2) {
        launch_vec<T, 8>(pass, m, grid, st, s, h, in, outs, scratch, info);
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
// size and largest vector over a side of num_entries entries, or -1 when the
// head width is not supported (a head wider than 64 vectors). Pass 2 keeps
// one partial of its two outputs per kChunk entries of the side.
extern "C" long long tfg_gat_scratch_floats(int pass, int num_hubs, int H, int d, int elt_bytes,
                                            int max_vec_bytes, int num_entries) {
  if (H <= 0 || d <= 0 || num_entries < 0 || (elt_bytes != 2 && elt_bytes != 4)) return -1;
  const int vec = pick_vec(d, elt_bytes, max_vec_bytes);
  const HeadMap m(H, d, vec);
  if (!m.supported) return -1;
  if (pass == 2)
    return num_hubs == 0 ? 0
                         : static_cast<long long>((num_entries + kChunk - 1) / kChunk) * 2 * H * d;
  return static_cast<long long>(num_hubs) * m.tasks * kWarpsPerBlock *
         scratch_slots(pass, m.slices, vec) * kWarp;
}

// Registers per thread and resident warps per SM of the instance that pass
// 0, 1 or 2 would launch for these heads, dtype and largest vector; returns
// cudaGetLastError() (0 on success).
extern "C" int tfg_gat_kernel_info(int pass, int H, int d, int dtype, int max_vec_bytes,
                                   int* regs, int* warps_per_sm) {
  if (H <= 0 || d <= 0 || pass < 0 || pass > 2) return static_cast<int>(cudaErrorInvalidValue);
  const SideArgs s{nullptr, nullptr, nullptr, nullptr, 0, 0, 0};
  const HeadArgs h{H, d, 1.f, nullptr};
  KernelInfo info{0, 0};
  const int rc = dtype == kFloat32
                     ? dispatch<float>(pass, max_vec_bytes, s, h, nullptr, nullptr, nullptr,
                                       nullptr, &info)
                 : dtype == kBFloat16
                     ? dispatch<__nv_bfloat16>(pass, max_vec_bytes, s, h, nullptr, nullptr,
                                               nullptr, nullptr, &info)
                     : static_cast<int>(cudaErrorInvalidValue);
  *regs = info.regs;
  *warps_per_sm = info.warps_per_sm;
  return rc;
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

// w float32 [E, 2H]: w[e, h] = a_e keep_e and w[e, H + h] = ds_e for every
// edge e of the side (rows of edges outside the layout are not written).
extern "C" int tfg_gat_backward_dst(const void* row_ptr, const void* nbr, const void* eid,
                                    const void* hubs, int num_hubs, int num_rows,
                                    int hub_degree, int H, int d, float scale,
                                    const void* keep, int dtype, int max_vec_bytes,
                                    const void* Q, const void* K, const void* V,
                                    const void* out, const void* dy, const void* lse,
                                    void* dQ, void* D, void* w, void* scratch, void* stream) {
  const void* in[] = {Q, K, V, out, dy, lse};
  void* outs[] = {dQ, D, w};
  return run(1, row_ptr, nbr, eid, hubs, num_hubs, num_rows, hub_degree, H, d, scale, keep,
             dtype, max_vec_bytes, in, outs, scratch, stream);
}

// dK and dV [S, H d] from Q and dy [N, H d] and the destination pass's w;
// the side is the source side, whose hubs are its rows of more than
// hub_degree = kChunk entries; scale and keep are not read (w holds them).
extern "C" int tfg_gat_backward_src(const void* row_ptr, const void* nbr, const void* eid,
                                    const void* hubs, int num_hubs, int num_rows,
                                    int hub_degree, int H, int d, float scale,
                                    const void* keep, int dtype, int max_vec_bytes,
                                    const void* Q, const void* dy, const void* w, void* dK,
                                    void* dV, void* scratch, void* stream) {
  if (hub_degree != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[] = {Q, dy, w};
  void* outs[] = {dK, dV};
  return run(2, row_ptr, nbr, eid, hubs, num_hubs, num_rows, hub_degree, H, d, scale, keep,
             dtype, max_vec_bytes, in, outs, scratch, stream);
}
