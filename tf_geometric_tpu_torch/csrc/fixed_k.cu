// Fixed-k neighbour sampling and aggregation: the draw, the aggregation
// forward and its backward.
//
// Replaces:
//   draw      tf_geometric_tpu/nn/sampling/device_sampler.py, draw_fixed_k
//             (everything after jax.random.randint: the pick, the gather of
//             sorted_col, self ids for isolated rows, the weight gather or
//             the broadcast of the row's liveness);
//   forward   tf_geometric_tpu/nn/conv/graph_sage.py, _fixed_k_reduce (the
//             slot loop: acc[s] = sum_j w[j, s] * src[idx[j, s]]);
//   backward  its gradient, d_src[c] = sum of w[j, s] * dy[s] over the
//             slots that drew c.
//
// Layouts: the draw is slot-major, idx int32 [k, S] and w float32 [k, S]
// (slot j of row s at j * S + s). src, out and dy are [rows, F] row-major,
// float32 or bfloat16; d_src is float32 [n, F]. Indices are clamped to
// [0, n - 1] before any gather or count, as the JAX function clips them.
// Sums run in float32.
//
// Bound on the H100: bytes. The draw moves ~16 bytes per slot (the integer
// read, idx and w written, the picked column read). Each aggregation slot gathers one row of F
// elements for 2 * F flops, far under the ~20 flops per byte where float32
// FMA throughput would bind. A gather reads a row per slot, and the table
// it reads (the forward's src, the backward's dy: 119 MB at Reddit's
// 232,965 rows of 128 float32) is larger than the 50 MB L2, so the slots'
// rows come from device memory in good part.
//
// Design.
// - Draw: one thread per row, walking the row's k slots (slot j of row s at
//   j * S + s, so a warp's reads of r and writes of idx and w stay
//   coalesced): the row's degree and start are read once, and its remainders
//   take one exact reciprocal computed once per row (row_divisor), not a
//   division per slot; kDrawUnroll slots' column gathers are in flight at
//   once, and the next kDrawUnroll integers are loaded while they land. The
//   integers are read and idx, w written with streaming (evict-first)
//   accesses, so the column table keeps its place in L2. The remainder,
//   the clip, the column gather and the weight write are one pass, so no
//   [k, S] pick array ever reaches device memory.
//   Device ms at k = 25 on the Reddit-shaped graph (H100 80GB HBM3, 700 W,
//   chip_smoke.py --trial / --against in turns): this design ~0.059. The
//   one it replaced: one thread per slot over a grid-stride loop, a 64-bit
//   i % S and a 32-bit r % deg per slot, degree and start read per slot:
//   0.130 (0.036 of it without the column gather). Tried and lost: no
//   streaming accesses 0.067; 4 gathers in flight under an 8-block launch
//   bound (32 registers) 0.112-0.117; a 5-block bound 0.068; 12 in flight
//   0.073; the block's stretch of sorted_col staged in shared memory with
//   one coalesced read (111 registers) 0.061-0.062.
// - Forward (fixed_k_gather_kernel): a group of L lanes owns one output row
//   (L = 32 for a row of 32 or more lane vectors, else the next power of
//   two, so several narrow rows share a warp). Each lane holds vectors of
//   VEC elements, up to 16 bytes, so a 128-wide float32 row is one load
//   instruction per warp. The group's lanes read the row's slot ids and
//   weights (one each, L at a time) and broadcast them by shuffle; U slots'
//   rows are loaded before any is added, so U gathers per lane are in
//   flight. Rows wider than L * NV vectors take several passes.
// - Backward: d_src[c] has a writer for every slot that drew c. Float32
//   atomics would be bound by the L2's atomic rate over a target larger
//   than the L2 (measured at 2.9x the forward's time on the same bytes),
//   and their order, so the float32 sum, would change from run to run. So
//   the draw is transposed by source tile, then gathered tile by tile:
//   1. One stable radix pass buckets the slots by source tile, c % tiles
//      (tile t holds sources t, t + tiles, ...: round robin, so sources
//      that are drawn often and sit together in id order, the hubs of a
//      skewed graph, spread over the tiles; at most 512 sources a tile, as
//      many tiles as fill whole waves of tile blocks: 921 on Reddit's
//      232,965 sources; digits of at most 10 bits, so one pass up to 1,024
//      tiles, more passes beyond): count each 8,192-slot stretch's digits,
//      scan the [digit, stretch] counts in three launches, scatter each
//      slot to its digit's offset plus its rank among the stretch's earlier
//      slots of that digit (ranks by one ballot per digit bit, in slot
//      order: stable), through a shared-memory stage so each digit's run is
//      written in consecutive places. A slot goes out as its key and its
//      (destination row, weight) pair. The scanned table's column 0 gives
//      each tile's run (after several passes, one more launch finds them).
//   2. fixed_k_tile_kernel, one 1,024-thread block per tile: holds up to
//      8,192 slots of the tile's run in registers (8 a thread, in slot
//      order), ranks them by local source the same way (per-warp counts,
//      one scan), which gives the tile's row pointers, and places their
//      pairs in shared memory in source order. Its lane groups then gather
//      w * dy rows into each source's row as the forward does. A source
//      with more than kSplit = 64 slots is cut into 64-slot segments walked
//      by different lane groups; their partials go through shared memory
//      and are added in segment order (a carry holds a row that spans two
//      rounds of segments). A longer run is taken in chunks, each chunk's
//      sums added to the rows the chunk before stored.
//   Both sorts are stable, so each source's slots keep slot order: a row
//   of at most 64 slots sums in exactly the order of a serial walk, and
//   every row's sum runs in one order in every run: the backward is
//   bitwise reproducible. Six launches a call up to 1,024 tiles.
#include "common.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;
constexpr int kDrawUnroll = 8;  // the draw's column gathers in flight a thread

// ---------------------------------------------------------------------------
// draw
// ---------------------------------------------------------------------------

// r mod d with the divisor's sign (torch.remainder, jnp's %) for any int32 r
// and 1 <= d < 2^31, by one exact reciprocal per row: with l = ceil(log2
// d), m = ceil(2^(31 + l) / d) < 2^32 gives floor(u / d) = (u * m) >>
// (31 + l) for every u < 2^31 (the round-up method: m * d - 2^(31 + l) <
// d <= 2^l). A negative r is taken as u = -r - 1 = ~r, whose remainder
// mirrors: r mod d = d - 1 - (u mod d). ops/fixed_k.py reciprocal_remainder
// is the same arithmetic in numpy.
struct RowDivisor {
  unsigned m;
  int shift;
};

__device__ __forceinline__ RowDivisor row_divisor(int d) {
  const int l = 32 - __clz(d - 1);  // d = 1: l = 0
  return {static_cast<unsigned>(((1ull << (31 + l)) + static_cast<unsigned>(d) - 1) /
                                static_cast<unsigned>(d)),
          31 + l};
}

__device__ __forceinline__ int remainder_by(int r, int d, RowDivisor rd) {
  const unsigned u = static_cast<unsigned>(r ^ (r >> 31));
  const unsigned q = static_cast<unsigned>((static_cast<unsigned long long>(u) * rd.m) >> rd.shift);
  const int rho = static_cast<int>(u - q * static_cast<unsigned>(d));
  return r < 0 ? d - 1 - rho : rho;
}

// One thread owns row s and walks its k slots j * S + s: neighbouring
// threads read r and write idx, w at neighbouring addresses (coalesced);
// the row's degree and start are read once and its divisor is computed
// once; U slots' column gathers are in flight together.
template <int U>
__global__ void __launch_bounds__(kBlock)
fixed_k_draw_kernel(const int* __restrict__ r, const int* __restrict__ row_start,
                    const int* __restrict__ degree, const int* __restrict__ sorted_col,
                    const float* __restrict__ sorted_weight, const int* __restrict__ self_ids,
                    int* __restrict__ idx, float* __restrict__ weight, int S, int k, int nnz) {
  const int s = blockIdx.x * kBlock + threadIdx.x;
  if (s >= S) return;
  const int deg = degree[s];
  if (deg == 0) {  // isolated: points at itself with weight 0
    const int self = self_ids != nullptr ? self_ids[s] : s;
    for (int j = 0; j < k; ++j) {
      idx[static_cast<long long>(j) * S + s] = self;
      weight[static_cast<long long>(j) * S + s] = 0.f;
    }
    return;
  }
  const int d = max(deg, 1);  // the plain version's clamp of the divisor
  const RowDivisor rd = row_divisor(d);
  const long long start = row_start[s];
  const long long last = max(nnz - 1, 0);
  int nx[U];
#pragma unroll
  for (int u = 0; u < U; ++u) nx[u] = u < k ? __ldcs(r + static_cast<long long>(u) * S + s) : 0;
  for (int j0 = 0; j0 < k; j0 += U) {
    int rv[U], col[U];
    float wv[U];
    long long pick[U];
#pragma unroll
    for (int u = 0; u < U; ++u) rv[u] = nx[u];
#pragma unroll
    for (int u = 0; u < U; ++u)
      nx[u] = j0 + U + u < k ? __ldcs(r + static_cast<long long>(j0 + U + u) * S + s) : 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      pick[u] = min(max(start + remainder_by(rv[u], d, rd), 0LL), last);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < k) {
        col[u] = nnz > 0 ? sorted_col[pick[u]] : 0;
        wv[u] = sorted_weight == nullptr ? 1.f : nnz > 0 ? sorted_weight[pick[u]] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < k) {
        __stcs(idx + static_cast<long long>(j0 + u) * S + s, col[u]);
        __stcs(weight + static_cast<long long>(j0 + u) * S + s, wv[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the forward gather
// ---------------------------------------------------------------------------

// Where one lane sits: its row, its lane within the row's group, whether
// the row exists (lanes of a missing row still join the shuffles).
struct RowLane {
  long long s;
  int lig;
  bool valid;
};

__device__ __forceinline__ RowLane row_lane(int lanes_log2, int rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warp = (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  RowLane rl;
  const long long s = warp * (kWarp >> lanes_log2) + (lane >> lanes_log2);
  rl.lig = lane & ((1 << lanes_log2) - 1);
  rl.valid = s < rows;
  rl.s = rl.valid ? s : rows - 1;
  return rl;
}

// out[s] = sum_j w[j, s] * src[clamp(idx[j, s])] over row s's k slots of the
// slot-major draw (slot j at j * rows + s).
template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
fixed_k_gather_kernel(const T* __restrict__ src, int n_src, const int* __restrict__ ids,
                      const float* __restrict__ wts, int k, T* __restrict__ out, int rows, int F,
                      int lanes_log2) {
  const RowLane rl = row_lane(lanes_log2, rows);
  const int L = 1 << lanes_log2;
  const int nvec = F / VEC;
  const int count = rl.valid ? k : 0;
  const int most = __reduce_max_sync(kFull, count);  // the warp's loop bound
  for (int v0 = 0; v0 < nvec; v0 += L * NV) {
    float acc[NV * VEC];
#pragma unroll
    for (int i = 0; i < NV * VEC; ++i) acc[i] = 0.f;
    for (int base = 0; base < most; base += L) {
      // lane lig holds slot base + lig's clamped id and weight
      int c_lane = 0;
      float w_lane = 0.f;
      if (base + rl.lig < count) {
        const size_t off = static_cast<size_t>((base + rl.lig) * static_cast<long long>(rows) +
                                               rl.s);
        c_lane = min(max(ids[off], 0), n_src - 1);
        w_lane = wts[off];
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
          const T* row = src + static_cast<size_t>(c) * F;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int v = v0 + q * L + rl.lig;
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
    if (!rl.valid) continue;
    T* orow = out + static_cast<size_t>(rl.s) * F;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int v = v0 + q * L + rl.lig;
      if (v < nvec) store_vec<T, VEC>(orow + v * VEC, acc + q * VEC);
    }
  }
}

// ---------------------------------------------------------------------------
// the tile kernel's pieces: a lane group's sum over a list of (table row,
// weight bits) pairs in shared memory, a block scan, a warp's peers
// ---------------------------------------------------------------------------

// acc = sum over pairs sp[0 .. count) of weight * table[row], in list order,
// for the lane's vectors v0 + q * L + lig (q < NV). U rows are loaded before
// any is added: U gathers per lane in flight. The adds run in the order of
// fixed_k_gather_kernel's, so one list sums to the same bits in both.
template <typename T, int VEC, int NV, int U>
__device__ __forceinline__ void gather_list(const T* __restrict__ table, int n_table,
                                            const int2* sp, int count, int v0, int L, int lig,
                                            int nvec, int F, float* acc) {
#pragma unroll
  for (int i = 0; i < NV * VEC; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < count; j0 += U) {
    RawT<T, VEC> raw[U][NV];
    float wu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = j0 + u < count;
      const int2 pr = ok ? sp[j0 + u] : make_int2(0, 0);
      wu[u] = ok ? __int_as_float(pr.y) : 0.f;
      const T* row = table + static_cast<size_t>(min(max(pr.x, 0), n_table - 1)) * F;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        const int v = v0 + q * L + lig;
        raw[u][q] = (ok && v < nvec) ? *reinterpret_cast<const RawT<T, VEC>*>(row + v * VEC)
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

// Inclusive prefix sum of v over a block of THREADS threads; *total gets
// the block's sum. Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* total) {
  constexpr int kWarps = THREADS / kWarp;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == kWarp - 1) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int u = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += u;
    }
    if (lane < kWarps) warp_sums[lane] = x;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// The lanes of the warp whose d equals this lane's (among lanes with ok),
// by one ballot per bit of d's bits: its cost does not grow with the number
// of distinct values in the warp, as __match_any_sync's does.
__device__ __forceinline__ unsigned peers_of(int d, int bits, bool ok) {
  unsigned peers = __ballot_sync(kFull, ok);
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(kFull, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? set : ~set;
  }
  return peers;
}

// ---------------------------------------------------------------------------
// the backward's transpose by source tile: a stable LSD radix sort of the
// slots by tile, c % tiles
// ---------------------------------------------------------------------------

constexpr int kScanBlock = 1024;  // one element per thread, 32 warps

// Exclusive scan of v [m] in place, in three launches. Step 1: the sum of
// each 1024-element tile.
__global__ void __launch_bounds__(kScanBlock)
fixed_k_scan_tile_sum_kernel(const int* __restrict__ v, int m, int* __restrict__ tile_sum) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanBlock + threadIdx.x;
  int total;
  block_scan<kScanBlock>(i < m ? v[i] : 0, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// step 2 (one block): the tile sums become the tiles' offsets
__global__ void __launch_bounds__(kScanBlock)
fixed_k_scan_tile_offset_kernel(int* __restrict__ tile_sum, int tiles) {
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanBlock) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? tile_sum[i] : 0;
    int total;
    const int inclusive = block_scan<kScanBlock>(v, &total);
    if (i < tiles) tile_sum[i] = carry + inclusive - v;
    carry += total;
  }
}

// step 3: v[i] = its tile's offset + the elements before i in the tile
// (each thread reads and writes only its own element)
__global__ void __launch_bounds__(kScanBlock)
fixed_k_scan_apply_kernel(int* __restrict__ v, int m, const int* __restrict__ tile_offset) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanBlock + threadIdx.x;
  const int x = i < m ? v[i] : 0;
  int total;
  const int inclusive = block_scan<kScanBlock>(x, &total);
  if (i < m) v[i] = tile_offset[blockIdx.x] + inclusive - x;
}

constexpr int kSortThreads = 512;  // the scatter's block
constexpr int kSortWarps = kSortThreads / kWarp;
constexpr int kSortPerLane = 16;
constexpr int kSortPerWarp = kWarp * kSortPerLane;  // consecutive slots per warp
constexpr int kSortTile = kSortWarps * kSortPerWarp;  // slots per stretch: 8,192
constexpr int kMaxDigitBits = 10;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kDigitsPerThread = kMaxBins / kSortThreads;
constexpr int kMaxTile = 512;  // sources per tile

// the scatter's shared memory: per warp and digit its slot count, then its
// first local place (16 bits: at most kSortTile); per digit the global
// place less the local place; the stage of the stretch's keys and pairs in
// digit order.
constexpr int kScatterSmem =
    kSortWarps * kMaxBins * 2 + kMaxBins * 4 + kSortTile * 4 + kSortTile * 8;

// A radix pass's input: pass 0 reads the slot-major draw (the key is the
// clamped source id, the pair slot i's destination row i % S and weight
// bits), later passes the previous pass's keys and pairs. The sort key is
// the key's tile, key % tiles.
struct SortIn {
  const int* idx;
  const float* w;
  int S, n, tiles;
  const int* keys;
  const int2* pairs;

  __device__ __forceinline__ int digit(int key, int shift, int bins) const {
    return ((key % tiles) >> shift) & (bins - 1);
  }

  __device__ __forceinline__ int key(long long i) const {
    return keys == nullptr ? min(max(idx[i], 0), n - 1) : keys[i];
  }
  __device__ __forceinline__ int2 pair(long long i) const {  // i < 2^31: k * S is checked
    return keys == nullptr ? make_int2(static_cast<int>(i) % S, __float_as_int(w[i]))
                           : pairs[i];
  }
};

// radix pass, step 1: the count of each digit in each stretch of kSortTile
// slots, digit-major: table[d * stretches + stretch]
__global__ void __launch_bounds__(kBlock)
fixed_k_radix_count_kernel(SortIn in, long long total, int shift, int bins,
                           int* __restrict__ table) {
  __shared__ int count[kMaxBins];
  for (int d = threadIdx.x; d < bins; d += kBlock) count[d] = 0;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kSortTile;
  constexpr int kPerThread = kSortTile / kBlock;
  const int* keys = in.keys != nullptr ? in.keys : in.idx;
  int key[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {  // every load issued before the first add
    const long long i = first + q * kBlock + threadIdx.x;
    key[q] = i < total ? keys[i] : -1;
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q)
    if (first + q * kBlock + threadIdx.x < total)
      atomicAdd(count + in.digit(min(max(key[q], 0), in.n - 1), shift, bins), 1);
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += kBlock)
    table[static_cast<long long>(d) * gridDim.x + blockIdx.x] = count[d];
}

// radix pass, step 3 (step 2 is the exclusive scan of the table): each slot
// goes to its digit's offset for the stretch plus its rank among the
// stretch's earlier slots of that digit. Each warp owns kSortPerWarp
// consecutive slots and ranks them 32 at a time in order (peers of a digit
// found by peers_of), so the slots of one digit keep their order:
// the pass is stable. The stretch is staged in shared memory in digit order
// and written from there, so each digit's run goes out in consecutive
// places.
__global__ void __launch_bounds__(kSortThreads)
fixed_k_radix_scatter_kernel(SortIn in, long long total, int shift, int bits,
                             const int* __restrict__ offset, int* __restrict__ keys_out,
                             int2* __restrict__ pairs_out) {
  extern __shared__ int4 scatter_smem[];
  int* delta = reinterpret_cast<int*>(scatter_smem);                 // [kMaxBins]
  int* stage_keys = delta + kMaxBins;                                 // [kSortTile]
  int2* stage_pairs = reinterpret_cast<int2*>(stage_keys + kSortTile);  // [kSortTile]
  unsigned short* next = reinterpret_cast<unsigned short*>(stage_pairs + kSortTile);
  const int bins = 1 << bits;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const long long tile_first = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long first = tile_first + static_cast<long long>(warp) * kSortPerWarp;
  for (int d = lane; d < bins; d += kWarp) next[warp * kMaxBins + d] = 0;
  int key[kSortPerLane], dig[kSortPerLane];
  int2 pair[kSortPerLane];
  // every load issued before the first is used
  if (in.keys == nullptr) {
#pragma unroll
    for (int q = 0; q < kSortPerLane; ++q) {
      const long long i = first + q * kWarp + lane;
      key[q] = i < total ? in.idx[i] : 0;
      pair[q] = make_int2(static_cast<int>(i) % in.S, i < total ? __float_as_int(in.w[i]) : 0);
    }
#pragma unroll
    for (int q = 0; q < kSortPerLane; ++q) key[q] = min(max(key[q], 0), in.n - 1);
  } else {
#pragma unroll
    for (int q = 0; q < kSortPerLane; ++q) {
      const long long i = first + q * kWarp + lane;
      key[q] = i < total ? in.keys[i] : 0;
      pair[q] = i < total ? in.pairs[i] : int2{};
    }
  }
  __syncwarp();
  // each slot's rank among the warp's earlier slots of its digit (kept in
  // dig's high bits), the warp's count of each digit: in slot order, so the
  // pass is stable
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int q = 0; q < kSortPerLane; ++q) {
    const bool ok = first + q * kWarp + lane < total;
    const int d = ok ? in.digit(key[q], shift, bins) : 0;
    const unsigned peers = peers_of(d, bits, ok);
    const int here = next[warp * kMaxBins + d];
    __syncwarp();
    if (ok && (peers & below) == 0)
      next[warp * kMaxBins + d] = static_cast<unsigned short>(here + __popc(peers));
    __syncwarp();
    dig[q] = ok ? d | ((here + __popc(peers & below)) << 16) : -1;  // -1: past the end
  }
  __syncthreads();
  // a digit's slots in warp v come after those in the warps before it, and
  // the digits' runs follow each other: local starts by an exclusive scan
  int count[kDigitsPerThread];
  int mine = 0;
#pragma unroll
  for (int h = 0; h < kDigitsPerThread; ++h) {
    const int d = kDigitsPerThread * threadIdx.x + h;
    count[h] = 0;
    for (int v = 0; d < bins && v < kSortWarps; ++v) {
      const int c = next[v * kMaxBins + d];
      next[v * kMaxBins + d] = static_cast<unsigned short>(count[h]);
      count[h] += c;
    }
    mine += count[h];
  }
  int all;
  int local = block_scan<kSortThreads>(mine, &all) - mine;
#pragma unroll
  for (int h = 0; h < kDigitsPerThread; ++h) {
    const int d = kDigitsPerThread * threadIdx.x + h;
    if (d < bins) {
      for (int v = 0; v < kSortWarps; ++v)
        next[v * kMaxBins + d] = static_cast<unsigned short>(next[v * kMaxBins + d] + local);
      delta[d] = offset[static_cast<long long>(d) * gridDim.x + blockIdx.x] - local;
    }
    local += count[h];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kSortPerLane; ++q) {
    if (dig[q] < 0) continue;
    const int at = next[warp * kMaxBins + (dig[q] & 0xffff)] + (dig[q] >> 16);
    stage_keys[at] = key[q];
    stage_pairs[at] = pair[q];
  }
  __syncthreads();
  const int staged = static_cast<int>(min(static_cast<long long>(kSortTile), total - tile_first));
  for (int p = threadIdx.x; p < staged; p += kSortThreads) {
    const int k = stage_keys[p];
    const long long at = static_cast<long long>(delta[in.digit(k, shift, bins)]) + p;
    keys_out[at] = k;
    pairs_out[at] = stage_pairs[p];
  }
}

// With several radix passes, the tiles' runs from the sorted keys:
// tile_ptr[t] is the first place whose key's tile is t or more, and
// tile_ptr[tiles] = total. Thread p (0 <= p <= total) writes the tiles in
// (tile(keys[p - 1]), tile(keys[p])]: each tile once.
__global__ void __launch_bounds__(kBlock)
fixed_k_tile_ptr_kernel(const int* __restrict__ keys, long long total, int tiles,
                        int* __restrict__ tile_ptr) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p <= total;
       p += stride) {
    const int lo = p == 0 ? 0 : keys[p - 1] % tiles + 1;
    const int hi = p == total ? tiles : keys[p] % tiles;
    for (int t = lo; t <= hi; ++t) tile_ptr[t] = static_cast<int>(p);
  }
}

// ---------------------------------------------------------------------------
// the backward's gather, one block per source tile
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 1024;
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr int kTileItems = 8;                          // slots a thread holds
constexpr int kTileCap = kTileThreads * kTileItems;   // slots of a chunk, at most
constexpr int kCntStride = kTileWarps + 1;  // a source's counts: odd, so no bank conflicts
constexpr int kSplit = 64;  // slots one lane group sums before a hub's partials are added

struct TileArgs {
  const int* keys;        // the slots' sources, sorted by tile
  const int2* pairs;      // their (destination row, weight bits), in the same order
  const int* tile_ptr;    // tile t's run starts at tile_ptr[t * tile_stride]
  long long tile_stride;
  long long total;        // slots
  int tiles, tile, n;     // tile t holds sources t + l * tiles, l < tile
  int cap;                // slots of a run sorted in shared memory at a time
  int part_groups;        // lane groups of a round of hub segments
  int fpad;               // floats of a carried row: column passes * L * NV * VEC
};

// Shared memory of fixed_k_tile_kernel, in bytes (the order of its carving)
inline long long tile_smem_bytes(int tile, int cap, int part_groups, int pw, int fpad) {
  const long long T = tile;
  return 8LL * cap + 4 * (T * kCntStride + 2 * (T + 1)) + 4LL * part_groups * pw + 8LL * fpad;
}

// One lane group's result for vectors v0 + q * L + lig of a source row:
// stored on the row's first chunk, added to what earlier chunks stored after.
template <int VEC, int NV>
__device__ __forceinline__ void emit_row(float* __restrict__ row, const float* acc, int v0, int L,
                                         int lig, int nvec, bool first) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int v = v0 + q * L + lig;
    if (v >= nvec) continue;
    float x[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = acc[q * VEC + i];
    if (!first) {
      float y[VEC];
      load_f32<VEC>(row + v * VEC, y);
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = y[i] + x[i];
    }
    store_vec<float, VEC>(row + v * VEC, x);
  }
}

// Hub rows' segments, part_groups lane groups at a time: each group sums
// one kSplit-slot segment of a hub row's list sp[row_ptr[l] ..
// row_ptr[l + 1]), and the group of a row's first segment in the round adds
// the round's partials of that row in order (after the carry of the round
// before), then emits the row's sum to out_base + l * l_stride (stored when
// first, else added). sptr[l]: hub segments before row l; sptr[rows]: all.
// Every thread of the block calls it.
template <typename T, int VEC, int NV, int U>
__device__ void hub_segments(const T* __restrict__ table, int n_table, const int2* sp,
                             const int* row_ptr, const int* sptr, int rows, float* part,
                             float* carry, int part_groups, int fpad, float* out_base,
                             long long l_stride, bool first, int F, int lanes_log2) {
  const int L = 1 << lanes_log2;
  const int g = threadIdx.x >> lanes_log2, lig = threadIdx.x & (L - 1);
  const int nvec = F / VEC, pw = L * NV * VEC;
  const int segs = sptr[rows];
  const int GB = part_groups;
  for (int r = 0; r * GB < segs; ++r) {
    const int it = r * GB + g;
    const bool valid = g < GB && it < segs;
    int l = 0, q = 0, beg = 0, count = 0;
    if (valid) {
      int lo = 0, hi = rows - 1;  // the last row whose segments start at or before it
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sptr[mid] <= it) lo = mid;
        else hi = mid - 1;
      }
      l = lo;
      q = it - sptr[l];
      beg = row_ptr[l] + q * kSplit;
      count = min(kSplit, row_ptr[l + 1] - beg);
    }
    for (int v0 = 0; v0 < nvec; v0 += L * NV) {
      float acc[NV * VEC];
      if (valid) {
        gather_list<T, VEC, NV, U>(table, n_table, sp + beg, count, v0, L, lig, nvec, F, acc);
#pragma unroll
        for (int qq = 0; qq < NV; ++qq)
#pragma unroll
          for (int i = 0; i < VEC; ++i) part[g * pw + (qq * L + lig) * VEC + i] = acc[qq * VEC + i];
      }
      __syncthreads();
      if (valid && (q == 0 || g == 0)) {
        const float* cin = carry + ((r + 1) & 1) * fpad + v0 * VEC;
#pragma unroll
        for (int qq = 0; qq < NV; ++qq)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[qq * VEC + i] = q == 0 ? 0.f : cin[(qq * L + lig) * VEC + i];
        const int last = sptr[l + 1] - 1;  // the row's last segment
        for (int h = g; h < GB && r * GB + h <= last; ++h)
#pragma unroll
          for (int qq = 0; qq < NV; ++qq)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[qq * VEC + i] += part[h * pw + (qq * L + lig) * VEC + i];
        if (last < (r + 1) * GB) {
          emit_row<VEC, NV>(out_base + l * l_stride, acc, v0, L, lig, nvec, first);
        } else {
          float* cout = carry + (r & 1) * fpad + v0 * VEC;
#pragma unroll
          for (int qq = 0; qq < NV; ++qq)
#pragma unroll
            for (int i = 0; i < VEC; ++i) cout[(qq * L + lig) * VEC + i] = acc[qq * VEC + i];
        }
      }
      __syncthreads();
    }
  }
}

// Hub segments before each row: sptr[l] for l < rows and sptr[rows], from
// the rows' list lengths row_ptr[l + 1] - row_ptr[l] (a row of more than
// kSplit slots takes ceil(len / kSplit) segments). Every thread of the
// block calls it.
__device__ void hub_segment_starts(int rows, const int* row_ptr, int* sptr) {
  for (int base = 0; base < rows; base += kTileThreads) {
    const int l = base + threadIdx.x;
    int segs = 0;
    if (l < rows) {
      const int ln = row_ptr[l + 1] - row_ptr[l];
      segs = ln > kSplit ? (ln + kSplit - 1) / kSplit : 0;
    }
    int all;
    const int before = block_scan<kTileThreads>(segs, &all) - segs;
    const int carried = base == 0 ? 0 : sptr[base];
    __syncthreads();
    if (l < rows) sptr[l] = carried + before;
    if (threadIdx.x == 0) sptr[min(base + kTileThreads, rows)] = carried + all;
    __syncthreads();
  }
}

// d_src rows of tile blockIdx.x: sort its run by local source in shared
// memory (stable), then sum each source's w * dy rows (design note above).
template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(kTileThreads, 1)
fixed_k_tile_kernel(const T* __restrict__ dy, int S, TileArgs a, float* __restrict__ d_src,
                    int F, int lanes_log2) {
  extern __shared__ int4 tile_smem[];
  const int Tn = a.tile;
  const int L = 1 << lanes_log2;
  const int G = kTileThreads >> lanes_log2;
  const int g = threadIdx.x >> lanes_log2, lig = threadIdx.x & (L - 1);
  const int nvec = F / VEC, pw = L * NV * VEC;
  int2* sp = reinterpret_cast<int2*>(tile_smem);  // [cap] the chunk's pairs, sorted
  int* cnt = reinterpret_cast<int*>(sp + a.cap);  // [Tn][kCntStride] counts, then cursors
  int* row_ptr = cnt + Tn * kCntStride;           // [Tn + 1]
  int* sptr = row_ptr + Tn + 1;                   // [Tn + 1] hub segments before each row
  float* part = reinterpret_cast<float*>(sptr + Tn + 1);  // [part_groups][pw]
  float* carry = part + a.part_groups * pw;               // [2][fpad]
  const int t = blockIdx.x;
  const long long run0 = a.tile_ptr[t * a.tile_stride];
  const long long run1 = t + 1 < a.tiles ? a.tile_ptr[(t + 1) * a.tile_stride] : a.total;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x & (kWarp - 1);
  int tile_bits = 0;  // the bits of a local source
  while ((1 << tile_bits) < Tn) ++tile_bits;
  for (long long a0 = run0;; a0 += a.cap) {
    const bool first = a0 == run0;
    const int len = static_cast<int>(min(static_cast<long long>(a.cap), run1 - a0));
    // the chunk's slots in registers: warp w holds [w * 256, (w + 1) * 256),
    // q-major; lr: the local source, then its rank beside it
    int lr[kTileItems];
    int2 pr[kTileItems];
#pragma unroll
    for (int q = 0; q < kTileItems; ++q) {
      const int p = warp * kWarp * kTileItems + q * kWarp + lane;
      lr[q] = p < len ? a.keys[a0 + p] : -1;
      pr[q] = p < len ? a.pairs[a0 + p] : make_int2(0, 0);
    }
    for (int i = threadIdx.x; i < Tn * kCntStride; i += kTileThreads) cnt[i] = 0;
    __syncthreads();
    // each slot's rank among the warp's earlier slots of its source; the
    // warp's count of each source (stable: warps, then q, then lanes in order)
#pragma unroll
    for (int q = 0; q < kTileItems; ++q) {
      const bool ok = lr[q] >= 0;
      const int l = ok ? lr[q] / a.tiles : 0;
      const unsigned peers = peers_of(l, tile_bits, ok);
      const unsigned before = peers & ((1u << lane) - 1);
      const int here = cnt[l * kCntStride + warp];
      __syncwarp();
      if (ok && before == 0) cnt[l * kCntStride + warp] = here + __popc(peers);
      __syncwarp();
      if (ok) lr[q] = l | ((here + __popc(before)) << 16);
    }
    __syncthreads();
    {  // exclusive scan, source-major: each warp's start for each source (the
       // padding entry of each source stays 0)
      const int m = Tn * kCntStride;
      const int per = (m + kTileThreads - 1) / kTileThreads;
      const int e0 = min(m, static_cast<int>(threadIdx.x) * per), e1 = min(m, e0 + per);
      int mine = 0;
      for (int e = e0; e < e1; ++e) mine += cnt[e];
      int all;
      int run = block_scan<kTileThreads>(mine, &all) - mine;
      for (int e = e0; e < e1; ++e) {
        const int c = cnt[e];
        cnt[e] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int l = threadIdx.x; l < Tn; l += kTileThreads) row_ptr[l] = cnt[l * kCntStride];
    if (threadIdx.x == 0) row_ptr[Tn] = len;
#pragma unroll
    for (int q = 0; q < kTileItems; ++q)  // place
      if (lr[q] >= 0) sp[cnt[(lr[q] & 0xffff) * kCntStride + warp] + (lr[q] >> 16)] = pr[q];
    __syncthreads();
    // hub segments: a source of more than kSplit slots takes ceil(len / kSplit)
    hub_segment_starts(Tn, row_ptr, sptr);
    // sources of at most kSplit slots: one lane group each
    for (int l = g; l < Tn && static_cast<long long>(l) * a.tiles + t < a.n; l += G) {
      const int beg = row_ptr[l], count = row_ptr[l + 1] - beg;
      if (count > kSplit || (count == 0 && !first)) continue;
      float* row = d_src + (static_cast<size_t>(l) * a.tiles + t) * F;
      for (int v0 = 0; v0 < nvec; v0 += L * NV) {
        float acc[NV * VEC];
        gather_list<T, VEC, NV, U>(dy, S, sp + beg, count, v0, L, lig, nvec, F, acc);
        emit_row<VEC, NV>(row, acc, v0, L, lig, nvec, first);
      }
    }
    hub_segments<T, VEC, NV, U>(dy, S, sp, row_ptr, sptr, Tn, part, carry, a.part_groups,
                                a.fpad, d_src + static_cast<size_t>(t) * F,
                                static_cast<long long>(a.tiles) * F, first, F, lanes_log2);
    if (a0 + a.cap >= run1) break;
    __syncthreads();  // the next chunk reuses the shared memory
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline unsigned grid_stride_blocks(long long total) {
  const long long blocks = (total + kBlock - 1) / kBlock;
  return static_cast<unsigned>(blocks < 132LL * 64 ? blocks : 132LL * 64);
}

// Radix passes, and key bits per pass, for sort keys of key_bits bits: at
// most kMaxDigitBits bits a pass, at least one pass of at least one bit
inline void radix_plan(int key_bits, int* passes, int* bits) {
  *passes = key_bits <= kMaxDigitBits ? 1 : (key_bits + kMaxDigitBits - 1) / kMaxDigitBits;
  *bits = max(1, (key_bits + *passes - 1) / *passes);
}

inline int bits_of(int n) {  // the bits of n - 1
  int b = 0;
  while (b < 31 && (1LL << b) < n) ++b;
  return b;
}

inline long long sort_stretches(long long total) { return (total + kSortTile - 1) / kSortTile; }

inline long long table_entries(long long total) { return kMaxBins * sort_stretches(total); }

// The backward's scratch, carved from one buffer: two pairs of key and pair
// arrays the radix passes alternate between, the [digit, stretch] table and
// its scan's sums, the tiles' run starts
struct SortScratch {
  int2* pairs[2];
  int* keys[2];
  int* table;
  int* tile_sum;
  int* tile_ptr;
};

inline long long scratch_bytes(int n, long long total) {
  const long long table = table_entries(total);
  return 16 * total + 8 * total + 4 * (table + (table + kScanBlock - 1) / kScanBlock + n + 2);
}

inline SortScratch carve(void* base, int n, long long total) {
  SortScratch sc;
  auto* p = static_cast<char*>(base);
  for (int b = 0; b < 2; ++b, p += 8 * total) sc.pairs[b] = reinterpret_cast<int2*>(p);
  for (int b = 0; b < 2; ++b, p += 4 * total) sc.keys[b] = reinterpret_cast<int*>(p);
  sc.table = reinterpret_cast<int*>(p);
  sc.tile_sum = sc.table + table_entries(total);
  sc.tile_ptr = sc.tile_sum + (table_entries(total) + kScanBlock - 1) / kScanBlock;
  return sc;
}

// After a kernel launch: its launch error, or 0 and one more in *launched.
inline int count_launch(int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

// Sorts the slot-major draw by source tile, stably; fills a's keys, pairs
// and tile runs. Adds one to *launched per kernel launched; returns the
// first launch error.
int transpose_draw(const int* idx, const float* w, int n, int S, long long total,
                   const SortScratch& sc, TileArgs* a, cudaStream_t st, int* launched) {
  int passes, bits;
  radix_plan(bits_of(a->tiles), &passes, &bits);
  const int bins = 1 << bits;
  const unsigned stretches = static_cast<unsigned>(sort_stretches(total));
  const int m = bins * static_cast<int>(stretches);
  const unsigned scan_tiles = static_cast<unsigned>((m + kScanBlock - 1) / kScanBlock);
  const cudaError_t attr = cudaFuncSetAttribute(
      fixed_k_radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScatterSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  SortIn in{idx, w, S, n, a->tiles, nullptr, nullptr};
  for (int p = 0; p < passes; ++p) {
    const int shift = p * bits;
    fixed_k_radix_count_kernel<<<stretches, kBlock, 0, st>>>(in, total, shift, bins, sc.table);
    if (const int e = count_launch(launched)) return e;
    fixed_k_scan_tile_sum_kernel<<<scan_tiles, kScanBlock, 0, st>>>(sc.table, m, sc.tile_sum);
    if (const int e = count_launch(launched)) return e;
    fixed_k_scan_tile_offset_kernel<<<1, kScanBlock, 0, st>>>(sc.tile_sum, scan_tiles);
    if (const int e = count_launch(launched)) return e;
    fixed_k_scan_apply_kernel<<<scan_tiles, kScanBlock, 0, st>>>(sc.table, m, sc.tile_sum);
    if (const int e = count_launch(launched)) return e;
    fixed_k_radix_scatter_kernel<<<stretches, kSortThreads, kScatterSmem, st>>>(
        in, total, shift, bits, sc.table, sc.keys[p & 1], sc.pairs[p & 1]);
    if (const int e = count_launch(launched)) return e;
    in = SortIn{idx, w, S, n, a->tiles, sc.keys[p & 1], sc.pairs[p & 1]};
  }
  a->keys = in.keys;
  a->pairs = in.pairs;
  if (passes == 1) {  // one pass: digit = tile, its run starts at column 0 of the table
    a->tile_ptr = sc.table;
    a->tile_stride = stretches;
  } else {
    fixed_k_tile_ptr_kernel<<<grid_stride_blocks(total + 1), kBlock, 0, st>>>(
        in.keys, total, a->tiles, sc.tile_ptr);
    if (const int e = count_launch(launched)) return e;
    a->tile_ptr = sc.tile_ptr;
    a->tile_stride = 1;
  }
  return static_cast<int>(cudaSuccess);
}

// The kernels at compile-time VEC and NV (U: slot gathers in flight per
// lane). PASS 0: the forward gather; 1: the backward's tile kernel.
struct Launch {
  const void* a;    // src (forward) or dy (backward)
  const void* idx;
  const void* w;
  void* b;          // out (forward) or d_src (backward)
  int n, S, k, F, ll;
  TileArgs tile;
  long long smem;
  cudaStream_t st;
};

template <int PASS, typename T, int VEC, int NV>
int launch_pass(const Launch& x) {
  constexpr int U = NV == 1 ? 8 : NV == 2 ? 4 : 2;
  if constexpr (PASS == 0) {
    fixed_k_gather_kernel<T, VEC, NV, U><<<grid_for_groups(x.S, x.ll), kBlock, 0, x.st>>>(
        static_cast<const T*>(x.a), x.n, static_cast<const int*>(x.idx),
        static_cast<const float*>(x.w), x.k, static_cast<T*>(x.b), x.S, x.F, x.ll);
  } else {
    auto kernel = fixed_k_tile_kernel<T, VEC, NV, U>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(x.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<x.tile.tiles, kTileThreads, static_cast<size_t>(x.smem), x.st>>>(
        static_cast<const T*>(x.a), x.S, x.tile, static_cast<float*>(x.b), x.F, x.ll);
  }
  return static_cast<int>(cudaSuccess);
}

template <int PASS, typename T, int VEC>
int launch_nv(int nv, const Launch& x) {
  if (nv == 1) return launch_pass<PASS, T, VEC, 1>(x);
  if (nv == 2) return launch_pass<PASS, T, VEC, 2>(x);
  return launch_pass<PASS, T, VEC, 4>(x);
}

template <int PASS, typename T>
int launch_vec(int vec, int nv, const Launch& x) {
  switch (vec) {
    case 1: return launch_nv<PASS, T, 1>(nv, x);
    case 2: return launch_nv<PASS, T, 2>(nv, x);
    case 4: return launch_nv<PASS, T, 4>(nv, x);
    default:
      if constexpr (sizeof(T) == 2) return launch_nv<PASS, T, 8>(nv, x);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int PASS>
int launch_dtype(int dtype, int vec, int nv, const Launch& x) {
  const int rc = dtype == kFloat32 ? launch_vec<PASS, float>(vec, nv, x)
                                   : launch_vec<PASS, __nv_bfloat16>(vec, nv, x);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The argument checks shared by the aggregation entries: a vector spans 16
// bytes at most (4 float32 or 8 bfloat16 elements). Returns an error code,
// or -1 when the arguments are good and there is work.
inline int check_aggregate(int dtype, int vec, int n, int S, int k, int F) {
  const int max_vec = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 8 : 0;
  if (n <= 0 || S < 0 || k < 0 || F <= 0 || vec <= 0 || vec > max_vec || (vec & (vec - 1)) ||
      F % vec != 0 || static_cast<long long>(k) * S >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || k == 0) return static_cast<int>(cudaSuccess);
  return -1;
}

}  // namespace

// Every entry returns cudaGetLastError() after its launches (0 on success).

// r int32 [k, S]; row_start, degree int32 [S]; sorted_col int32 [nnz];
// sorted_weight float32 [nnz] or null; self_ids int32 [S] or null.
// Writes idx int32 [k, S] and weight float32 [k, S].
extern "C" int tfg_fixed_k_draw(const void* r, const void* row_start, const void* degree,
                                const void* sorted_col, const void* sorted_weight,
                                const void* self_ids, void* idx, void* weight, int k, int S,
                                int nnz, void* stream) {
  if (k <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  fixed_k_draw_kernel<kDrawUnroll><<<(S + kBlock - 1) / kBlock, kBlock, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(r), static_cast<const int*>(row_start),
      static_cast<const int*>(degree), static_cast<const int*>(sorted_col),
      static_cast<const float*>(sorted_weight), static_cast<const int*>(self_ids),
      static_cast<int*>(idx), static_cast<float*>(weight), S, k, nnz);
  return static_cast<int>(cudaGetLastError());
}

// out[s] = sum_j w[j, s] * src[clamp(idx[j, s])]: src [n, F] and out [S, F]
// of dtype (0 float32, 1 bfloat16); vec elements per lane vector (F % vec
// == 0, and every row start aligned to vec elements).
extern "C" int tfg_fixed_k_forward(const void* src, int dtype, int vec, const void* idx,
                                   const void* w, void* out, int n, int S, int k, int F,
                                   void* stream) {
  const int rc = check_aggregate(dtype, vec, n, S, k, F);
  if (rc >= 0) return rc;
  const int nvec = F / vec;
  const int ll = pick_lanes_log2(nvec);
  const int nv = pick_nv(nvec, 1 << ll);
  const Launch x{src, idx, w, out, n, S, k, F, ll, {}, 0, static_cast<cudaStream_t>(stream)};
  return launch_dtype<0>(dtype, vec, nv, x);
}

// Bytes of scratch tfg_fixed_k_backward takes for n sources and total = k * S
// slots.
extern "C" long long tfg_fixed_k_backward_scratch_bytes(int n, long long total) {
  return scratch_bytes(n, total);
}

// d_src[c] = sum of w[j, s] * dy[s] over the slots with clamp(idx[j, s]) == c:
// dy [S, F] of dtype, d_src float32 [n, F]. Tiles of `tile` sources (at
// most 512; tile t holds sources t, t + tiles, ...), cap slots of a tile's
// run sorted in shared memory at a time, part_groups lane groups per round
// of hub segments (the caller's plan, ops/fixed_k.py backward_plan).
// scratch holds tfg_fixed_k_backward_scratch_bytes(n, k * S) bytes, 8-byte
// aligned.
// *launched gets the number of kernels launched.
extern "C" int tfg_fixed_k_backward(const void* dy, int dtype, int vec, const void* idx,
                                    const void* w, void* d_src, int n, int S, int k, int F,
                                    int tile, int cap, int part_groups, void* scratch,
                                    int* launched, void* stream) {
  *launched = 0;
  const int rc = check_aggregate(dtype, vec, n, S, k, F);
  if (rc >= 0) return rc;
  const int nvec = F / vec;
  const int ll = pick_lanes_log2(nvec);
  const int nv = pick_nv(nvec, 1 << ll);
  const int pw = (1 << ll) * nv * vec;
  const int fpad = (nvec + (1 << ll) * nv - 1) / ((1 << ll) * nv) * pw;
  const long long smem = tile_smem_bytes(tile, cap, part_groups, pw, fpad);
  if (tile < 1 || tile > kMaxTile || cap < 2 || cap % 2 || cap > kTileCap || part_groups < 1 ||
      part_groups > (kTileThreads >> ll) || smem > max_smem_optin())
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(k) * S;
  TileArgs a{};
  a.total = total;
  a.tile = tile;
  a.tiles = static_cast<int>((static_cast<long long>(n) + tile - 1) / tile);
  a.n = n;
  a.cap = cap;
  a.part_groups = part_groups;
  a.fpad = fpad;
  const SortScratch sc = carve(scratch, n, total);
  const int sorted = transpose_draw(static_cast<const int*>(idx), static_cast<const float*>(w),
                                    n, S, total, sc, &a, st, launched);
  if (sorted != 0) return sorted;
  const Launch x{dy, idx, w, d_src, n, S, k, F, ll, a, smem, st};
  const int out = launch_dtype<1>(dtype, vec, nv, x);
  if (out == 0) ++*launched;
  return out;
}
