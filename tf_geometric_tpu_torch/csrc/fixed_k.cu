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
// Bound on the H100: bytes. The draw moves ~20 bytes per slot for a
// remainder and two gathers. Each aggregation slot gathers one row of F
// elements for 2 * F flops, far under the ~20 flops per byte where float32
// FMA throughput would bind.
//
// Design.
// - Draw: one thread per slot, grid-stride; the remainder, the clip, the
//   column gather and the weight write are one pass, so no [k, S] pick
//   array ever reaches device memory.
// - Gather, the forward and the backward's second half: a group of L lanes
//   owns one output row (L = 32 for a row of 32 or more lane vectors, else
//   the next power of two, so several narrow rows share a warp). Each lane
//   holds vectors of VEC elements, up to 16 bytes, so a 128-wide float32 row
//   is one load instruction per warp. The group's lanes read the row's slot
//   ids and weights (one each, L at a time) and broadcast them by shuffle;
//   U slots' rows are loaded before any is added, so U gathers per lane are
//   in flight. Rows wider than L * NV vectors take several passes.
// - Backward: d_src[c] has a writer for every slot that drew c. Float32
//   atomics into d_src would be bound by the L2's atomic rate over a target
//   larger than the L2 (measured at 2.9x the forward's time on the same
//   bytes), and their order, so the float32 sum, would change from run to
//   run. Instead the draw is transposed by a stable LSD radix sort of the
//   slots by source id (per pass of up to 9 key bits: count each tile's
//   digits, scan the [digit, tile] counts in three launches, scatter each
//   slot, one key and one 8-byte (destination row, weight) pair, to its
//   digit's offset plus its rank among the tile's earlier slots of that
//   digit, through a shared-memory stage so each digit's run is written in
//   consecutive places); the sorted keys give the row pointers, and the
//   same gather sums w * dy[s] into each source row. A source's slots stay
//   in slot order, so every row's sum runs in the same order in every run:
//   the backward is bitwise reproducible.
#include "common.cuh"

namespace {

using namespace tfg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = kWarp * kWarpsPerBlock;

// ---------------------------------------------------------------------------
// draw
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlock)
fixed_k_draw_kernel(const int* __restrict__ r, const int* __restrict__ row_start,
                    const int* __restrict__ degree, const int* __restrict__ sorted_col,
                    const float* __restrict__ sorted_weight, const int* __restrict__ self_ids,
                    int* __restrict__ idx, float* __restrict__ weight, int S, long long total,
                    int nnz) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int s = static_cast<int>(i % S);
    const int deg = degree[s];
    if (deg <= 0) {  // isolated: points at itself with weight 0
      idx[i] = self_ids != nullptr ? self_ids[s] : s;
      weight[i] = 0.f;
      continue;
    }
    int rem = r[i] % deg;
    if (rem < 0) rem += deg;  // a remainder with the divisor's sign, as torch / jnp take it
    long long pick = static_cast<long long>(row_start[s]) + rem;
    pick = min(max(pick, 0LL), static_cast<long long>(max(nnz - 1, 0)));
    idx[i] = sorted_col[pick];
    weight[i] = sorted_weight != nullptr ? sorted_weight[pick] : 1.f;
  }
}

// ---------------------------------------------------------------------------
// aggregation
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

// out[r] = sum_j wt_j * src[id_j] over row r's slots, the gather both passes
// run. Without row_ptr the slots are the slot-major draw, ids and wts (slot
// j of row r at j * rows + r, k per row: the forward); with row_ptr they
// are the draw transposed by source, (id, weight) pairs interleaved in ids
// and wts = ids + 1 (row r's pairs at row_ptr[r] .. row_ptr[r + 1]: the
// backward). Ids are clamped to [0, n_src - 1].
template <typename T, typename OutT, int VEC, int NV, int U>
__global__ void __launch_bounds__(kBlock)
fixed_k_gather_kernel(const T* __restrict__ src, int n_src, const int* __restrict__ ids,
                      const float* __restrict__ wts, const int* __restrict__ row_ptr, int k,
                      OutT* __restrict__ out, int rows, int F, int lanes_log2) {
  const RowLane rl = row_lane(lanes_log2, rows);
  const int L = 1 << lanes_log2;
  const int nvec = F / VEC;
  long long first = rl.s;
  long long stride = rows;
  int count = k;
  if (row_ptr != nullptr) {
    first = 2LL * row_ptr[rl.s];
    stride = 2;
    count = row_ptr[rl.s + 1] - row_ptr[rl.s];
  }
  if (!rl.valid) count = 0;
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
        const size_t off = static_cast<size_t>(first + (base + rl.lig) * stride);
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
    OutT* orow = out + static_cast<size_t>(rl.s) * F;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int v = v0 + q * L + rl.lig;
      if (v < nvec) store_vec<OutT, VEC>(orow + v * VEC, acc + q * VEC);
    }
  }
}

// ---------------------------------------------------------------------------
// the backward's transpose: a stable LSD radix sort of the slots by source
// ---------------------------------------------------------------------------

constexpr int kScanBlock = 1024;  // one element per thread, 32 warps

// Inclusive prefix sum of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kScanBlock / kWarp];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == kWarp - 1) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int u = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += u;
    }
    warp_sums[lane] = x;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kWarp - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// Exclusive scan of v [m] in place, in three launches. Step 1: the sum of
// each 1024-element tile.
__global__ void __launch_bounds__(kScanBlock)
fixed_k_scan_tile_sum_kernel(const int* __restrict__ v, int m, int* __restrict__ tile_sum) {
  const long long i = static_cast<long long>(blockIdx.x) * kScanBlock + threadIdx.x;
  int total;
  block_scan(i < m ? v[i] : 0, &total);
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
    const int inclusive = block_scan(v, &total);
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
  const int inclusive = block_scan(x, &total);
  if (i < m) v[i] = tile_offset[blockIdx.x] + inclusive - x;
}

constexpr int kSortPerLane = 8;
constexpr int kSortPerWarp = kWarp * kSortPerLane;  // consecutive slots per warp
constexpr int kSortTile = kWarpsPerBlock * kSortPerWarp;
constexpr int kMaxDigitBits = 9;
constexpr int kMaxBins = 1 << kMaxDigitBits;

// A radix pass's input: pass 0 reads the slot-major draw (the key is the
// clamped source id, the pair slot i's destination row i % S and weight
// bits), later passes the previous pass's keys and pairs.
struct SortIn {
  const int* idx;
  const float* w;
  int S, n;
  const int* keys;
  const int2* pairs;

  __device__ __forceinline__ int key(long long i) const {
    return keys == nullptr ? min(max(idx[i], 0), n - 1) : keys[i];
  }
  __device__ __forceinline__ int2 pair(long long i) const {
    return keys == nullptr ? make_int2(static_cast<int>(i) % S, __float_as_int(w[i])) : pairs[i];
  }
};

// radix pass, step 1: the count of each digit in each tile of kSortTile
// slots, digit-major: table[d * tiles + tile]
__global__ void __launch_bounds__(kBlock)
fixed_k_radix_count_kernel(SortIn in, long long total, int shift, int bins,
                           int* __restrict__ table) {
  __shared__ int count[kMaxBins];
  for (int d = threadIdx.x; d < bins; d += kBlock) count[d] = 0;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kSortTile;
  for (int t = threadIdx.x; t < kSortTile; t += kBlock)
    if (first + t < total) atomicAdd(count + ((in.key(first + t) >> shift) & (bins - 1)), 1);
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += kBlock)
    table[static_cast<long long>(d) * gridDim.x + blockIdx.x] = count[d];
}

// Exclusive prefix sum of v over a block of kBlock threads (warp_sums:
// kWarpsPerBlock ints of shared memory)
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int u = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += u;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int u = 0; u < warp; ++u) before += warp_sums[u];
  return before + x - v;
}

// radix pass, step 3 (step 2 is the exclusive scan of the table): each slot
// goes to its digit's offset for the tile plus its rank among the tile's
// earlier slots of that digit. Each warp owns kSortPerWarp consecutive
// slots and ranks them 32 at a time in order (peers of a digit found by one
// ballot per digit bit), so the slots of one digit keep their order: the
// pass is stable. The tile is staged in shared memory in digit order and
// written from there, so each digit's run goes out in consecutive places.
__global__ void __launch_bounds__(kBlock)
fixed_k_radix_scatter_kernel(SortIn in, long long total, int shift, int bits,
                             const int* __restrict__ offset, int* __restrict__ keys_out,
                             int2* __restrict__ pairs_out) {
  static_assert(kMaxBins == 2 * kBlock, "two digits per thread");
  // per warp and digit: its slot count, then the next local place for them
  __shared__ int next[kWarpsPerBlock][kMaxBins];
  __shared__ int delta[kMaxBins];  // per digit: global place - local place
  __shared__ int warp_sums[kWarpsPerBlock];
  __shared__ int stage_keys[kSortTile];
  __shared__ int2 stage_pairs[kSortTile];
  const int bins = 1 << bits;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const long long tile_first = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long first = tile_first + static_cast<long long>(warp) * kSortPerWarp;
  for (int d = lane; d < bins; d += kWarp) next[warp][d] = 0;
  __syncwarp();
  int key[kSortPerLane];
  int2 pair[kSortPerLane];
#pragma unroll
  for (int q = 0; q < kSortPerLane; ++q) {
    const long long i = first + q * kWarp + lane;
    key[q] = i < total ? in.key(i) : -1;  // -1: past the end
    pair[q] = i < total ? in.pair(i) : int2{};
  }
#pragma unroll
  for (int q = 0; q < kSortPerLane; ++q)
    if (key[q] >= 0) atomicAdd(&next[warp][(key[q] >> shift) & (bins - 1)], 1);
  __syncthreads();
  // a digit's slots in warp v come after those in the warps before it, and
  // the digits' runs follow each other: local starts by an exclusive scan
  int count[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 2 * threadIdx.x + h;
    count[h] = 0;
    for (int v = 0; d < bins && v < kWarpsPerBlock; ++v) {
      const int c = next[v][d];
      next[v][d] = count[h];
      count[h] += c;
    }
  }
  const int start = block_exclusive_scan(count[0] + count[1], warp_sums);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 2 * threadIdx.x + h;
    if (d >= bins) continue;
    const int local = start + (h == 1 ? count[0] : 0);
    for (int v = 0; v < kWarpsPerBlock; ++v) next[v][d] += local;
    delta[d] = offset[static_cast<long long>(d) * gridDim.x + blockIdx.x] - local;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int q = 0; q < kSortPerLane; ++q) {
    const bool ok = key[q] >= 0;
    const int d = (key[q] >> shift) & (bins - 1);
    unsigned peers = __ballot_sync(kFull, ok);
    for (int b = 0; b < bits; ++b) {
      const unsigned set = __ballot_sync(kFull, (d >> b) & 1);
      peers &= ((d >> b) & 1) ? set : ~set;
    }
    const int at = next[warp][d] + __popc(peers & below);
    __syncwarp();
    if (ok && (peers & below) == 0) next[warp][d] += __popc(peers);
    __syncwarp();
    if (ok) {
      stage_keys[at] = key[q];
      stage_pairs[at] = pair[q];
    }
  }
  __syncthreads();
  const int staged = static_cast<int>(min(static_cast<long long>(kSortTile), total - tile_first));
  for (int p = threadIdx.x; p < staged; p += kBlock) {
    const int k = stage_keys[p];
    const long long at = static_cast<long long>(delta[(k >> shift) & (bins - 1)]) + p;
    keys_out[at] = k;
    pairs_out[at] = stage_pairs[p];
  }
}

// row_ptr from the sorted keys: row_ptr[c] is the first place whose key is
// c or more, so a source without slots gets an empty range, and row_ptr[n]
// = total. Thread p (0 <= p <= total) writes the sources in (keys[p - 1],
// keys[p]]: each source once.
__global__ void __launch_bounds__(kBlock)
fixed_k_row_ptr_kernel(const int* __restrict__ keys, long long total, int n,
                       int* __restrict__ row_ptr) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p <= total;
       p += stride) {
    const int lo = p == 0 ? 0 : keys[p - 1] + 1;
    const int hi = p == total ? n : keys[p];
    for (int c = lo; c <= hi; ++c) row_ptr[c] = static_cast<int>(p);
  }
}

inline unsigned grid_stride_blocks(long long total) {
  const long long blocks = (total + kBlock - 1) / kBlock;
  return static_cast<unsigned>(blocks < 132LL * 64 ? blocks : 132LL * 64);
}

// The transposed draw the backward gathers through: source c's (destination
// row, weight bits) pairs, in slot order, at row_ptr[c] .. row_ptr[c + 1]
struct Transposed {
  const int* row_ptr;
  const int2* pairs;
};

// The backward's scratch, carved from one buffer: two pairs of key and pair
// arrays the radix passes alternate between, the [digit, tile] table and
// its scan's tile sums, the row pointers
struct SortScratch {
  int2* pairs[2];
  int* keys[2];
  int* table;
  int* tile_sum;
  int* row_ptr;
};

inline long long sort_tiles(long long total) { return (total + kSortTile - 1) / kSortTile; }

inline long long table_entries(long long total) { return kMaxBins * sort_tiles(total); }

inline long long scratch_bytes(int n, long long total) {
  const long long table = table_entries(total);
  return 16 * total + 8 * total + 4 * (table + (table + kScanBlock - 1) / kScanBlock + n + 1);
}

inline SortScratch carve(void* base, int n, long long total) {
  SortScratch sc;
  auto* p = static_cast<char*>(base);
  for (int b = 0; b < 2; ++b, p += 8 * total) sc.pairs[b] = reinterpret_cast<int2*>(p);
  for (int b = 0; b < 2; ++b, p += 4 * total) sc.keys[b] = reinterpret_cast<int*>(p);
  sc.table = reinterpret_cast<int*>(p);
  sc.tile_sum = sc.table + table_entries(total);
  sc.row_ptr = sc.tile_sum + (table_entries(total) + kScanBlock - 1) / kScanBlock;
  return sc;
}

// Radix passes, and key bits per pass, for sources 0 .. n - 1: at most
// kMaxDigitBits bits a pass, at least one pass of at least one bit
inline void radix_plan(int n, int* passes, int* bits) {
  int b = 0;
  while (b < 31 && (1LL << b) < n) ++b;  // the bits of n - 1
  *passes = b <= kMaxDigitBits ? 1 : (b + kMaxDigitBits - 1) / kMaxDigitBits;
  *bits = max(1, (b + *passes - 1) / *passes);
}

// Sorts the slot-major draw by source id, stably, and builds the row
// pointers; adds one to *launched per kernel launch.
Transposed transpose_draw(const int* idx, const float* w, int n, int S, long long total,
                          const SortScratch& sc, cudaStream_t st, int* launched) {
  int passes, bits;
  radix_plan(n, &passes, &bits);
  const int bins = 1 << bits;
  const unsigned tiles = static_cast<unsigned>(sort_tiles(total));
  const int m = bins * static_cast<int>(tiles);
  const unsigned scan_tiles = static_cast<unsigned>((m + kScanBlock - 1) / kScanBlock);
  SortIn in{idx, w, S, n, nullptr, nullptr};
  for (int p = 0; p < passes; ++p) {
    const int shift = p * bits;
    fixed_k_radix_count_kernel<<<tiles, kBlock, 0, st>>>(in, total, shift, bins, sc.table);
    ++*launched;
    fixed_k_scan_tile_sum_kernel<<<scan_tiles, kScanBlock, 0, st>>>(sc.table, m, sc.tile_sum);
    ++*launched;
    fixed_k_scan_tile_offset_kernel<<<1, kScanBlock, 0, st>>>(sc.tile_sum, scan_tiles);
    ++*launched;
    fixed_k_scan_apply_kernel<<<scan_tiles, kScanBlock, 0, st>>>(sc.table, m, sc.tile_sum);
    ++*launched;
    fixed_k_radix_scatter_kernel<<<tiles, kBlock, 0, st>>>(in, total, shift, bits, sc.table,
                                                           sc.keys[p & 1], sc.pairs[p & 1]);
    ++*launched;
    in = SortIn{idx, w, S, n, sc.keys[p & 1], sc.pairs[p & 1]};
  }
  fixed_k_row_ptr_kernel<<<grid_stride_blocks(total + 1), kBlock, 0, st>>>(in.keys, total, n,
                                                                          sc.row_ptr);
  ++*launched;
  return Transposed{sc.row_ptr, in.pairs};
}

// Launches aggregation pass PASS at compile-time VEC and NV. 0, forward:
// a = src [n, F], b = out [S, F] of T, gathered through the slot-major draw.
// 1, backward: a = dy [S, F], b = d_src [n, F] float32, gathered through the
// transposed draw tr.
template <int PASS, typename T, int VEC, int NV>
void launch_pass(const void* a, const void* idx, const void* w, void* b, int n, int S, int k,
                 int F, int ll, Transposed tr, cudaStream_t st) {
  constexpr int U = NV == 1 ? 8 : NV == 2 ? 4 : 2;  // slot gathers in flight per lane
  if constexpr (PASS == 0) {
    fixed_k_gather_kernel<T, T, VEC, NV, U><<<grid_for_groups(S, ll), kBlock, 0, st>>>(
        static_cast<const T*>(a), n, static_cast<const int*>(idx), static_cast<const float*>(w),
        nullptr, k, static_cast<T*>(b), S, F, ll);
  } else {
    fixed_k_gather_kernel<T, float, VEC, NV, U><<<grid_for_groups(n, ll), kBlock, 0, st>>>(
        static_cast<const T*>(a), S, reinterpret_cast<const int*>(tr.pairs),
        reinterpret_cast<const float*>(tr.pairs) + 1, tr.row_ptr, 0, static_cast<float*>(b), n,
        F, ll);
  }
}

template <int PASS, typename T, int VEC>
void launch_nv(int nv, const void* a, const void* idx, const void* w, void* b, int n, int S,
               int k, int F, int ll, Transposed tr, cudaStream_t st) {
  if (nv == 1) launch_pass<PASS, T, VEC, 1>(a, idx, w, b, n, S, k, F, ll, tr, st);
  else if (nv == 2) launch_pass<PASS, T, VEC, 2>(a, idx, w, b, n, S, k, F, ll, tr, st);
  else launch_pass<PASS, T, VEC, 4>(a, idx, w, b, n, S, k, F, ll, tr, st);
}

template <int PASS, typename T>
void launch_vec(int vec, int nv, const void* a, const void* idx, const void* w, void* b, int n,
                int S, int k, int F, int ll, Transposed tr, cudaStream_t st) {
  switch (vec) {
    case 1: launch_nv<PASS, T, 1>(nv, a, idx, w, b, n, S, k, F, ll, tr, st); break;
    case 2: launch_nv<PASS, T, 2>(nv, a, idx, w, b, n, S, k, F, ll, tr, st); break;
    case 4: launch_nv<PASS, T, 4>(nv, a, idx, w, b, n, S, k, F, ll, tr, st); break;
    default:
      if constexpr (sizeof(T) == 2) launch_nv<PASS, T, 8>(nv, a, idx, w, b, n, S, k, F, ll, tr, st);
  }
}

// Checks the arguments before anything is launched; for the backward,
// transposes the draw into scratch first. A vector spans 16 bytes at most:
// 4 float32 or 8 bfloat16 elements.
template <int PASS>
int launch_aggregate(const void* a, int dtype, int vec, const void* idx, const void* w, void* b,
                     int n, int S, int k, int F, void* scratch, int* launched, void* stream) {
  const int max_vec = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 8 : 0;
  if (n <= 0 || S < 0 || k < 0 || F <= 0 || vec <= 0 || vec > max_vec || (vec & (vec - 1)) ||
      F % vec != 0 || static_cast<long long>(k) * S >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || k == 0) return static_cast<int>(cudaSuccess);
  const int nvec = F / vec;
  const int ll = pick_lanes_log2(nvec);
  const int nv = pick_nv(nvec, 1 << ll);
  auto st = static_cast<cudaStream_t>(stream);
  Transposed tr{};
  if constexpr (PASS == 1) {
    const long long total = static_cast<long long>(k) * S;
    tr = transpose_draw(static_cast<const int*>(idx), static_cast<const float*>(w), n, S, total,
                        carve(scratch, n, total), st, launched);
  }
  if (dtype == kFloat32)
    launch_vec<PASS, float>(vec, nv, a, idx, w, b, n, S, k, F, ll, tr, st);
  else
    launch_vec<PASS, __nv_bfloat16>(vec, nv, a, idx, w, b, n, S, k, F, ll, tr, st);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
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
  const long long total = static_cast<long long>(k) * S;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  fixed_k_draw_kernel<<<grid_stride_blocks(total), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(r), static_cast<const int*>(row_start),
      static_cast<const int*>(degree), static_cast<const int*>(sorted_col),
      static_cast<const float*>(sorted_weight), static_cast<const int*>(self_ids),
      static_cast<int*>(idx), static_cast<float*>(weight), S, total, nnz);
  return static_cast<int>(cudaGetLastError());
}

// out[s] = sum_j w[j, s] * src[clamp(idx[j, s])]: src [n, F] and out [S, F]
// of dtype (0 float32, 1 bfloat16); vec elements per lane vector (F % vec
// == 0, and every row start aligned to vec elements).
extern "C" int tfg_fixed_k_forward(const void* src, int dtype, int vec, const void* idx,
                                   const void* w, void* out, int n, int S, int k, int F,
                                   void* stream) {
  int launched = 0;
  return launch_aggregate<0>(src, dtype, vec, idx, w, out, n, S, k, F, nullptr, &launched,
                             stream);
}

// Bytes of scratch tfg_fixed_k_backward takes for n sources and total = k * S
// slots.
extern "C" long long tfg_fixed_k_backward_scratch_bytes(int n, long long total) {
  return scratch_bytes(n, total);
}

// d_src[c] = sum of w[j, s] * dy[s] over the slots with clamp(idx[j, s]) == c,
// in slot order: dy [S, F] of dtype, d_src float32 [n, F]. scratch holds
// tfg_fixed_k_backward_scratch_bytes(n, k * S) bytes, 8-byte aligned.
// *launched gets the number of kernels launched.
extern "C" int tfg_fixed_k_backward(const void* dy, int dtype, int vec, const void* idx,
                                    const void* w, void* d_src, int n, int S, int k, int F,
                                    void* scratch, int* launched, void* stream) {
  *launched = 0;
  return launch_aggregate<1>(dy, dtype, vec, idx, w, d_src, n, S, k, F, scratch, launched,
                             stream);
}
