// Host-side graph ops of the PyTorch port, loaded with ctypes
// (tf_geometric_tpu_torch/native/__init__.py): the fixed-k neighbour draw of
// RandomNeighborSampler, one sweep of label propagation and the
// capacity-bounded partition refinement of parallel/partition.py.
//
// These are the port's own copy of the JAX package's native ops
// (tf_geometric_tpu/native/graph_ops.cpp), so the two packages give the same
// arrays for the same inputs: the draw is a function of (seed, source) only,
// and the OpenMP loops write disjoint outputs from a fixed snapshot, so no
// result depends on the thread schedule.
//
// C ABI. int32 node ids, int64 sizes and row pointers.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

// k neighbours per source with replacement: a per-source splitmix64 stream
// seeded by seed ^ (0x632BE59BD9B4E019 * (src + 1)), pick = state % deg.
// A source without edges points at itself with weight 0.
void tfg_sample_fixed_k(const int64_t* row_ptr, const int32_t* col,
                        const float* weight, const int64_t* sources,
                        int64_t num_sources, int32_t k, uint64_t seed,
                        int32_t* out_col, float* out_w) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t s = 0; s < num_sources; ++s) {
        const int64_t src = sources[s];
        const int64_t start = row_ptr[src];
        const int64_t deg = row_ptr[src + 1] - start;
        int32_t* oc = out_col + s * k;
        float* ow = out_w + s * k;
        if (deg == 0) {
            for (int32_t j = 0; j < k; ++j) { oc[j] = (int32_t)src; ow[j] = 0.f; }
            continue;
        }
        uint64_t state = seed ^ (0x632BE59BD9B4E019ULL * (uint64_t)(src + 1));
        for (int32_t j = 0; j < k; ++j) {
            state = splitmix64(state);
            const int64_t pick = (int64_t)(state % (uint64_t)deg);
            oc[j] = col[start + pick];
            ow[j] = weight[start + pick];
        }
    }
}

// One synchronous label-propagation sweep: each node takes the most frequent
// label among its neighbours (the smallest on a tie); a node without
// neighbours keeps its label. Returns the number of labels that changed.
int64_t tfg_lpa_sweep(const int64_t* row_ptr, const int32_t* col,
                      int32_t num_nodes, const int64_t* labels,
                      int64_t* new_labels) {
    int64_t changes = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : changes)
#endif
    {
        std::vector<int64_t> buf;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1024)
#endif
        for (int32_t n = 0; n < num_nodes; ++n) {
            const int64_t start = row_ptr[n], end = row_ptr[n + 1];
            if (end == start) { new_labels[n] = labels[n]; continue; }
            buf.assign(end - start, 0);
            for (int64_t e = start; e < end; ++e) buf[e - start] = labels[col[e]];
            std::sort(buf.begin(), buf.end());
            int64_t best = buf[0], best_count = 1, cur = buf[0], cur_count = 1;
            for (size_t i = 1; i < buf.size(); ++i) {
                if (buf[i] == cur) ++cur_count;
                else { cur = buf[i]; cur_count = 1; }
                if (cur_count > best_count) { best = cur; best_count = cur_count; }
            }
            new_labels[n] = best;
            if (best != labels[n]) ++changes;
        }
    }
    return changes;
}

// The neighbours of n per part, into cnt [P].
static inline void count_parts(const int64_t* row_ptr, const int32_t* col,
                               const int32_t* part, int32_t n,
                               std::vector<int64_t>& cnt) {
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t e = row_ptr[n]; e < row_ptr[n + 1]; ++e) cnt[part[col[e]]]++;
}

// The part under its cap that holds most of n's neighbours (the first on a
// tie), or -1 when every part is full.
static inline int32_t best_open_part(const std::vector<int64_t>& cnt,
                                     const std::vector<int64_t>& fill,
                                     const int64_t* caps, int32_t P) {
    int32_t t = -1;
    for (int32_t q = 0; q < P; ++q)
        if (fill[q] < caps[q] && (t < 0 || cnt[q] > cnt[t])) t = q;
    return t;
}

// Refinement over a symmetric CSR graph: up to num_iters sweeps, each moving
// the nodes with a positive gain (most gain first, then lowest id) to the
// part holding most of their neighbours while that part is below cap + slack;
// then a repair that drains every overfull part, the members that lose the
// least locality first, into the best part still under its cap. Mutates part
// so that every part's fill equals its cap; returns the number of moves.
int64_t tfg_partition_refine(const int64_t* row_ptr, const int32_t* col,
                             int32_t num_nodes, int32_t num_parts,
                             const int64_t* caps, int32_t slack,
                             int32_t num_iters, int32_t* part) {
    const int32_t P = num_parts;
    std::vector<int64_t> fill((size_t)P, 0);
    for (int32_t n = 0; n < num_nodes; ++n) fill[part[n]]++;
    std::vector<int32_t> best((size_t)num_nodes);
    std::vector<int64_t> gain((size_t)num_nodes);
    std::vector<int64_t> movers;
    int64_t total_moves = 0;

    for (int32_t it = 0; it < num_iters; ++it) {
#ifdef _OPENMP
#pragma omp parallel
#endif
        {
            std::vector<int64_t> cnt((size_t)P);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 2048)
#endif
            for (int32_t n = 0; n < num_nodes; ++n) {
                count_parts(row_ptr, col, part, n, cnt);
                int32_t b = 0;
                for (int32_t p = 1; p < P; ++p)
                    if (cnt[p] > cnt[b]) b = p;
                best[n] = b;
                gain[n] = cnt[b] - cnt[part[n]];
            }
        }
        movers.clear();
        for (int32_t n = 0; n < num_nodes; ++n)
            if (best[n] != part[n] && gain[n] > 0) movers.push_back(n);
        if (movers.empty()) break;
        std::sort(movers.begin(), movers.end(), [&](int64_t a, int64_t b) {
            if (gain[a] != gain[b]) return gain[a] > gain[b];
            return a < b;
        });
        int64_t moved = 0;
        for (int64_t n : movers) {
            const int32_t b = best[n];
            if (fill[b] < caps[b] + slack) {
                fill[part[n]]--;
                fill[b]++;
                part[n] = b;
                ++moved;
            }
        }
        total_moves += moved;
        if (moved == 0) break;
    }

    std::vector<int64_t> cnt((size_t)P);
    for (int32_t p = 0; p < P; ++p) {
        int64_t excess = fill[p] - caps[p];
        if (excess <= 0) continue;
        std::vector<std::pair<int64_t, int32_t>> scored;  // (-score, node)
        for (int32_t n = 0; n < num_nodes; ++n) {
            if (part[n] != p) continue;
            count_parts(row_ptr, col, part, n, cnt);
            const int32_t t = best_open_part(cnt, fill, caps, P);
            if (t < 0) break;
            scored.emplace_back(-(cnt[t] - cnt[p]), n);
        }
        std::sort(scored.begin(), scored.end());
        for (auto& sn : scored) {
            if (excess == 0) break;
            const int32_t n = sn.second;
            count_parts(row_ptr, col, part, n, cnt);
            const int32_t t = best_open_part(cnt, fill, caps, P);
            if (t < 0) break;
            fill[p]--;
            fill[t]++;
            part[n] = t;
            --excess;
            ++total_moves;
        }
    }
    return total_moves;
}

}  // extern "C"
