// Kernel B: sorted segment sum over a CSR-style segment pointer.
//
// Counterpart of tf_geometric_tpu/ops/pallas_segment.py,
// pallas_sorted_segment_sum (the repository's only pl.pallas_call). The
// CSR SpMM merges its hub partials in its own launch (csr_spmm.cu); this
// kernel keeps the sorted segment sum as a launch of its own.
//
// Contract: msg [M, F] has its rows sorted by segment, seg_ptr [S + 1];
// segment s goes to output row r = seg_rows[s], or r = s when seg_rows is
// null (then out has S rows):
//   out[r] (+)= sum_{i in [seg_ptr[s], seg_ptr[s + 1])} msg[i]
// With accumulate set, the sum is added to out and an empty segment leaves
// its row untouched; without it, every listed row is written (0 when empty).
// Accumulation is float32.
//
// With seg_rows the grid covers only the listed rows (a graph's few hundred
// hub rows among 10^5 or more), and the launch reads 2S + 1 indices
// instead of a pointer over every row.
//
// Bound on the H100: bytes (one add per element read). The TPU kernel
// contracted a one-hot 512 x 512 rank matrix with each message chunk on the
// MXU and folded the chunks afterwards; on Hopper a segment owns a warp, so
// no plan, no fold and no atomics are needed, and the sum is deterministic.
// The warp loads several of the segment's rows before it adds any, so a hub
// of 45 partials costs a few trips to memory, not 45.
#include "common.cuh"

namespace {

using namespace tfg;

template <typename TM, typename TO, int NK>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
sorted_segment_sum_kernel(const TM* __restrict__ msg, const int* __restrict__ seg_ptr,
                          const int* __restrict__ seg_rows, TO* __restrict__ out,
                          int num_segments, int F, int accumulate) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long s =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x / kWarp);
  if (s >= num_segments) return;  // warp-uniform
  const int start = seg_ptr[s];
  const int end = seg_ptr[s + 1];
  if (accumulate && start == end) return;
  const long long r = seg_rows ? seg_rows[s] : s;
  TO* o = out + static_cast<size_t>(r) * F;

  for (int f0 = 0; f0 < F; f0 += kWarp * NK) {
    float acc[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[k] = 0.f;
    // U rows loaded before any is added, then added in order: the sum
    // runs in segment order with U * NK = 32 loads per lane in flight
    constexpr int U = 32 / NK;
    for (int i0 = start; i0 < end; i0 += U) {
      float x[U][NK];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const TM* m = msg + static_cast<size_t>(i0 + u) * F;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int f = f0 + k * kWarp + lane;
          x[u][k] = (i0 + u < end && f < F) ? to_f32(m[f]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[k] += x[u][k];
      }
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int f = f0 + k * kWarp + lane;
      if (f < F) {
        float x = acc[k];
        if (accumulate) x += to_f32(o[f]);
        o[f] = from_f32<TO>(x);
      }
    }
  }
}

template <typename TM, typename TO>
void launch(int nk, unsigned grid, cudaStream_t stream, const void* msg,
            const int* seg_ptr, const int* seg_rows, void* out, int num_segments,
            int F, int accumulate) {
  const dim3 block(kWarp * kWarpsPerBlock);
  auto m = static_cast<const TM*>(msg);
  auto o = static_cast<TO*>(out);
  switch (nk) {
    case 1:
      sorted_segment_sum_kernel<TM, TO, 1><<<grid, block, 0, stream>>>(
          m, seg_ptr, seg_rows, o, num_segments, F, accumulate);
      break;
    case 2:
      sorted_segment_sum_kernel<TM, TO, 2><<<grid, block, 0, stream>>>(
          m, seg_ptr, seg_rows, o, num_segments, F, accumulate);
      break;
    case 4:
      sorted_segment_sum_kernel<TM, TO, 4><<<grid, block, 0, stream>>>(
          m, seg_ptr, seg_rows, o, num_segments, F, accumulate);
      break;
    default:
      sorted_segment_sum_kernel<TM, TO, kMaxNK><<<grid, block, 0, stream>>>(
          m, seg_ptr, seg_rows, o, num_segments, F, accumulate);
      break;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
// seg_rows may be null (segment s writes row s).
extern "C" int tfg_sorted_segment_sum(const void* msg, int msg_dtype,
                                      const void* seg_ptr, const void* seg_rows,
                                      void* out, int out_dtype, int num_segments,
                                      int F, int accumulate, void* stream) {
  if (num_segments <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for_rows(num_segments);
  const int nk = pick_nk(F);
  auto s = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const int*>(seg_ptr);
  auto sr = static_cast<const int*>(seg_rows);
  if (msg_dtype == kFloat32 && out_dtype == kFloat32) {
    launch<float, float>(nk, grid, s, msg, sp, sr, out, num_segments, F, accumulate);
  } else if (msg_dtype == kBFloat16 && out_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(nk, grid, s, msg, sp, sr, out, num_segments,
                                         F, accumulate);
  } else if (msg_dtype == kFloat32 && out_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(nk, grid, s, msg, sp, sr, out, num_segments, F, accumulate);
  } else if (msg_dtype == kBFloat16 && out_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(nk, grid, s, msg, sp, sr, out, num_segments, F, accumulate);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
