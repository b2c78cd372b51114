// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel here gives one warp one output row: the lanes stride the
// feature dimension (lane, lane + 32, ...), so each row of h is read as
// whole 32-element runs, and each lane keeps NK float32 accumulators, which
// covers up to 32 * NK features in one pass. NK is picked at launch from F
// (1, 2, 4 or 8), so F = 40 runs two feature slices, not eight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tfg {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxNK = 8;  // 256 features per pass

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// accumulator slices per lane for a feature width F
inline int pick_nk(int F) {
  const int slices = (F + kWarp - 1) / kWarp;
  return slices <= 1 ? 1 : slices <= 2 ? 2 : slices <= 4 ? 4 : kMaxNK;
}

inline unsigned grid_for_rows(long long rows) {
  return static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace tfg
