// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Two ways to cover an output row. Kernel B (sorted_segment.cu) gives one
// warp one row: the lanes stride the feature dimension (lane, lane + 32,
// ...), so each row is read as whole 32-element runs, and each lane keeps NK
// float32 accumulators, which covers up to 32 * NK features in one pass. NK
// is picked at launch from F (1, 2, 4 or 8), so F = 40 runs two feature
// slices, not eight. The other kernels load lane vectors of up to 16 bytes
// (helpers below); csr_spmm.cu and fixed_k.cu give a row a group of
// 2^lanes_log2 lanes, the next power of two of its vectors, so several
// narrow rows share a warp.

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

// blocks for one group of 2^lanes_log2 lanes per row
inline unsigned grid_for_groups(long long rows, int lanes_log2) {
  const long long threads = rows << lanes_log2;
  const long long block = kWarp * kWarpsPerBlock;
  return static_cast<unsigned>((threads + block - 1) / block);
}

// ---------------------------------------------------------------------------
// Lane vectors (csr_spmm.cu, fixed_k.cu, gat_attention.cu, spmm_heads.cu): a lane loads
// VEC consecutive elements, up to 16 bytes, with one instruction; a group of
// 2^lanes_log2 lanes covers a row of lane vectors.
// ---------------------------------------------------------------------------

// Raw storage of one lane's vector: VEC elements of T, 2 to 16 bytes.
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };
template <typename T, int VEC>
using RawT = typename Raw<VEC * static_cast<int>(sizeof(T))>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const RawT<T, VEC>& r, float* x) {
  const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f32(p[i]);
}

// x[0 .. VEC) = the VEC float32 values at p (aligned to the vector, or to 16
// bytes when the vector is wider)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (VEC * 4 <= 16) {
    unpack<float, VEC>(*reinterpret_cast<const RawT<float, VEC>*>(p), x);
  } else {
    load_f32<VEC / 2>(p, x);
    load_f32<VEC / 2>(p + VEC / 2, x + VEC / 2);
  }
}

// x[0 .. VEC) rounded to OutT and stored at p (aligned to the vector, or to
// 16 bytes when the vector is wider)
template <typename OutT, int VEC>
__device__ __forceinline__ void store_vec(OutT* p, const float* x) {
  if constexpr (VEC * sizeof(OutT) <= 16) {
    RawT<OutT, VEC> r;
    OutT* q = reinterpret_cast<OutT*>(&r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) q[i] = from_f32<OutT>(x[i]);
    *reinterpret_cast<RawT<OutT, VEC>*>(p) = r;
  } else {
    store_vec<OutT, VEC / 2>(p, x);
    store_vec<OutT, VEC / 2>(p + VEC / 2, x + VEC / 2);
  }
}

// lanes per row: the next power of two of the row's vectors, at most 32
inline int pick_lanes_log2(int nvec) {
  int l = 0;
  while (l < 5 && (1 << l) < nvec) ++l;
  return l;
}

// vectors per lane and pass: 1, 2 or 4
inline int pick_nv(int nvec, int lanes) {
  return nvec <= lanes ? 1 : nvec <= 2 * lanes ? 2 : 4;
}

}  // namespace tfg
