// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Each kernel file exports plain C entry points that take raw device
// pointers and the caller's stream and return cudaGetLastError() after the
// launch; the Python wrappers load them with ctypes and raise on non-zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgc {

// dtype codes shared with the Python wrappers (ops/_cuda.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC consecutive elements moved as aligned vector accesses of at most 16
// bytes (one for 8 bf16 or 4 f32, two for 8 f32).  Callers guarantee the
// address is a multiple of min(16, sizeof(Vec)); the wrappers hand over
// 16-byte-aligned tensors whose rows are multiples of 32 elements.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&r)[VEC]) {
  const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = to_f32(x.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* p, const float (&r)[VEC]) {
  Vec<T, VEC> x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) x.v[i] = from_f32<T>(r[i]);
  *reinterpret_cast<Vec<T, VEC>*>(p) = x;
}

// Clip a sample coordinate to [lo, hi] before floor and the int conversion
// (an out-of-range float -> int conversion is undefined).  fmaxf returns its
// non-NaN operand, so a NaN coordinate lands on `lo`, outside the image, and
// contributes zero like any other far-off sample.
__device__ __forceinline__ float clip_coord(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

}  // namespace sgc
