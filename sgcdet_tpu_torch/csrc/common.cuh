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

// A sample's pixel coordinate as the plain version's window plan computes
// it in PyTorch (ops/dfa3d_windowed.py::plan_windows): loc * size and - 0.5
// each rounded once (no fused multiply-add), then clipped, so the windowed
// kernels and their plain version agree on every window.
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return clip_coord(__fsub_rn(__fmul_rn(loc, (float)size), 0.5f), -4.f,
                    size + 4.f);
}

// The window of a windowed kernel's block (THREADS threads), as
// ops/dfa3d_windowed.py::plan_windows computes it: the lowest and the
// highest pixel y * w + x that an in-image corner of the n samples at lp
// reads (3 floats each: the chunk's counted queries' points at stage 1,
// every (head, point) of them multi-head, whose window is the union of the
// heads' bands).  A sample's in-image corners fill the box [max(x0, 0),
// min(x0 + 1, w - 1)] x [max(y0, 0), min(y0 + 1, h - 1)].  Returns {lo,
// hi}, hi < 0 where no corner lies in the image.  Every thread of the block
// calls it once; one sync: each warp leaves its extremes in s_warp
// (THREADS / 32 entries, shared) and every thread folds them.
template <int THREADS>
__device__ __forceinline__ int2 union_window(const float* lp, int n, int h, int w,
                                             int2* s_warp) {
  int lo = 0x7fffffff, hi = -1;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int x0 = (int)floorf(pixel_coord(lp[3 * i], w));
    const int y0 = (int)floorf(pixel_coord(lp[3 * i + 1], h));
    const int xlo = max(x0, 0), xhi = min(x0 + 1, w - 1);
    const int ylo = max(y0, 0), yhi = min(y0 + 1, h - 1);
    if (xlo <= xhi && ylo <= yhi) {
      lo = min(lo, ylo * w + xlo);
      hi = max(hi, yhi * w + xhi);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = make_int2(lo, hi);
  __syncthreads();
  lo = 0x7fffffff;
  hi = -1;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    lo = min(lo, s_warp[i].x);
    hi = max(hi, s_warp[i].y);
  }
  return make_int2(lo, hi);
}

// 16 bytes from global to shared memory without a register round trip
// (sm_80+); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it in the stream ends; it waits here before it reads
// what that kernel writes or writes what it reads.
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Let the next kernel of the stream start launching.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch kernel on grid x block threads with smem bytes of dynamic shared
// memory in stream s, allowed to start before the kernel ahead of it ends
// where `early` (it then waits in wait_for_prerequisite).
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                          cudaStream_t s, bool early, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Sum over each aligned group of LANES lanes (a power of two up to 32);
// every lane of the warp must call it, and every lane ends with its group's
// sum.
template <int LANES>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float warp_sum(float s) { return group_sum<32>(s); }

// Add VEC f32 values to p[0, VEC) in global memory by 16-byte vector
// reductions (atomicAdd on float4: compute capability 9.x, global memory
// only), one L2 operation per four values where scalar atomicAdds take
// four.  p is 16-byte aligned: the wrappers allocate the accumulation
// buffers with ops/_cuda.py::zeros_f32 and their rows are multiples of
// four f32.
template <int VEC>
__device__ __forceinline__ void atomic_add_f32(float* p, const float (&v)[VEC]) {
  static_assert(VEC % 4 == 0, "vector reductions add four f32 at a time");
#pragma unroll
  for (int i = 0; i < VEC; i += 4)
    atomicAdd(reinterpret_cast<float4*>(p + i),
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
}

// Run f(VT{}, DT{}) at the value and depth types of the dtype codes: the
// DFA3D kernels' pairs bf16/f32, f32/f32 and bf16/bf16.
template <typename F>
int dispatch_types(int vdtype, int ddtype, F&& f) {
  if (ddtype == kBFloat16) {
    if (vdtype != kBFloat16) return (int)cudaErrorInvalidValue;
    return f(__nv_bfloat16{}, __nv_bfloat16{});
  }
  if (ddtype != kFloat32) return (int)cudaErrorInvalidValue;
  if (vdtype == kBFloat16) return f(__nv_bfloat16{}, float{});
  if (vdtype == kFloat32) return f(float{}, float{});
  return (int)cudaErrorInvalidValue;
}

// A kernel's resources at `threads` threads and `smem` bytes of dynamic
// shared memory a block: out = {registers a thread, local memory bytes a
// thread (spills), shared memory bytes a block (static + dynamic), blocks
// an SM can hold, threads a block}.
template <typename Kernel>
int kernel_attributes(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = blocks;
  out[4] = threads;
  return (int)cudaSuccess;
}

}  // namespace sgc
