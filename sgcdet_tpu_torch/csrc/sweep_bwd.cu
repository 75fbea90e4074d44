// Plane-sweep correlation backward (kernel K4, `sweep_bwd`).
//
// Replaces the TPU kernel sgcdet_tpu/ops/sweep_pallas.py::_bwd_kernel (bf16
// packed and f32 quad rows, launched by _run_bwd under _sweep_bwd).  For the
// forward corr[n, d, p] = <warped_d(p), ref[n, p]> / sqrt(C), with
// warped_d(p) = sum_corners w_corner * src[n, corner], and its incoming
// gradient g[n, d, p]:
//
//   d_ref[n, p]       = sum_d g[n, d, p] / sqrt(C) * warped_d(p)
//   d_src[n, corner] += g[n, d, p] / sqrt(C) * w_corner * ref[n, p]
//
// There is no coordinate gradient (sweep_pallas.py:575-576).  The corner
// weights are recomputed from x_eff, y_eff with the forward's clipping, so
// NaN and inf coordinates (planes behind the source camera) land off the
// image and contribute nothing, exactly as in the forward.  Both gradients
// are f32; the wrapper casts them once to the input dtype.
//
// What bounds it on this card: the d_src scatter.  Every (n, d, p) adds C
// f32 values at each of up to four data-dependent corner rows: 40 x 12 x
// 4800 x 4 x 128 = 1.2e9 f32 additions per call at the ScanNet width,
// which resolve in L2 (the 40 x 60 x 80 x 128 f32 d_src buffer is 98 MB,
// twice the 50 MB L2, but neighbouring pixels hit neighbouring rows).  The
// corner re-gather for d_ref is the forward's traffic again.
//
// Design: one warp per (view, reference pixel), lanes over the C channels
// (C / 32 = 4 contiguous channels per lane), as in the forward.  The warp
// keeps its ref row and its d_ref accumulator in registers and walks the D
// planes, so d_ref is written once with no atomics.  d_src takes one
// 16-byte vector reduction per lane per in-image corner straight into
// (N, H, W, C): a warp's corner update is one instruction over one
// contiguous 512-byte row (sixteen full 32-byte sectors), where four
// scalar atomicAdds per lane took four instructions, each touching the
// same sixteen sectors with two floats apiece.  That cuts the L2 atomic
// operations 4x, to at most 2.9e8 per call (1.9e8 on the indoor rig, whose
// other corners fall off the image).  Fewer reductions bought nothing once
// they cost parallelism: a warp per run of pixels merging shared corner
// rows, and planes split over more warps, were both slower on the card.
// Off-image corners are skipped; no quad rows and no un-quad pass (those
// worked around Mosaic).
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(256) sweep_bwd_kernel(
    const T* __restrict__ src,      // (N, H, W, C)
    const T* __restrict__ ref,      // (N, H, W, C)
    const float* __restrict__ xe,   // (N, D, H*W)
    const float* __restrict__ ye,   // (N, D, H*W)
    const float* __restrict__ g,    // (N, D, H*W) incoming gradient
    float* __restrict__ d_src,      // (N, H, W, C) zeroed by the caller
    float* __restrict__ d_ref,      // (N, H, W, C)
    int n, int h, int w, int d, float inv_sqrt_c) {
  constexpr int C = 32 * VEC;
  const int lane = threadIdx.x & 31;
  const long long hw = (long long)h * w;
  const long long warp_id =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id >= (long long)n * hw) return;
  const long long cam = warp_id / hw;
  const long long pix = warp_id - cam * hw;

  float r[VEC], dr[VEC];
  sgc::load_f32<T, VEC>(ref + (cam * hw + pix) * C + lane * VEC, r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dr[i] = 0.f;
  const T* sbase = src + cam * hw * C + lane * VEC;
  float* dsbase = d_src + cam * hw * C + lane * VEC;

  for (int di = 0; di < d; ++di) {
    const long long idx = (cam * d + di) * hw + pix;
    const float gs = g[idx] * inv_sqrt_c;
    const float x = sgc::clip_coord(xe[idx], -4.f, w + 4.f);
    const float y = sgc::clip_coord(ye[idx], -4.f, h + 4.f);
    const float x0f = floorf(x), y0f = floorf(y);
    const float lx = x - x0f, ly = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1, dx = corner & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      if (yi < 0 || yi > h - 1 || xi < 0 || xi > w - 1) continue;
      const float cw = gs * ((dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx));
      const long long row = ((long long)yi * w + xi) * C;
      float v[VEC], upd[VEC];
      sgc::load_f32<T, VEC>(sbase + row, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        dr[i] += cw * v[i];
        upd[i] = cw * r[i];
      }
      sgc::atomic_add_f32<VEC>(dsbase + row, upd);
    }
  }
  sgc::store_from_f32<float, VEC>(d_ref + (cam * hw + pix) * C + lane * VEC, dr);
}

template <typename T, int VEC>
void launch(const void* src, const void* ref, const float* xe, const float* ye,
            const float* g, float* d_src, float* d_ref, int n, int h, int w,
            int d, float inv_sqrt_c, cudaStream_t stream) {
  const long long warps = (long long)n * h * w;
  const int threads = 256;
  const long long blocks = (warps + (threads / 32) - 1) / (threads / 32);
  sweep_bwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), xe, ye, g, d_src,
      d_ref, n, h, w, d, inv_sqrt_c);
}

template <typename T>
int dispatch(int c, const void* src, const void* ref, const float* xe,
             const float* ye, const float* g, float* d_src, float* d_ref, int n,
             int h, int w, int d, float inv_sqrt_c, cudaStream_t stream) {
  switch (c) {
    case 128: launch<T, 4>(src, ref, xe, ye, g, d_src, d_ref, n, h, w, d, inv_sqrt_c, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src, ref (N, H, W, C) of type dtype, x_eff, y_eff, g (N, D, H*W) f32 ->
// d_src (zero-initialised by the caller) and d_ref, (N, H, W, C) f32.
extern "C" int sgc_sweep_bwd(int dtype, const void* src, const void* ref,
                             const float* x_eff, const float* y_eff,
                             const float* g, float* d_src, float* d_ref, int n,
                             int h, int w, int c, int d, void* stream) {
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)h * w == 0) return (int)cudaSuccess;
  if (dtype == sgc::kBFloat16)
    return dispatch<__nv_bfloat16>(c, src, ref, x_eff, y_eff, g, d_src, d_ref,
                                   n, h, w, d, inv_sqrt_c, s);
  if (dtype == sgc::kFloat32)
    return dispatch<float>(c, src, ref, x_eff, y_eff, g, d_src, d_ref, n, h, w,
                           d, inv_sqrt_c, s);
  return (int)cudaErrorInvalidValue;
}
