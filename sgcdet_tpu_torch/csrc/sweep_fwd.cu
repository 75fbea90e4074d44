// Plane-sweep correlation forward (kernel K1, `sweep_fwd`).
//
// Replaces the TPU kernels sgcdet_tpu/ops/sweep_pallas.py::_fwd_kernel_pk
// (bf16 inputs) and ::_fwd_kernel (f32 inputs).  For every (view n, depth
// plane d, reference pixel p):
//
//   corr[n, d, p] = <bilinear(src_n, x_eff[n, d, p], y_eff[n, d, p]), ref[n, p]> / sqrt(C)
//
// with zero padding per corner and f32 math whatever the input type.  C is
// the matching network's 128 channels, the only width the depth net feeds.
//
// What bounds it on this card: gathered bytes.  Each (n, d, p) reads four
// C-channel corner rows of src at data-dependent addresses (4 x 128 x 2 B
// in bf16 at the ScanNet width) for about one flop per gathered byte, far
// below the H100's compute/bandwidth ratio; the 40-view src maps (40 x 60 x 80 x 128
// bf16 = 49 MB) about fill the 50 MB L2, so most corner rows come from L2.
//
// Design: one warp per (view, reference pixel); lanes spread over the C
// channels (C / 32 contiguous channels per lane, one vector load per corner
// row).  The warp keeps its reference row in registers and walks the D
// planes, so ref is read once instead of D times; the four corners are
// computed inline from (x_eff, y_eff) — no quad-row image, no pair packing,
// no group-range tables (those worked around Mosaic's gather lowering).
// Corners outside the image are skipped, never loaded.  One shuffle
// reduction per plane, lane 0 writes the f32 result.
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(256) sweep_fwd_kernel(
    const T* __restrict__ src,      // (N, H, W, C) neighbour features
    const T* __restrict__ ref,      // (N, H, W, C) reference features
    const float* __restrict__ xe,   // (N, D, H*W) sample x in src pixels
    const float* __restrict__ ye,   // (N, D, H*W) sample y in src pixels
    float* __restrict__ out,        // (N, D, H*W)
    int n, int h, int w, int d, float inv_sqrt_c) {
  constexpr int C = 32 * VEC;
  const int lane = threadIdx.x & 31;
  const long long hw = (long long)h * w;
  const long long warp_id =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id >= (long long)n * hw) return;
  const long long cam = warp_id / hw;
  const long long pix = warp_id - cam * hw;

  float r[VEC];
  sgc::load_f32<T, VEC>(ref + (cam * hw + pix) * C + lane * VEC, r);
  const T* sbase = src + cam * hw * C + lane * VEC;

  for (int di = 0; di < d; ++di) {
    const long long idx = (cam * d + di) * hw + pix;
    const float x = sgc::clip_coord(xe[idx], -4.f, w + 4.f);
    const float y = sgc::clip_coord(ye[idx], -4.f, h + 4.f);
    const float x0f = floorf(x), y0f = floorf(y);
    const float lx = x - x0f, ly = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;

    float warped[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) warped[i] = 0.f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1, dx = corner & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      if (yi < 0 || yi > h - 1 || xi < 0 || xi > w - 1) continue;
      const float wgt = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx);
      float v[VEC];
      sgc::load_f32<T, VEC>(sbase + ((long long)yi * w + xi) * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) warped[i] += wgt * v[i];
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += warped[i] * r[i];
    s = sgc::warp_sum(s);
    if (lane == 0) out[idx] = s * inv_sqrt_c;
  }
}

template <typename T, int VEC>
void launch(const void* src, const void* ref, const float* xe, const float* ye,
            float* out, int n, int h, int w, int d, float inv_sqrt_c,
            cudaStream_t stream) {
  const long long warps = (long long)n * h * w;
  const int threads = 256;
  const long long blocks = (warps + (threads / 32) - 1) / (threads / 32);
  sweep_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), xe, ye, out, n,
      h, w, d, inv_sqrt_c);
}

template <typename T>
int dispatch(int c, const void* src, const void* ref, const float* xe,
             const float* ye, float* out, int n, int h, int w, int d,
             float inv_sqrt_c, cudaStream_t stream) {
  switch (c) {
    case 128: launch<T, 4>(src, ref, xe, ye, out, n, h, w, d, inv_sqrt_c, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sgc_sweep_fwd(int dtype, const void* src, const void* ref,
                             const float* x_eff, const float* y_eff,
                             float* out, int n, int h, int w, int c, int d,
                             void* stream) {
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sgc::kBFloat16)
    return dispatch<__nv_bfloat16>(c, src, ref, x_eff, y_eff, out, n, h, w, d,
                                   inv_sqrt_c, s);
  if (dtype == sgc::kFloat32)
    return dispatch<float>(c, src, ref, x_eff, y_eff, out, n, h, w, d,
                           inv_sqrt_c, s);
  return (int)cudaErrorInvalidValue;
}
