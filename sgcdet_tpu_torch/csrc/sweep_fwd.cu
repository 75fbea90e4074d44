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
// What bounds it on this card: the corner-row gathers.  Each (n, d, p)
// reads four C-channel rows of src at data-dependent addresses (4 x 128 x
// 2 B in bf16 at the ScanNet width: 2.4 GB of row reads per call, 4.7 GB
// in f32) for about one flop per gathered byte.  The 40-view src maps (40
// x 60 x 80 x 128 bf16 = 49 MB) about fill the 50 MB L2, and a view's 12
// planes sample its neighbour's map only, so the rows come from L2 (and,
// in f32, L1: neighbouring reference pixels of one plane share corners).
// The earlier design, a warp per (view, reference pixel) walking its
// planes in series, moved its rows at about 6 TB/s; 2D tiles of 16 x 4 or
// 8 x 8 pixels, meant to share corners in L1, were slower still (PERF.md).
//
// Design: one block per tile of TP consecutive reference pixels of one
// view, covering all D planes, TP x DCH samples at a time.
//   1. The block reads the tile's x and y of DCH planes (coalesced rows of
//      TP floats), and one thread per sample clips them and computes its
//      four corner pixels (-1 off the image) and bilinear weights into
//      shared memory, so no lane repeats that arithmetic or its loads.
//   2. A half-warp takes one sample (16 lanes x 8 channels = one 128-channel
//      row: 16 bytes a lane in bf16, 32 in f32), so a warp instruction
//      serves two samples.  It keeps its pixel's ref row in registers,
//      issues the corner loads of G planes before any multiply-add, and
//      reduces each dot product over its 16 lanes (4 shuffle steps).  The
//      half-warps of a block walk neighbouring pixels of the same planes.
//   3. The results collect in shared memory and are written as rows of TP
//      floats per plane, instead of 4 bytes from one lane per sample.
// The tile's edge may be ragged (H * W need not be a multiple of TP): the
// samples past it load nothing and store nothing.  Corners outside the
// image are never loaded.  No quad-row image, no pair packing, no
// group-range tables (those worked around Mosaic's gather lowering).
#include "common.cuh"

namespace {

constexpr int C = 128;           // channels (the matching net's width)
constexpr int VEC = 8;           // channels per lane
constexpr int LANES = C / VEC;   // lanes per sample: a half-warp
constexpr int THREADS = 256;
constexpr int SLOTS = THREADS / LANES;  // samples a block computes at once
constexpr int TP = 64;           // reference pixels per block
constexpr int DCH = 16;          // planes staged at a time

// Per value type, as measured on the H100 (PERF.md): the planes whose
// corner loads a half-warp issues together (G), the blocks an SM must hold
// (which sets the register budget), and whether the corner rows bypass L1.
// bf16 rows run 25 % faster from L2 alone (ld.global.cg); f32 rows need
// L1, and run 2.6x slower without it.  Fewer planes in flight and more
// blocks an SM won over 4 planes (2 in f32) and 2 blocks.
template <typename T> struct Tuning;
template <> struct Tuning<__nv_bfloat16> {
  static constexpr int G = 2, MIN_BLOCKS = 3;
  static constexpr bool L2_ONLY = true;
};
template <> struct Tuning<float> {
  static constexpr int G = 1, MIN_BLOCKS = 4;
  static constexpr bool L2_ONLY = false;
};

// One sample's corner row piece: VEC channels at p, 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_corner(sgc::Vec<T, VEC>& r, const T* p) {
  if constexpr (Tuning<T>::L2_ONLY) {
    const int4* q = reinterpret_cast<const int4*>(p);
    int4* o = reinterpret_cast<int4*>(&r);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(r) / 16); ++i) o[i] = __ldcg(q + i);
  } else {
    r = *reinterpret_cast<const sgc::Vec<T, VEC>*>(p);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Tuning<T>::MIN_BLOCKS) sweep_fwd_kernel(
    const T* __restrict__ src,      // (N, H, W, C) neighbour features
    const T* __restrict__ ref,      // (N, H, W, C) reference features
    const float* __restrict__ xe,   // (N, D, H*W) sample x in src pixels
    const float* __restrict__ ye,   // (N, D, H*W) sample y in src pixels
    float* __restrict__ out,        // (N, D, H*W)
    int h, int w, int d, float inv_sqrt_c) {
  constexpr int G = Tuning<T>::G;  // planes whose corners load together
  __shared__ int4 s_pix[DCH * TP];     // corner pixels, -1 off the image
  __shared__ float4 s_wgt[DCH * TP];   // bilinear weights
  __shared__ float s_out[DCH * TP];
  const int hw = h * w;
  const int cam = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int slot = threadIdx.x / LANES;
  const int sub = threadIdx.x % LANES;
  const T* sbase = src + (long long)cam * hw * C + sub * VEC;

  for (int dc0 = 0; dc0 < d; dc0 += DCH) {
    const int nd = min(DCH, d - dc0);
    // 1. one thread per sample of the chunk
    for (int t = threadIdx.x; t < nd * TP; t += THREADS) {
      const int di = t / TP, pix = p0 + t % TP;
      int4 cp = make_int4(-1, -1, -1, -1);
      float4 cw = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix < hw) {
        const long long idx = ((long long)cam * d + dc0 + di) * hw + pix;
        const float x = sgc::clip_coord(xe[idx], -4.f, w + 4.f);
        const float y = sgc::clip_coord(ye[idx], -4.f, h + 4.f);
        const float x0f = floorf(x), y0f = floorf(y);
        const float lx = x - x0f, ly = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const bool xin0 = x0 >= 0 && x0 <= w - 1, xin1 = x0 + 1 >= 0 && x0 + 1 <= w - 1;
        const bool yin0 = y0 >= 0 && y0 <= h - 1, yin1 = y0 + 1 >= 0 && y0 + 1 <= h - 1;
        const int base = y0 * w + x0;
        cp = make_int4(yin0 && xin0 ? base : -1, yin0 && xin1 ? base + 1 : -1,
                       yin1 && xin0 ? base + w : -1, yin1 && xin1 ? base + w + 1 : -1);
        cw = make_float4((1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx), ly * lx);
      }
      s_pix[t] = cp;
      s_wgt[t] = cw;
    }
    __syncthreads();
    // 2. a half-warp per sample; both half-warps of a warp run the same
    // trip counts (TP is a multiple of SLOTS), so the shuffles are uniform
    for (int pi = slot; pi < TP; pi += SLOTS) {
      const int pix = p0 + pi;
      float r[VEC];
      if (pix < hw) {
        sgc::load_f32<T, VEC>(ref + ((long long)cam * hw + pix) * C + sub * VEC, r);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r[j] = 0.f;
      }
      for (int di0 = 0; di0 < nd; di0 += G) {
        int cp[G][4];
        float cw[G][4];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int t = min(di0 + i, nd - 1) * TP + pi;
          const int4 a = s_pix[t];
          const float4 b = s_wgt[t];
          const bool live = di0 + i < nd;
          cp[i][0] = live ? a.x : -1;
          cp[i][1] = live ? a.y : -1;
          cp[i][2] = live ? a.z : -1;
          cp[i][3] = live ? a.w : -1;
          cw[i][0] = b.x;
          cw[i][1] = b.y;
          cw[i][2] = b.z;
          cw[i][3] = b.w;
        }
        sgc::Vec<T, VEC> raw[G][4];
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            if (cp[i][corner] >= 0)
              load_corner<T>(raw[i][corner], sbase + (long long)cp[i][corner] * C);
            else
#pragma unroll
              for (int j = 0; j < VEC; ++j) raw[i][corner].v[j] = sgc::from_f32<T>(0.f);
          }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          float warped[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) warped[j] = 0.f;
#pragma unroll
          for (int corner = 0; corner < 4; ++corner)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              warped[j] += cw[i][corner] * sgc::to_f32(raw[i][corner].v[j]);
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) s += warped[j] * r[j];
          s = sgc::group_sum<LANES>(s);
          if (sub == 0 && di0 + i < nd) s_out[(di0 + i) * TP + pi] = s * inv_sqrt_c;
        }
      }
    }
    __syncthreads();
    // 3. rows of TP floats per plane
    for (int t = threadIdx.x; t < nd * TP; t += THREADS) {
      const int di = t / TP, pix = p0 + t % TP;
      if (pix < hw) out[((long long)cam * d + dc0 + di) * hw + pix] = s_out[t];
    }
    __syncthreads();  // the next chunk reuses the shared buffers
  }
}

template <typename T>
void launch(const void* src, const void* ref, const float* xe, const float* ye,
            float* out, int n, int h, int w, int d, float inv_sqrt_c,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((h * w + TP - 1) / TP), (unsigned)n);
  sweep_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), xe, ye, out, h,
      w, d, inv_sqrt_c);
}

}  // namespace

extern "C" int sgc_sweep_fwd(int dtype, const void* src, const void* ref,
                             const float* x_eff, const float* y_eff,
                             float* out, int n, int h, int w, int c, int d,
                             void* stream) {
  const float inv_sqrt_c = 1.f / sqrtf((float)c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c != C) return (int)cudaErrorInvalidValue;
  if (n == 0 || h * w == 0 || d == 0) return (int)cudaSuccess;
  if (dtype == sgc::kBFloat16)
    launch<__nv_bfloat16>(src, ref, x_eff, y_eff, out, n, h, w, d, inv_sqrt_c, s);
  else if (dtype == sgc::kFloat32)
    launch<float>(src, ref, x_eff, y_eff, out, n, h, w, d, inv_sqrt_c, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
