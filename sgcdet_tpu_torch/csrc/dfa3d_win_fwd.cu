// Windowed DFA3D sampling forward for spatially sorted queries (counters
// `dfa3d_win_fwd_s1` and `dfa3d_win_fwd_mh`, one entry point).
//
// Replaces the windowed TPU forwards of experiments/dfa3d_pallas4.py
// (_fwd_kernel_w: multi-head, full-width rows; _fwd_kernel_w_s1: stage 1;
// _fwd_kernel_wh: per head) and experiments/dfa3d_pallas5.py
// (_fwd_kernel_ws: per head over raw rows).  They compute the function of
// dfa3d_fwd.cu, which is spelled out there, for queries ordered by their
// projected pixel (ModelConfig.sort_queries).  On the TPU, which has no
// gather, a chunk's rows came from a window of the image by a one-hot
// selection matrix on the MXU.  The idea carried over: the samples of a
// chunk of consecutive sorted queries fall in a narrow band of pixels
// y * W + x, so that band can sit in fast memory.
//
// Design: one block per (32-channel slice of the value row, chunk of qc
// queries, view).  A multi-head slice is one head (c = 32); stage 1's
// c = 256 is eight slices, each recomputing the sample's depth score.  The
// block first finds its window [base, base + span): the lowest and highest
// pixel an in-image corner of its counted samples reads (block_window, a
// block-wide min/max over the chunk's coordinates; the plain version's
// ops/dfa3d_windowed.py::plan_windows computes the same windows in PyTorch).
// Where the span fits the wwin pixels of shared memory, the block copies
// the slice's value channels of its pixels
// (cp.async, 16 bytes a copy) and their depth bins (converted to f32) into
// shared memory, then each warp computes queries of the chunk, lanes over
// the 32 channels, exactly as dfa3d_fwd.cu does but reading the corners from
// shared memory; a corner outside the window (none, when plan and kernel
// agree, which pixel_coord ensures) is read from global memory.  Without a
// window the block reads global memory as the template does: that branch is
// exact and part of the kernel.  Queries at or past valid_counts[n] are
// written as zeros; a chunk past the count stages nothing.
//
// What bounds it on this card: the staged bytes and the gathers.  A window
// of 1024 pixels at bf16 value and f32 depth with 12 bins is 112 KB, so two
// blocks of 512 threads share an SM (32 warps: the gathers are latency
// bound, and 256 threads, 16 warps, ran them several times slower than the
// template); the plan's window length follows the shared memory a pixel
// takes (ops/dfa3d_windowed.py::window_pixels).  Staging reads each
// band pixel once per block, while the template reads every corner of every
// sample (neighbouring queries share corners; L2 holds most of them): the
// window wins only where the samples reuse the band's pixels more than the
// L2 already lets them.
#include "common.cuh"

namespace {

constexpr int kSlice = 32;  // value channels per block: one per lane
constexpr int kThreads = 512;

template <typename VT, typename DT>
__global__ void __launch_bounds__(kThreads) dfa3d_win_fwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int h, int w, int heads, int c, int dsize, int k, int p, int qc, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2];
  VT* s_val = reinterpret_cast<VT*>(smem);  // [wwin][kSlice]
  float* s_dpt = reinterpret_cast<float*>(smem + (size_t)wwin * kSlice * sizeof(VT));
  const int slice = blockIdx.x, chunk = blockIdx.y, cam = blockIdx.z;
  const int head = slice * kSlice / c;
  const int cfull = heads * c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = counts == nullptr ? k : counts[cam];
  const int q0 = chunk * qc, q1 = min(k, q0 + qc);
  const int2 box = sgc::block_window(
      locs + (((long long)cam * k + q0) * heads + head) * p * 3, (long long)heads * p * 3,
      p, max(0, min(q1, count) - q0), h, w, s_box);
  const int base = box.x, span = box.y >= 0 ? box.y - box.x + 1 : 0;
  const long long hw = (long long)h * w;
  const VT* vmap = value + cam * hw * cfull + slice * kSlice;  // pixel stride cfull
  const DT* dmap = depth + cam * hw * dsize;
  const bool staged = span > 0 && span <= wwin;

  if (staged) {
    constexpr int kVec = 16 / sizeof(VT);      // elements per 16-byte copy
    constexpr int kParts = kSlice / kVec;      // copies per pixel
    for (int i = threadIdx.x; i < span * kParts; i += kThreads) {
      const int r = i / kParts, part = i - r * kParts;
      sgc::cp_async16(s_val + r * kSlice + part * kVec,
                      vmap + (long long)(base + r) * cfull + part * kVec);
    }
    const DT* dsrc = dmap + (long long)base * dsize;
    for (int i = threadIdx.x; i < span * dsize; i += kThreads)
      s_dpt[i] = sgc::to_f32(dsrc[i]);
    sgc::cp_async_wait_all();
  }
  __syncthreads();

  for (int q = q0 + warp; q < q1; q += kThreads / 32) {
    float acc = 0.f;
    if (q < count) {
      const long long sid = ((long long)cam * k + q) * heads + head;
      const float* lp = locs + sid * p * 3;
      const float* ap = attn + sid * p;
      for (int pt = 0; pt < p; ++pt) {
        const float u = sgc::pixel_coord(lp[3 * pt], w);
        const float v = sgc::pixel_coord(lp[3 * pt + 1], h);
        const float dd = sgc::pixel_coord(lp[3 * pt + 2], dsize);
        const float a = ap[pt];
        const float x0f = floorf(u), y0f = floorf(v), d0f = floorf(dd);
        const float lx = u - x0f, ly = v - y0f, ld = dd - d0f;
        const int x0 = (int)x0f, y0 = (int)y0f, d0 = (int)d0f;
        const float wd0 = (d0 >= 0 && d0 <= dsize - 1) ? 1.f - ld : 0.f;
        const float wd1 = (d0 + 1 >= 0 && d0 + 1 <= dsize - 1) ? ld : 0.f;
        const int d0c = min(max(d0, 0), dsize - 1);
        const int d1c = min(max(d0 + 1, 0), dsize - 1);
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
          const int dy = corner >> 1, dx = corner & 1;
          const int yi = y0 + dy, xi = x0 + dx;
          if (yi < 0 || yi > h - 1 || xi < 0 || xi > w - 1) continue;
          const int pix = yi * w + xi;
          const int rel = pix - base;
          float dp0, dp1, val;
          if (staged && rel >= 0 && rel < span) {
            const float* dr = s_dpt + rel * dsize;
            dp0 = dr[d0c];
            dp1 = dr[d1c];
            val = sgc::to_f32(s_val[rel * kSlice + lane]);
          } else {
            const DT* dr = dmap + (long long)pix * dsize;
            dp0 = sgc::to_f32(dr[d0c]);
            dp1 = sgc::to_f32(dr[d1c]);
            val = sgc::to_f32(vmap[(long long)pix * cfull + lane]);
          }
          const float wgt = ((dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * a)
                            * (dp0 * wd0 + dp1 * wd1);
          acc += wgt * val;
        }
      }
    }
    out[((long long)cam * k + q) * cfull + slice * kSlice + lane] = sgc::from_f32<VT>(acc);
  }
}

template <typename VT, typename DT>
int launch(const void* value, const void* depth, const float* locs,
           const float* attn, const int* counts, void* out, int n, int h,
           int w, int heads, int c, int dsize, int k, int p, int qc, int wwin,
           cudaStream_t stream) {
  const size_t smem = (size_t)wwin * (kSlice * sizeof(VT) + dsize * sizeof(float));
  auto kernel = dfa3d_win_fwd_kernel<VT, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads * c / kSlice, (k + qc - 1) / qc, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<VT*>(out), h, w, heads, c, dsize, k, p, qc, wwin);
  return (int)cudaGetLastError();
}

}  // namespace

// value (N, H, W, heads*c) of type vdtype, depth (N, H, W, dsize) of type
// ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P) f32, counts
// (N,) int32 or null -> out (N, K, heads*c) of type vdtype.  c is a
// multiple of 32; chunks of qc queries; windows of at most wwin pixels.
extern "C" int sgc_dfa3d_win_fwd(int vdtype, int ddtype, const void* value,
                                 const void* depth, const float* locs,
                                 const float* attn, const int* counts,
                                 void* out, int n, int h, int w, int heads,
                                 int c, int dsize, int k, int p, int qc,
                                 int wwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if (c % kSlice != 0 || qc <= 0 || wwin <= 0) return (int)cudaErrorInvalidValue;
  if (ddtype == sgc::kBFloat16) {
    if (vdtype != sgc::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16, __nv_bfloat16>(value, depth, locs, attn, counts, out, n, h, w, heads, c, dsize, k, p, qc, wwin, s);
  }
  if (ddtype != sgc::kFloat32) return (int)cudaErrorInvalidValue;
  if (vdtype == sgc::kBFloat16)
    return launch<__nv_bfloat16, float>(value, depth, locs, attn, counts, out, n, h, w, heads, c, dsize, k, p, qc, wwin, s);
  if (vdtype == sgc::kFloat32)
    return launch<float, float>(value, depth, locs, attn, counts, out, n, h, w, heads, c, dsize, k, p, qc, wwin, s);
  return (int)cudaErrorInvalidValue;
}
