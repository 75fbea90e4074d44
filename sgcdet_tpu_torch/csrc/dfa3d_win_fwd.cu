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
// Multi-head (dfa3d_win_fwd_mh_kernel): one block of 256 threads per
// (chunk of qc = 16 queries, view), all heads.  The block first finds its
// window [base, base + span): the lowest and highest pixel an in-image
// corner of its counted samples reads, over every head and point
// (sgc::union_window, one sync; the plain version's ops/dfa3d_windowed.py::
// plan_windows computes the same union in PyTorch).  Where the span fits
// the wwin pixels the launch reserves, it copies the window's depth bins
// into shared memory as f32 (cp.async, 16 bytes a copy, for f32 depth).
// Then each warp takes (query, head group) items of the chunk and runs K3's
// warp (sgc::mh_fwd_warp, csrc/dfa3d_mh.cuh): eight channels a lane, the
// sample computed once per (head, point), the value rows gathered from
// global memory (L2) in 16-byte loads, one 512-byte store a query.  Only
// the depth bins come from the window; a corner outside it (none, when
// plan and kernel agree, which pixel_coord ensures), and every corner of a
// chunk whose window is wider than wwin, is read from global memory as K3
// reads it.  Queries at or past valid_counts[n] are written as zeros; a
// chunk past the count finds no window and stages nothing.
//
// What bounds it on this card: as K3, the value gathers and the zeros of
// the counted-out rows; the window only moves the depth bins from L2 to
// shared memory, and those gathers were in flight beside the value rows'
// (PERF.md).  What the block adds is a prologue: the union (one sync)
// and the staging (an L2 round trip, ~48 B a pixel, before any value load
// of the block).  Measured choices (H100 80GB HBM3, PERF.md): chunks of 16
// (32 and 8 ran 2 and 12 % slower); one point a round (PG = 1: no spill,
// where K3's two spilled 16 bytes and ran 16 % slower); three blocks an SM;
// blocks a view's chunks after one another (a chunk's views after one
// another ran the sorted level 2 5 % faster but random locations 11 %
// slower: forty views' value maps at once exceed the L2).  The value rows are not staged: at level 2 a chunk-head
// reads about 1.8 value rows per pixel of its band, so staging them would
// move as many bytes as the gathers they replace.
//
// Stage 1 (heads = P = 1, c = 256: dfa3d_win_fwd_s1_kernel) keeps the
// earlier design: one block per (32-channel slice of the value row, chunk,
// view) that stages the slice's value channels and the depth bins of its
// window and computes a query per warp, a channel per lane.
#include "dfa3d_mh.cuh"

namespace {

constexpr int kSlice = 32;  // stage 1: value channels per block, one per lane
constexpr int kS1Threads = 512;
constexpr int kMhThreads = 256;

template <typename VT, typename DT>
__global__ void __launch_bounds__(kS1Threads) dfa3d_win_fwd_s1_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int h, int w, int heads, int c, int dsize, int k, int p, int qc, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 s_warp[kS1Threads / 32];
  VT* s_val = reinterpret_cast<VT*>(smem);  // [wwin][kSlice]
  float* s_dpt = reinterpret_cast<float*>(smem + (size_t)wwin * kSlice * sizeof(VT));
  const int slice = blockIdx.x, chunk = blockIdx.y, cam = blockIdx.z;
  const int head = slice * kSlice / c;
  const int cfull = heads * c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = counts == nullptr ? k : counts[cam];
  const int q0 = chunk * qc, q1 = min(k, q0 + qc);
  const int2 box = sgc::union_window<kS1Threads>(
      locs + ((long long)cam * k + q0) * 3, max(0, min(q1, count) - q0), h, w, s_warp);
  const int base = box.x, span = box.y >= 0 ? box.y - box.x + 1 : 0;
  const long long hw = (long long)h * w;
  const VT* vmap = value + cam * hw * cfull + slice * kSlice;  // pixel stride cfull
  const DT* dmap = depth + cam * hw * dsize;
  const bool staged = span > 0 && span <= wwin;

  if (staged) {
    constexpr int kVec = 16 / sizeof(VT);      // elements per 16-byte copy
    constexpr int kParts = kSlice / kVec;      // copies per pixel
    for (int i = threadIdx.x; i < span * kParts; i += kS1Threads) {
      const int r = i / kParts, part = i - r * kParts;
      sgc::cp_async16(s_val + r * kSlice + part * kVec,
                      vmap + (long long)(base + r) * cfull + part * kVec);
    }
    const DT* dsrc = dmap + (long long)base * dsize;
    for (int i = threadIdx.x; i < span * dsize; i += kS1Threads)
      s_dpt[i] = sgc::to_f32(dsrc[i]);
    sgc::cp_async_wait_all();
  }
  __syncthreads();

  for (int q = q0 + warp; q < q1; q += kS1Threads / 32) {
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

template <typename VT, typename DT, int C>
__global__ void __launch_bounds__(kMhThreads, 3) dfa3d_win_fwd_mh_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int h, int w, int heads, int dsize, int k, int p, int qc, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 s_warp[kMhThreads / 32];
  constexpr int HPW = 32 / (C / 8);  // heads per warp
  const int hgroups = (heads + HPW - 1) / HPW;
  const int chunk = blockIdx.x, cam = blockIdx.y;
  const int count = counts == nullptr ? k : counts[cam];
  const int q0 = chunk * qc, q1 = min(k, q0 + qc);
  const int nqc = max(0, min(q1, count) - q0);  // counted queries of the chunk
  int2 box = make_int2(0, -1);
  if (nqc > 0 && wwin > 0)  // uniform over the block
    box = sgc::union_window<kMhThreads>(locs + ((long long)cam * k + q0) * heads * p * 3,
                                        nqc * heads * p, h, w, s_warp);
  const int span = box.y >= 0 ? box.y - box.x + 1 : 0;
  const bool staged = span > 0 && span <= wwin;
  const long long hw = (long long)h * w;
  const DT* dmap = depth + cam * hw * dsize;
  float* s_dpt = reinterpret_cast<float*>(smem);  // [wwin][D]
  if (staged) {  // uniform over the block
    sgc::stage_depth(s_dpt, dmap, box.x, span, dsize);
    __syncthreads();
  }

  const sgc::WindowDepth<DT> dep{{dmap, nullptr, dsize}, s_dpt, nullptr, box.x,
                                 staged ? span : 0};
  const VT* vmap = value + cam * hw * heads * C;
  for (int item = threadIdx.x >> 5; item < (q1 - q0) * hgroups; item += kMhThreads / 32) {
    const int q = q0 + item / hgroups;
    sgc::mh_fwd_warp<VT, DT, C, 1>(vmap, locs, attn, out, (long long)cam * k + q,
                                   q < count, (item % hgroups) * HPW, h, w, heads,
                                   dsize, p, dep);
  }
}

// Dynamic shared memory of each kernel's block (ops/dfa3d_windowed.py::
// window_bytes computes the same).
template <typename VT>
size_t s1_smem(int dsize, int wwin) {
  return (size_t)wwin * (kSlice * sizeof(VT) + dsize * sizeof(float));
}
size_t mh_smem(int dsize, int wwin) { return (size_t)wwin * dsize * sizeof(float); }

template <typename VT, typename DT>
int launch_s1(const void* value, const void* depth, const float* locs,
              const float* attn, const int* counts, void* out, int n, int h,
              int w, int heads, int c, int dsize, int k, int p, int qc, int wwin,
              cudaStream_t stream) {
  if (c % kSlice != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = s1_smem<VT>(dsize, wwin);
  auto kernel = dfa3d_win_fwd_s1_kernel<VT, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads * c / kSlice, (k + qc - 1) / qc, n);
  kernel<<<grid, kS1Threads, smem, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<VT*>(out), h, w, heads, c, dsize, k, p, qc, wwin);
  return (int)cudaGetLastError();
}

template <typename VT, typename DT, int C>
int launch_mh(const void* value, const void* depth, const float* locs,
              const float* attn, const int* counts, void* out, int n, int h,
              int w, int heads, int dsize, int k, int p, int qc, int wwin,
              cudaStream_t stream) {
  const size_t smem = mh_smem(dsize, wwin);
  auto kernel = dfa3d_win_fwd_mh_kernel<VT, DT, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (k + qc - 1) / qc;
  const dim3 grid(nchunk, n);  // a view's chunks after one another
  kernel<<<grid, kMhThreads, smem, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<VT*>(out), h, w, heads, dsize, k, p, qc, wwin);
  return (int)cudaGetLastError();
}

}  // namespace

// value (N, H, W, heads*c) of type vdtype, depth (N, H, W, dsize) of type
// ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P) f32, counts
// (N,) int32 or null -> out (N, K, heads*c) of type vdtype.  heads = P = 1
// (stage 1) takes c a multiple of 32, multi-head c = 32 or 256; chunks of
// qc queries; windows of at most wwin pixels.
extern "C" int sgc_dfa3d_win_fwd(int vdtype, int ddtype, const void* value,
                                 const void* depth, const float* locs,
                                 const float* attn, const int* counts,
                                 void* out, int n, int h, int w, int heads,
                                 int c, int dsize, int k, int p, int qc,
                                 int wwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if (qc <= 0 || wwin < 0) return (int)cudaErrorInvalidValue;
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    if (heads == 1 && p == 1)
      return launch_s1<VT, DT>(value, depth, locs, attn, counts, out, n, h, w, heads, c, dsize, k, p, qc, wwin, s);
    if (c == 32)
      return launch_mh<VT, DT, 32>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, qc, wwin, s);
    if (c == 256)
      return launch_mh<VT, DT, 256>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, qc, wwin, s);
    return (int)cudaErrorInvalidValue;
  });
}

// The resources of the kernel that sgc_dfa3d_win_fwd launches for these
// types, stage (stage1: heads = P = 1), c, dsize and wwin: out[5] as
// sgc::kernel_attributes writes it.
extern "C" int sgc_dfa3d_win_fwd_attributes(int vdtype, int ddtype, int stage1,
                                            int c, int dsize, int wwin, int* out) {
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    if (stage1)
      return sgc::kernel_attributes(dfa3d_win_fwd_s1_kernel<VT, DT>, kS1Threads,
                                    s1_smem<VT>(dsize, wwin), out);
    if (c == 32)
      return sgc::kernel_attributes(dfa3d_win_fwd_mh_kernel<VT, DT, 32>, kMhThreads,
                                    mh_smem(dsize, wwin), out);
    if (c == 256)
      return sgc::kernel_attributes(dfa3d_win_fwd_mh_kernel<VT, DT, 256>, kMhThreads,
                                    mh_smem(dsize, wwin), out);
    return (int)cudaErrorInvalidValue;
  });
}
