// Windowed DFA3D sampling forward for spatially sorted queries, c = 16, 32
// or 256 channels a head (counters `dfa3d_win_fwd_mh` at 32 and 256,
// `dfa3d_win_fwd_mh_c16` at 16, the -L configs' width).
//
// Replaces the windowed multi-head TPU forwards of
// experiments/dfa3d_pallas4.py (_fwd_kernel_w: multi-head, full-width rows;
// _fwd_kernel_wh: per head) and experiments/dfa3d_pallas5.py
// (_fwd_kernel_ws: per head over raw rows).  They compute the function of
// dfa3d_fwd.cu, which is spelled out there, for queries ordered by their
// projected pixel (ModelConfig.sort_queries).  On the TPU, which has no
// gather, a chunk's rows came from a window of the image by a one-hot
// selection matrix on the MXU.  The idea carried over: the samples of a
// chunk of consecutive sorted queries fall in a narrow band of pixels
// y * W + x, so that band can sit in fast memory.
//
// The windowed stage 1 (_fwd_kernel_w_s1, heads = P = 1) is K2
// (csrc/dfa3d_fwd.cu), which ops/dfa3d_windowed.py sends it to: a sorted
// stage-1 chunk's union window spans 152 / 284 / 1014 pixels (p50 / p90 /
// max, level 2) for at most 64 corner reads, so staging its depth bins
// moves more bytes than it saves; with nothing staged, K2's warp run over
// a chunk of 16 queries a block measured within 2 % of K2 (PERF.md).
//
// Multi-head (dfa3d_win_fwd_mh_kernel): one block of 256 threads per
// (chunk of qc queries, view), all heads: qc = 16 at c = 32 and 256, 64 at
// c = 16 (ops/dfa3d_windowed.py::QC_FWD).  The block first finds its
// window [base, base + span): the lowest and highest pixel an in-image
// corner of its counted samples reads, over every head and point
// (sgc::union_window, one sync; the plain version's ops/dfa3d_windowed.py::
// plan_windows computes the same union in PyTorch).  Where the span fits
// the wwin pixels the launch reserves, it copies the window's depth bins
// into shared memory as f32 (cp.async, 16 bytes a copy, for f32 depth).
// Then each warp takes items of the chunk and runs K3's warp
// (sgc::mh_fwd_warp, csrc/dfa3d_mh.cuh) on K3's rows (sgc::WarpRows::span):
// an item is a head group of as many whole consecutive queries as a warp
// holds (one query at 8 heads of 32 or 256 channels; two at c = 16, where
// a query's 8 heads fill half a warp), the counted ones first and a view's
// last query alone where K is odd.
// The warp computes eight channels a lane, the
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
// at c = 32 (32 and 8 ran 2 and 12 % slower); at c = 16, whose chunk
// unions span ~740 pixels at the sorted -L level 2 at any chunk length,
// chunks of 64 (16 ran 1.46x slower, 32 1.12x, 128 1 % slower); one point a round (PG = 1: no spill,
// where K3's two spilled 16 bytes and ran 16 % slower); three blocks an SM;
// blocks a view's chunks after one another (a chunk's views after one
// another ran the sorted level 2 5 % faster but random locations 11 %
// slower: forty views' value maps at once exceed the L2).  The value rows are not staged: at level 2 a chunk-head
// reads about 1.8 value rows per pixel of its band, so staging them would
// move as many bytes as the gathers they replace.
#include "dfa3d_mh.cuh"

namespace {

constexpr int kMhThreads = 256;

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
  // a warp's item: qpw whole queries (two at C = 16, one at 8 heads of 32
  // or 256 channels) and a head group
  const int qpw = sgc::WarpRows<HPW>::queries(heads);
  const int items = (q1 - q0 + qpw - 1) / qpw * hgroups;
  for (int item = threadIdx.x >> 5; item < items; item += kMhThreads / 32) {
    const int q = q0 + item / hgroups * qpw, h0 = (item % hgroups) * HPW;
    sgc::mh_fwd_warp<VT, DT, C, 1>(
        vmap, locs, attn, out,
        sgc::WarpRows<HPW>::span((long long)cam * k, q, q1, count, h0, heads),
        h, w, heads, dsize, p, dep);
  }
}

// Dynamic shared memory of a block: the window's depth bins in f32
// (ops/dfa3d_windowed.py::window_bytes computes the same).
size_t window_smem(int dsize, int wwin) { return (size_t)wwin * dsize * sizeof(float); }

template <typename VT, typename DT, int C>
int launch_mh(const void* value, const void* depth, const float* locs,
              const float* attn, const int* counts, void* out, int n, int h,
              int w, int heads, int dsize, int k, int p, int qc, int wwin,
              cudaStream_t stream) {
  const size_t smem = window_smem(dsize, wwin);
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
// (N,) int32 or null -> out (N, K, heads*c) of type vdtype, c = 16, 32 or 256;
// chunks of qc queries, windows of at most wwin pixels.
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
    if (c == 16)
      return launch_mh<VT, DT, 16>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, qc, wwin, s);
    if (c == 32)
      return launch_mh<VT, DT, 32>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, qc, wwin, s);
    if (c == 256)
      return launch_mh<VT, DT, 256>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, qc, wwin, s);
    return (int)cudaErrorInvalidValue;
  });
}

// The resources of the kernel that sgc_dfa3d_win_fwd launches for these
// types, c, dsize and wwin: out[5] as sgc::kernel_attributes writes it.
extern "C" int sgc_dfa3d_win_fwd_attributes(int vdtype, int ddtype, int c, int dsize,
                                            int wwin, int* out) {
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    const size_t smem = window_smem(dsize, wwin);
    if (c == 16)
      return sgc::kernel_attributes(dfa3d_win_fwd_mh_kernel<VT, DT, 16>, kMhThreads, smem, out);
    if (c == 32)
      return sgc::kernel_attributes(dfa3d_win_fwd_mh_kernel<VT, DT, 32>, kMhThreads, smem, out);
    if (c == 256)
      return sgc::kernel_attributes(dfa3d_win_fwd_mh_kernel<VT, DT, 256>, kMhThreads, smem, out);
    return (int)cudaErrorInvalidValue;
  });
}
