// Fused DFA3D sampling backward (kernels K6 `dfa3d_bwd_s1`, K5
// `dfa3d_bwd_mh` and their bf16-depth instances K6' `dfa3d_bwd_s1_bd`, K5'
// `dfa3d_bwd_mh_bd`): a multi-head template behind one entry point and the
// stage-1 design behind another; the wrapper counts the four apart.
//
// Replaces every Pallas DFA3D backward of sgcdet_tpu/ops:
// dfa3d_pallas.py::_bwd_kernel_s1 (stage 1: heads=1, P=1, attention 1, all
// C channels; launched by _run_bwd, selected at :527-529; it is also the
// backward of pq_s1 / pq_s1c, ops/dfa3d.py:44-73, which at bf16 takes bf16
// depth: K6'), dfa3d_pallas2.py::_bwd_kernel_v2 (stage 2: heads x P points,
// c channels per head; _run_bwd_v2; at bf16 depth the 2D path's stage 2:
// K5'), dfa3d_pallas.py::_bwd_kernel (v1 multi-head, f32) and
// dfa3d_pallas3.py::_bwd_kernel_q / _bwd_kernel_q_s1 (v3 f32 quad rows),
// together with the XLA chain that follows them on the TPU
// (dfa3d_pallas2.py:744-791, dfa3d_pallas.py:764-815): those kernels emit
// per-corner weight gradients and depth-vector gradients, and XLA turns
// them into location and attention gradients.  Here the chain is done in
// registers.  With the
// forward's notation (dfa3d_fwd.cu), for every (view n, query q, head h,
// point p) and each in-image corner with bilinear weight b, depth score
// s = dpt[d0c] * wd0 + dpt[d1c] * wd1 and attention a:
//
//   t          = <g[n, q, head channels], value[corner, head channels]>
//   d_value   += (b * a * s) * g
//   d_dpt[d0c]+= t * b * a * wd0,  d_dpt[d1c] += t * b * a * wd1
//   d_attn     = sum_corners t * b * s
//   d_lx, d_ly = sum_corners t * a * s * db/dlx, db/dly
//   d_ld       = sum_corners t * b * a * (valid1 * dpt[d1c] - valid0 * dpt[d0c])
//   d_locs     = (d_lx * W, d_ly * H, d_ld * D)   (pixel = loc * size - 0.5)
//
// Queries at or past valid_counts[n] get zero d_locs / d_attn and add
// nothing (dfa3d_pallas.py:448-465).  Coordinates are clipped as in the
// forward, so NaN and far-off samples touch no corner.  All gradients are
// summed in f32 (d_dpt too at bf16 depth).  With SAMPLE_GRADS off (stage 1
// in the model: its locations are fixed voxel centres and its attention is
// 1) only d_value and d_dpt are produced; with a null d_depth (the 2D path:
// its uniform depth is a constant) the depth gradient is skipped.  Where
// both are off (the 2D stage 1) nothing needs t, so DOT is off too: no
// value row is read and no dot product taken.
//
// Multi-head (K5, K5', c = 32 per head: every model path's): the scatter.
// Per (query, head, point, corner) the
// kernel gathers two depth bins and, with DOT, one c-channel value row, and
// adds c (+ 2) f32 values by atomics into zero-filled (N, H, W, C) (and
// (N, H, W, D)) buffers, which resolve in L2; the wrapper casts them once
// to the input dtypes.  The counted rows past each camera's visible count
// cost one broadcast load of the count.  Design (the warp's code is
// sgc::mh_bwd_warp in csrc/dfa3d_mh.cuh, which the windowed backward of
// the sorted path shares): eight contiguous channels per lane (one 16-byte
// load of a bf16 row piece, two of f32), so a head of c = 32 channels
// takes four lanes and a warp one query's eight heads.
// The incoming gradient row is loaded once into registers, in 16-byte
// pieces; each corner's dot product t is a reduction over the head's lanes
// (2 shuffle steps), after which every lane of the
// head carries the location and attention gradients; its first lane
// writes them once per point, and its first two lanes add the two d_dpt
// bins in one instruction (a single L2 request for the pair).  d_value
// takes two 16-byte vector reductions per lane per corner, laid out so
// that each instruction adds four whole 128-byte rows (a lane takes its
// target head's weight and pixel by shuffle): at c = 32 that is eight
// vector operations and two line requests per head and corner where the
// one-head-per-warp layout issued 32 scalar ones, and a warp walks its
// eight heads' samples side by side instead of one after another.
// Counted-out queries are per warp: zero location and attention gradients
// for its heads, nothing scattered.  launch_sg turns DOT off only with
// SAMPLE_GRADS off and a null d_depth.
//
// Stage 1 (K6, K6'): the sum where the output lives.  At the finest level
// only ~14 % of the queries are counted and their corners touch ~25 % of
// the pixels, 1.7 entries a touched pixel (at most ~25), so the atomic
// design spent most of its time around the kernel: zero-filling a 193 MB
// f32 d_value and casting it to bf16 afterwards (PERF.md).  Here every
// d_value and d_depth row is written once, at the input's dtype, zeros
// where no counted corner lies, by four kernels behind one entry point:
//   1. the list build (s1_lists_kernel, a block a view): each pixel's
//      count of (query, corner) entries in shared memory, their scan into
//      the view's list offsets, the pixels with more than kShortList
//      entries, and the lists' 32-byte records (4 q + corner, the weight
//      b a s of g[q] at the pixel, and b a wd0, b a wd1 and the two bins
//      for the depth gradient), the depth bins gathered at each corner;
//   2. the long pass (s1_long_kernel, a block a long list): the list
//      ordered by query through a bitmap, a run a warp, the warps' rows
//      summed in warp order, so a list of every query of a view does not
//      serialize;
//   3. the pixel pass (s1_pixels_kernel, a warp a tile of kTile pixels):
//      one load of the tile's list bounds, zero rows for its empty
//      pixels, then each short list in query order (the lanes rank their
//      entries by shuffle): the value row once (DOT), each entry's g[q] in
//      16-byte pieces and, with DOT, t = <g[q], value row> summed over the
//      lanes for the depth gradient and the sample gradients;
//   4. with SAMPLE_GRADS, the location and attention gradients, a thread a
//      query, from each corner's t.
// Every sum runs in a fixed order, so the gradients are equal from run to
// run.  Kernels 2 and 3 start while the one ahead of them ends
// (programmatic dependent launch) and wait before they read its lists.
// What bounds it on this card: bytes, mostly the d_value rows written
// (97 MB at bf16 for level 2), with a latency-bound list build ahead of
// them.  No pair/quad row images, no dquad/un-quad pass and no transposed
// windows (those worked around Mosaic).
#include "dfa3d_mh.cuh"

#include <climits>

namespace {

template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
__global__ void __launch_bounds__(256) dfa3d_bwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    const VT* __restrict__ g,        // (N, K, heads*c) incoming gradient
    float* __restrict__ d_value,     // (N, H, W, heads*c), zeroed by the caller
    float* __restrict__ d_depth,     // (N, H, W, D), zeroed by the caller, or null
    float* __restrict__ d_locs,      // (N, K, heads, P, 3) or null
    float* __restrict__ d_attn,      // (N, K, heads, P) or null
    int n, int h, int w, int heads, int dsize, int k, int p) {
  constexpr int HPW = 32 / (C / 8);  // heads per warp
  const int hgroups = (heads + HPW - 1) / HPW;
  const long long warp_id =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id >= (long long)n * k * hgroups) return;
  const int head0 = (int)(warp_id % hgroups) * HPW;
  const long long nq = warp_id / hgroups;  // cam * k + q
  const int q = (int)(nq % k);
  const int cam = (int)(nq / k);
  const long long hw = (long long)h * w, vstride = hw * heads * C;
  const sgc::GlobalDepth<DT> dep{depth + cam * hw * dsize,
                                 d_depth == nullptr ? nullptr : d_depth + cam * hw * dsize,
                                 dsize};
  sgc::mh_bwd_warp<VT, DT, C, SAMPLE_GRADS, DOT>(
      value + cam * vstride, locs, attn, g, d_value + cam * vstride, d_locs, d_attn, nq,
      counts == nullptr || q < counts[cam], head0, h, w, heads, dsize, p, dep);
}

template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
void launch(const void* value, const void* depth, const float* locs,
            const float* attn, const int* counts, const void* g, float* d_value,
            float* d_depth, float* d_locs, float* d_attn, int n, int h, int w,
            int heads, int dsize, int k, int p, cudaStream_t stream) {
  constexpr int HPW = 32 / (C / 8);  // heads per warp
  const long long warps = (long long)n * k * ((heads + HPW - 1) / HPW);
  const int threads = 256;
  const long long blocks = (warps + (threads / 32) - 1) / (threads / 32);
  dfa3d_bwd_kernel<VT, DT, C, SAMPLE_GRADS, DOT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<const VT*>(g), d_value, d_depth, d_locs, d_attn, n,
      h, w, heads, dsize, k, p);
}

template <typename VT, typename DT, int C>
void launch_sg(const void* value, const void* depth, const float* locs,
               const float* attn, const int* counts, const void* g,
               float* d_value, float* d_depth, float* d_locs, float* d_attn,
               int n, int h, int w, int heads, int dsize, int k, int p,
               cudaStream_t stream) {
  if (d_locs != nullptr)
    launch<VT, DT, C, true, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, stream);
  else if (d_depth != nullptr)
    launch<VT, DT, C, false, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, stream);
  else
    launch<VT, DT, C, false, false>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, stream);
}

// ---------------------------------------------------------------------------
// Stage 1 (K6, K6'): the sum where the output lives.

constexpr int kListThreads = 1024;  // the list build: a block a view
constexpr int kPixelThreads = 128;  // the pixel pass
constexpr int kLongThreads = 1024;  // the long pass: a block a long list
constexpr int kLongBlocks = 132;    // ... one an SM
constexpr int kTile = 4;            // pixels a warp of the pixel pass
constexpr int kShortList = 32;      // the longest list a warp sums alone
constexpr int kLongUnroll = 2;      // g rows a group of the long pass loads together
constexpr int kMaxViews = 1024;     // views a call (the pixel pass counts them in shared memory)
constexpr int kMaxMapPixels = 56 * 1024;  // the build counts a view's pixels in shared memory

// A stage-1 sample's quantities, with the coordinates rounded as the
// plain version rounds them (sgc::pixel_coord): the list build, the long
// pass and the sample gradients find the same corners.
struct S1Sample {
  int x0, y0, d0c, d1c;
  float lx, ly, wd0, wd1, a;
  bool dv0, dv1;
};

__device__ __forceinline__ S1Sample s1_sample(const float* __restrict__ lp, float a,
                                              int h, int w, int dsize) {
  S1Sample s;
  const float u = sgc::pixel_coord(lp[0], w);
  const float v = sgc::pixel_coord(lp[1], h);
  const float dd = sgc::pixel_coord(lp[2], dsize);
  const float x0f = floorf(u), y0f = floorf(v), d0f = floorf(dd);
  s.lx = u - x0f;
  s.ly = v - y0f;
  const float ld = dd - d0f;
  s.x0 = (int)x0f;
  s.y0 = (int)y0f;
  const int d0 = (int)d0f;
  s.dv0 = d0 >= 0 && d0 <= dsize - 1;
  s.dv1 = d0 + 1 >= 0 && d0 + 1 <= dsize - 1;
  s.wd0 = s.dv0 ? 1.f - ld : 0.f;
  s.wd1 = s.dv1 ? ld : 0.f;
  s.d0c = min(max(d0, 0), dsize - 1);
  s.d1c = min(max(d0 + 1, 0), dsize - 1);
  s.a = a;
  return s;
}

// The pixel y * w + x of a sample's corner (dy = corner >> 1, dx = corner
// & 1) at floor point (x0, y0), or -1 off the image.
__device__ __forceinline__ int corner_pixel(int x0, int y0, int corner, int h, int w) {
  const int xi = x0 + (corner & 1), yi = y0 + (corner >> 1);
  return (xi >= 0 && xi <= w - 1 && yi >= 0 && yi <= h - 1) ? yi * w + xi : -1;
}

__device__ __forceinline__ int2 floor_point(const float* __restrict__ lp, int h, int w) {
  return make_int2((int)floorf(sgc::pixel_coord(lp[0], w)),
                   (int)floorf(sgc::pixel_coord(lp[1], h)));
}

// Exclusive prefix sum of x over the block (THREADS threads, a multiple of
// 32 up to 1024); *total gets the block's sum.  Every thread calls it;
// s_warp holds 33 ints; the caller syncs before s_warp is used again.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int x, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < THREADS / 32 ? s_warp[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, vi, o);
      if (lane >= o) vi += y;
    }
    if (lane < THREADS / 32) s_warp[lane] = vi - v;
    if (lane == 31) s_warp[32] = vi;
  }
  __syncthreads();
  *total = s_warp[32];
  return s_warp[warp] + inc - x;
}

// An entry of a pixel's list (32 bytes: one sector): m = 4 q + corner,
// the weight b a s of g[q] in the pixel's d_value row and, for the depth
// gradient, b a wd0 and b a wd1 and the two bins (d0c | d1c << 16).
struct alignas(16) S1Record {
  int m;
  float wgt, c0, c1;
  int bins, pad[3];
};

// The scratch of one stage-1 call (ops/dfa3d.py::s1_scratch_ints sizes
// it).  Per view: its entries' records (4 k: a counted query adds one
// entry per in-image corner); the list offsets of its pixels (hw + 1); for
// a long list, the order of its entries by query (4 k); its pixels with a
// long list (hw) and how many (1).  Per entry the dot product t of the
// sample gradients (4 k floats).
struct S1Scratch {
  S1Record* rec;
  int* off;
  int* order;
  int* longs;
  int* nlong;
  float* tq;
  S1Scratch(int* base, int n, long long hw, int k)
      : rec(reinterpret_cast<S1Record*>(base)),
        off(reinterpret_cast<int*>(rec + 4LL * n * k)),
        order(off + n * (hw + 1)),
        longs(order + 4LL * n * k),
        nlong(longs + n * hw),
        tq(reinterpret_cast<float*>(nlong + n)) {}
};

// The records of query q's in-image corners (pix[corner] -1 off the
// image), at row0 + q of locs / attn; dmap is the view's depth map.
template <typename DT>
__device__ __forceinline__ void s1_query_records(
    const DT* __restrict__ dmap, const float* __restrict__ locs,
    const float* __restrict__ attn, long long row0, int q, int h, int w, int dsize,
    int (&pix)[4], S1Record (&rec)[4]) {
  const S1Sample smp = s1_sample(locs + (row0 + q) * 3, attn[row0 + q], h, w, dsize);
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    pix[corner] = corner_pixel(smp.x0, smp.y0, corner, h, w);
    if (pix[corner] < 0) continue;
    const float ba = (((corner >> 1) ? smp.ly : 1.f - smp.ly) *
                      ((corner & 1) ? smp.lx : 1.f - smp.lx)) * smp.a;
    const DT* drow = dmap + (long long)pix[corner] * dsize;
    rec[corner].m = 4 * q + corner;
    rec[corner].wgt =
        ba * (sgc::to_f32(drow[smp.d0c]) * smp.wd0 + sgc::to_f32(drow[smp.d1c]) * smp.wd1);
    rec[corner].c0 = ba * smp.wd0;
    rec[corner].c1 = ba * smp.wd1;
    rec[corner].bins = smp.d0c | smp.d1c << 16;
  }
}

// The list build, a block a view: count the entries of each pixel in
// shared memory, scan the counts into the view's list offsets, list the
// pixels with a long list (more than kShortList entries), then fill the
// lists with the entries' records (the depth bins gathered at each
// corner's pixel).  A thread's first query keeps its records in registers
// from the count to the fill, so its loads wait on nothing but the count.
template <typename DT>
__global__ void __launch_bounds__(kListThreads) s1_lists_kernel(
    const DT* __restrict__ depth, const float* __restrict__ locs,
    const float* __restrict__ attn, const int* __restrict__ counts, S1Scratch sc, int h,
    int w, int dsize, int k) {
  extern __shared__ int s_cnt[];  // [h * w] entries a pixel, then the fill's cursor
  __shared__ int s_warp[33];
  __shared__ int s_nlong;
  sgc::launch_dependents();  // the long pass's blocks take the other SMs and wait
  const int cam = blockIdx.x, hw = h * w;
  const int count = counts == nullptr ? k : min(max(counts[cam], 0), k);
  const long long row0 = (long long)cam * k;
  const DT* dmap = depth + (long long)cam * hw * dsize;
  const bool first = (int)threadIdx.x < count;
  int pix[4] = {-1, -1, -1, -1};
  S1Record rec[4];
  if (first)
    s1_query_records(dmap, locs, attn, row0, threadIdx.x, h, w, dsize, pix, rec);
  for (int i = threadIdx.x; i < hw; i += kListThreads) s_cnt[i] = 0;
  if (threadIdx.x == 0) s_nlong = 0;
  __syncthreads();
#pragma unroll
  for (int corner = 0; corner < 4; ++corner)
    if (pix[corner] >= 0) atomicAdd(&s_cnt[pix[corner]], 1);
  for (int q = threadIdx.x + kListThreads; q < count; q += kListThreads) {
    const int2 p0 = floor_point(locs + (row0 + q) * 3, h, w);
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int p = corner_pixel(p0.x, p0.y, corner, h, w);
      if (p >= 0) atomicAdd(&s_cnt[p], 1);
    }
  }
  __syncthreads();
  // each thread scans a run of consecutive pixels
  const int per = (hw + kListThreads - 1) / kListThreads;
  const int i0 = min(hw, (int)threadIdx.x * per), i1 = min(hw, i0 + per);
  int run = 0;
  for (int i = i0; i < i1; ++i) run += s_cnt[i];
  int total;
  int at = block_exclusive_scan<kListThreads>(run, s_warp, &total);
  int* voff = sc.off + (long long)cam * (hw + 1);
  for (int i = i0; i < i1; ++i) {
    const int c = s_cnt[i];
    voff[i] = at;
    if (c > kShortList) sc.longs[(long long)cam * hw + atomicAdd(&s_nlong, 1)] = i;
    at += c;
    s_cnt[i] = at;  // the fill takes the list's slots from its end down
  }
  if (threadIdx.x == 0) voff[hw] = total;
  __syncthreads();
  for (int q = threadIdx.x; q < count; q += kListThreads) {
    if (q != (int)threadIdx.x)
      s1_query_records(dmap, locs, attn, row0, q, h, w, dsize, pix, rec);
#pragma unroll
    for (int corner = 0; corner < 4; ++corner)
      if (pix[corner] >= 0) sc.rec[row0 * 4 + atomicAdd(&s_cnt[pix[corner]], -1) - 1] = rec[corner];
  }
  if (threadIdx.x == 0) sc.nlong[cam] = s_nlong;
}

// U entries of a lane batch (lane j holding entry j's record: m, its
// weight, and with DOT its depth factors and bins) for the group of LANES
// lanes that calls it: entry u sits in lane src[u] and counts where
// live[u] (uniform over the group).  Each entry's query and weight by
// shuffle, g[q] loaded in 16-byte pieces (the U loads in flight together),
// acc += wgt g[q]; with DOT, t = <g[q], val> summed over the group, t b a
// wd into the pixel's two bins of dd (the group's sums) and, for the
// sample gradients, t into tq[m].  Every lane of the warp calls it.
template <typename VT, int VEC, int LANES, int U, bool SAMPLE_GRADS, bool DOT>
__device__ __forceinline__ void s1_add_entries(
    const VT* __restrict__ g, long long row0, const int (&src)[U], const bool (&live)[U],
    int m, float wgt, float c0, float c1, int bins, const float (&val)[VEC],
    float (&acc)[VEC], float* dd, float* tq) {
  constexpr int C = VEC * LANES;
  const int sub = (threadIdx.x & 31) % LANES;
  int mq[U];
  float wq[U];
  sgc::Vec<VT, VEC> raw[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    mq[u] = __shfl_sync(0xffffffffu, m, src[u]);
    wq[u] = __shfl_sync(0xffffffffu, wgt, src[u]);
    if (live[u])
      raw[u] = *reinterpret_cast<const sgc::Vec<VT, VEC>*>(g + (row0 + (mq[u] >> 2)) * C +
                                                           sub * VEC);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float t = 0.f;
    if (live[u]) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float gi = sgc::to_f32(raw[u].v[i]);
        acc[i] += wq[u] * gi;
        if (DOT) t += gi * val[i];
      }
    }
    if (DOT) {
      t = sgc::group_sum<LANES>(t);
      const float f0 = __shfl_sync(0xffffffffu, c0, src[u]);
      const float f1 = __shfl_sync(0xffffffffu, c1, src[u]);
      const int bq = __shfl_sync(0xffffffffu, bins, src[u]);
      if (live[u] && sub == 0) {
        if (dd != nullptr) {
          if (f0 != 0.f) dd[bq & 0xffff] += t * f0;
          if (f1 != 0.f) dd[bq >> 16] += t * f1;
        }
        if (SAMPLE_GRADS) tq[mq[u]] = t;
      }
    }
  }
}

// A warp's run of one pixel's list: its entries at positions rel[0, cnt)
// of the pixel's records (from index `first` of the scratch arrays; rel
// null: 0..cnt-1 in the order the fill left them, at most 32, which the
// warp sorts by query), 32 at a time, a lane an entry's record; the warp's
// groups of LANES lanes take the entries in turn, U loads in flight,
// each adding into its own partial row acc and depth sums dd.
template <typename VT, int C, int U, bool SAMPLE_GRADS, bool DOT>
__device__ __forceinline__ void s1_warp_run(
    const VT* __restrict__ g, const S1Scratch& sc, long long first, const int* rel,
    int cnt, long long row0, const float (&val)[8], float (&acc)[8], float* dd,
    int* s_slot) {
  constexpr int VEC = 8, LANES = C / VEC, G = 32 / LANES;
  const int lane = threadIdx.x & 31;
  float* vtq = sc.tq + row0 * 4;
  for (int b = 0; b < cnt; b += 32) {  // uniform over the warp
    const int nbt = min(32, cnt - b);
    S1Record r{-1, 0.f, 0.f, 0.f, 0, {}};
    if (lane < nbt) r = sc.rec[first + (rel == nullptr ? b + lane : rel[b + lane])];
    const int m = r.m;
    if (rel == nullptr) {  // the order of the queries: a lane's rank among the list
      int rank = 0;
      for (int j = 0; j < nbt; ++j) rank += __shfl_sync(0xffffffffu, m, j) < m;
      if (lane < nbt) s_slot[rank] = lane;
      __syncwarp();
    }
    for (int x0 = 0; x0 < nbt; x0 += U * G) {  // uniform over the warp
      int src[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = x0 + lane / LANES + u * G;
        live[u] = x < nbt;
        src[u] = !live[u] ? lane : rel == nullptr ? s_slot[x] : x;
      }
      s1_add_entries<VT, VEC, LANES, U, SAMPLE_GRADS, DOT>(
          g, row0, src, live, m, r.wgt, r.c0, r.c1, r.bins, val, acc, dd, vtq);
    }
    __syncwarp();
  }
}

// The j-th pixel with a long list over every view, as (view, pixel); view
// n where j is past the last.  s_nlong holds the views' counts.
__device__ __forceinline__ int2 s1_long_pixel(const S1Scratch& sc, const int* s_nlong, int n,
                                              long long hw, int j) {
  int cam = 0;
  for (; cam < n && j >= s_nlong[cam]; ++cam) j -= s_nlong[cam];
  if (cam == n) return make_int2(n, 0);
  return make_int2(cam, sc.longs[cam * hw + j]);
}

// The pixel pass: a warp a tile of kTile consecutive pixels of a view: one
// load of their list bounds, zeros for the empty pixels' d_value and
// d_depth rows, then each short list in one run (s1_warp_run), after the
// pixel's value row (DOT).  A long list's pixel is the long pass's.  Each
// pixel's d_value row is written once, at the value's type, and its
// d_depth row once, at the depth's.  A run's groups (c < 256: several a
// warp) sum their rows and depth sums in group order, so every sum is in
// the same order from run to run.
template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
__global__ void __launch_bounds__(kPixelThreads) s1_pixels_kernel(
    const VT* __restrict__ value, const VT* __restrict__ g, S1Scratch sc,
    VT* __restrict__ d_value, DT* __restrict__ d_depth, int n, int h, int w, int dsize,
    int k) {
  constexpr int VEC = 8, LANES = C / VEC, G = 32 / LANES, WARPS = kPixelThreads / 32;
  extern __shared__ float s_dd[];  // [WARPS][G][dsize]
  __shared__ int s_slot[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LANES, grp = lane / LANES;
  const long long hw = (long long)h * w;
  float* dd = d_depth != nullptr ? s_dd + (warp * G + grp) * dsize : nullptr;  // DOT
  sgc::wait_for_prerequisite();  // the list build (through the long pass)
  float val[VEC], acc[VEC];
  const int tiles = (int)((hw + kTile - 1) / kTile);
  const long long tile = (long long)blockIdx.x * WARPS + warp;
  if (tile >= (long long)n * tiles) return;
  const int cam = (int)(tile / tiles), p0 = (int)(tile % tiles) * kTile;
  const int np = min(kTile, (int)hw - p0);
  const int* voff = sc.off + cam * (hw + 1) + p0;
  const int o = lane < np ? voff[lane] : 0, e = lane < np ? voff[lane + 1] : 0;
  const unsigned empty = __ballot_sync(0xffffffffu, lane < np && e == o);
  unsigned todo = __ballot_sync(0xffffffffu, lane < np && e > o && e - o <= kShortList);
  const long long pix0 = cam * hw + p0;
  const float zero[VEC] = {};
  for (int j = grp; j < kTile; j += G) {
    if (!(empty >> j & 1)) continue;
    sgc::store_from_f32<VT, VEC>(d_value + (pix0 + j) * C + sub * VEC, zero);
    if (d_depth != nullptr)
      for (int i = sub; i < dsize; i += LANES)
        d_depth[(pix0 + j) * dsize + i] = sgc::from_f32<DT>(0.f);
  }
  const long long row0 = (long long)cam * k;
  while (todo) {  // uniform over the warp
    const int p = __ffs(todo) - 1;
    todo &= todo - 1;
    const int o0 = __shfl_sync(0xffffffffu, o, p);
    const int cnt = __shfl_sync(0xffffffffu, e, p) - o0;
    const long long gpix = pix0 + p;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = val[i] = 0.f;
    if (DOT) sgc::load_f32<VT, VEC>(value + gpix * C + sub * VEC, val);
    if (dd != nullptr)
      for (int i = sub; i < dsize; i += LANES) dd[i] = 0.f;
    __syncwarp();
    s1_warp_run<VT, C, 1, SAMPLE_GRADS, DOT>(g, sc, row0 * 4 + o0, nullptr, cnt, row0, val,
                                             acc, dd, s_slot[warp]);
    // the groups' rows and depth sums, in group order
#pragma unroll
    for (int x = LANES; x < 32; x <<= 1)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], x);
    if (grp == 0) {
      sgc::store_from_f32<VT, VEC>(d_value + gpix * C + sub * VEC, acc);
      if (d_depth != nullptr)
        for (int i = sub; i < dsize; i += LANES) {
          float x = 0.f;
          for (int gi = 0; gi < G; ++gi) x += s_dd[(warp * G + gi) * dsize + i];
          d_depth[gpix * dsize + i] = sgc::from_f32<DT>(x);
        }
    }
    __syncwarp();
  }
}

// The long pass: a block a pixel with a long list (a grid-stride loop over
// every view's).  The block orders the list by query (a bitmap of its
// queries, which add at most one entry each), splits it into a contiguous
// run a warp (s1_warp_run, kLongUnroll loads in flight), and sums the
// warps' rows and depth sums in warp and group order.
template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
__global__ void __launch_bounds__(kLongThreads, 1) s1_long_kernel(
    const VT* __restrict__ value, const VT* __restrict__ g, S1Scratch sc,
    VT* __restrict__ d_value, DT* __restrict__ d_depth, int n, int h, int w, int dsize,
    int k) {
  constexpr int VEC = 8, LANES = C / VEC, G = 32 / LANES, WARPS = kLongThreads / 32;
  extern __shared__ __align__(16) float s_long[];
  float* s_row = s_long;                               // [WARPS][C]: warps' rows
  float* s_dd = s_row + WARPS * C;                     // [WARPS][G][dsize]
  int* s_words = reinterpret_cast<int*>(s_dd + WARPS * G * dsize);  // the bitmap
  __shared__ int s_slot[WARPS][32];
  __shared__ int s_nlong[kMaxViews];
  __shared__ int s_warp[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LANES, grp = lane / LANES;
  const long long hw = (long long)h * w;
  float* dd = d_depth != nullptr ? s_dd + (warp * G + grp) * dsize : nullptr;  // DOT
  sgc::launch_dependents();      // the pixel pass's blocks take the other SMs and wait
  sgc::wait_for_prerequisite();  // the list build
  float val[VEC], acc[VEC];
  // a block a long list
  for (int i = threadIdx.x; i < n; i += kLongThreads) s_nlong[i] = sc.nlong[i];
  __syncthreads();
  const int words = (k + 31) / 32;
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_words);  // [words]
  int* s_pre = s_words + words;                             // [words]: set bits before
  for (int j = blockIdx.x;; j += gridDim.x) {
    const int2 at = s1_long_pixel(sc, s_nlong, n, hw, j);
    if (at.x == n) return;  // uniform over the block
    const long long gpix = at.x * hw + at.y;
    const int* voff = sc.off + at.x * (hw + 1) + at.y;
    const int o0 = voff[0], cnt = voff[1] - o0;
    const long long row0 = (long long)at.x * k;
    const S1Record* prec = sc.rec + row0 * 4 + o0;
    int* porder = sc.order + row0 * 4 + o0;
    // 1. the list's queries as a bitmap, and the set bits before each word
    for (int i = threadIdx.x; i < words; i += kLongThreads) s_bits[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kLongThreads) {
      const int q = prec[i].m >> 2;
      atomicOr(&s_bits[q >> 5], 1u << (q & 31));
    }
    __syncthreads();
    const int per = (words + kLongThreads - 1) / kLongThreads;
    const int w0 = min(words, (int)threadIdx.x * per), w1 = min(words, w0 + per);
    int run = 0;
    for (int i = w0; i < w1; ++i) run += __popc(s_bits[i]);
    int total;
    int pre = block_exclusive_scan<kLongThreads>(run, s_warp, &total);
    for (int i = w0; i < w1; ++i) {
      s_pre[i] = pre;
      pre += __popc(s_bits[i]);
    }
    __syncthreads();
    // 2. the order of the list by query: its rank r's entry is porder[r]
    for (int i = threadIdx.x; i < cnt; i += kLongThreads) {
      const int q = prec[i].m >> 2;
      porder[s_pre[q >> 5] + __popc(s_bits[q >> 5] & ((1u << (q & 31)) - 1u))] = i;
    }
    __syncthreads();
    // 3. warp `warp` takes ranks [r0, r1)
    const int r0 = (int)((long long)warp * cnt / WARPS);
    const int r1 = (int)((long long)(warp + 1) * cnt / WARPS);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = val[i] = 0.f;
    if (DOT) sgc::load_f32<VT, VEC>(value + gpix * C + sub * VEC, val);
    if (dd != nullptr)
      for (int i = sub; i < dsize; i += LANES) dd[i] = 0.f;
    __syncwarp();
    s1_warp_run<VT, C, kLongUnroll, SAMPLE_GRADS, DOT>(g, sc, row0 * 4 + o0, porder + r0,
                                                       r1 - r0, row0,
                                                       val, acc, dd, s_slot[warp]);
    // 4. the warps' rows and depth sums, in warp and group order
#pragma unroll
    for (int x = LANES; x < 32; x <<= 1)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], x);
    if (grp == 0)
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_row[warp * C + sub * VEC + i] = acc[i];
    __syncthreads();
    for (int ch = threadIdx.x; ch < C; ch += kLongThreads) {
      float x = 0.f;
      for (int wi = 0; wi < WARPS; ++wi) x += s_row[wi * C + ch];
      d_value[gpix * C + ch] = sgc::from_f32<VT>(x);
    }
    if (d_depth != nullptr)
      for (int i = threadIdx.x; i < dsize; i += kLongThreads) {
        float x = 0.f;
        for (int gi = 0; gi < WARPS * G; ++gi) x += s_dd[gi * dsize + i];
        d_depth[gpix * dsize + i] = sgc::from_f32<DT>(x);
      }
    __syncthreads();  // before the next pixel takes the shared memory
  }
}

// The sample gradients, a thread a query: from the t of each in-image
// corner (the pixel passes' tq), as K5's warp computes them at P = 1.
template <typename DT>
__global__ void __launch_bounds__(256) s1_sample_grads_kernel(
    const DT* __restrict__ depth, const float* __restrict__ locs,
    const float* __restrict__ attn, const int* __restrict__ counts, S1Scratch sc,
    float* __restrict__ d_locs, float* __restrict__ d_attn, int n, int h, int w,
    int dsize, int k) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)n * k) return;
  const int cam = (int)(row / k), q = (int)(row % k);
  float g_lx = 0.f, g_ly = 0.f, g_ld = 0.f, g_a = 0.f;
  if (counts == nullptr || q < counts[cam]) {
    const S1Sample s = s1_sample(locs + row * 3, attn[row], h, w, dsize);
    const DT* dmap = depth + (long long)cam * h * w * dsize;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int pix = corner_pixel(s.x0, s.y0, corner, h, w);
      if (pix < 0) continue;
      const int dy = corner >> 1, dx = corner & 1;
      const float by = dy ? s.ly : 1.f - s.ly, bx = dx ? s.lx : 1.f - s.lx;
      const float b = by * bx;
      const DT* drow = dmap + (long long)pix * dsize;
      const float dp0 = sgc::to_f32(drow[s.d0c]), dp1 = sgc::to_f32(drow[s.d1c]);
      const float t = sc.tq[row * 4 + corner];
      const float ds = dp0 * s.wd0 + dp1 * s.wd1;
      const float t_s = t * b * s.a;  // gradient of the depth score
      const float t_b = t * s.a * ds;  // gradient of the bilinear weight b
      g_a += t * b * ds;
      g_lx += t_b * (dx ? by : -by);
      g_ly += t_b * (dy ? bx : -bx);
      g_ld += t_s * ((s.dv1 ? dp1 : 0.f) - (s.dv0 ? dp0 : 0.f));
    }
  }
  float* dl = d_locs + row * 3;
  dl[0] = g_lx * w;
  dl[1] = g_ly * h;
  dl[2] = g_ld * dsize;
  d_attn[row] = g_a;
}

// Stage 1: the list build, the pixel pass and, for the sample gradients,
// their kernel.
template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
int launch_s1_passes(const void* value, const void* depth, const float* locs,
                     const float* attn, const int* counts, const void* g, S1Scratch sc,
                     void* d_value, void* d_depth, float* d_locs, float* d_attn, int n,
                     int h, int w, int dsize, int k, cudaStream_t stream) {
  const DT* dep = static_cast<const DT*>(depth);
  const size_t list_smem = (size_t)h * w * sizeof(int);
  auto lists = s1_lists_kernel<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      lists, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)list_smem);
  if (err != cudaSuccess) return (int)err;
  lists<<<n, kListThreads, list_smem, stream>>>(dep, locs, attn, counts, sc, h, w, dsize, k);
  constexpr int G = 32 / (C / 8), LW = kLongThreads / 32, PW = kPixelThreads / 32;
  const size_t long_smem = (LW * C + LW * G * dsize + 2 * ((k + 31) / 32)) * sizeof(float);
  auto longs = s1_long_kernel<VT, DT, C, SAMPLE_GRADS, DOT>;
  err = cudaFuncSetAttribute(longs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)long_smem);
  if (err != cudaSuccess) return (int)err;
  const VT* v = static_cast<const VT*>(value);
  const VT* gg = static_cast<const VT*>(g);
  VT* dv = static_cast<VT*>(d_value);
  DT* dd = static_cast<DT*>(d_depth);
  err = sgc::launch_kernel(longs, dim3(kLongBlocks), dim3(kLongThreads), long_smem, stream,
                           true, v, gg, sc, dv, dd, n, h, w, dsize, k);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)n * ((h * w + kTile - 1) / kTile);
  err = sgc::launch_kernel(s1_pixels_kernel<VT, DT, C, SAMPLE_GRADS, DOT>,
                           dim3((unsigned)((tiles + PW - 1) / PW)), dim3(kPixelThreads),
                           PW * G * dsize * sizeof(float), stream, true, v, gg, sc, dv, dd,
                           n, h, w, dsize, k);
  if (err != cudaSuccess) return (int)err;
  if (SAMPLE_GRADS && (long long)n * k > 0) {
    const long long rows = (long long)n * k;
    s1_sample_grads_kernel<DT><<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
        dep, locs, attn, counts, sc, d_locs, d_attn, n, h, w, dsize, k);
  }
  return (int)cudaSuccess;
}

template <typename VT, typename DT, int C>
int launch_s1(const void* value, const void* depth, const float* locs,
              const float* attn, const int* counts, const void* g, void* d_value,
              void* d_depth, float* d_locs, float* d_attn, int* scratch, int n, int h,
              int w, int dsize, int k, cudaStream_t stream) {
  if (h * w > kMaxMapPixels || n > kMaxViews) return (int)cudaErrorInvalidValue;
  const S1Scratch sc(scratch, n, (long long)h * w, k);
  int e;
  if (d_locs != nullptr)
    e = launch_s1_passes<VT, DT, C, true, true>(value, depth, locs, attn, counts, g, sc, d_value, d_depth, d_locs, d_attn, n, h, w, dsize, k, stream);
  else if (d_depth != nullptr)
    e = launch_s1_passes<VT, DT, C, false, true>(value, depth, locs, attn, counts, g, sc, d_value, d_depth, d_locs, d_attn, n, h, w, dsize, k, stream);
  else
    e = launch_s1_passes<VT, DT, C, false, false>(value, depth, locs, attn, counts, g, sc, d_value, d_depth, d_locs, d_attn, n, h, w, dsize, k, stream);
  if (e != (int)cudaSuccess) return e;
  return (int)cudaGetLastError();
}

}  // namespace

// The multi-head backward (K5, K5'; stage 1 is sgc_dfa3d_bwd_s1's): value
// (N, H, W, heads*c) of type vdtype, c = 32, depth (N, H, W, dsize) of type
// ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P) f32, counts
// (N,) int32 or null, g (N, K, heads*c) of type vdtype -> d_value (f32,
// zero-initialised by the caller), d_depth (likewise, or null: not
// computed) and, where both pointers are non-null, d_locs and d_attn (f32,
// every element written).
extern "C" int sgc_dfa3d_bwd(int vdtype, int ddtype, const void* value,
                             const void* depth, const float* locs,
                             const float* attn, const int* counts,
                             const void* g, float* d_value, float* d_depth,
                             float* d_locs, float* d_attn, int n, int h, int w,
                             int heads, int c, int dsize, int k, int p,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if ((d_locs == nullptr) != (d_attn == nullptr) || c != 32) return (int)cudaErrorInvalidValue;
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    launch_sg<decltype(v), decltype(d), 32>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, s);
    return (int)cudaGetLastError();
  });
}

// Stage 1 (heads = P = 1, K6 and K6'): value (N, H, W, c) of type vdtype,
// depth (N, H, W, dsize) of type ddtype, locs (N, K, 1, 1, 3) and attn
// (N, K, 1, 1) f32, counts (N,) int32 or null, g (N, K, c) of type vdtype,
// scratch (ops/dfa3d.py::s1_scratch_ints int32, uninitialised) -> d_value
// (vdtype) and d_depth (ddtype, or null: not computed), every element
// written, and, where both pointers are non-null, d_locs and d_attn (f32).
// c = 32 or 256; at most kMaxViews views and kMaxMapPixels pixels a map,
// and a long pass whose shared memory fits a block (the wrapper,
// ops/dfa3d.py::check_bwd_sizes, refuses other sizes before the launch).
extern "C" int sgc_dfa3d_bwd_s1(int vdtype, int ddtype, const void* value,
                                const void* depth, const float* locs,
                                const float* attn, const int* counts,
                                const void* g, void* d_value, void* d_depth,
                                float* d_locs, float* d_attn, int* scratch, int n,
                                int h, int w, int c, int dsize, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)h * w == 0) return (int)cudaSuccess;
  if ((d_locs == nullptr) != (d_attn == nullptr)) return (int)cudaErrorInvalidValue;
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    if (c == 32)
      return launch_s1<VT, DT, 32>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, scratch, n, h, w, dsize, k, s);
    if (c == 256)
      return launch_s1<VT, DT, 256>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, scratch, n, h, w, dsize, k, s);
    return (int)cudaErrorInvalidValue;
  });
}
