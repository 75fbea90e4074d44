// Windowed DFA3D sampling backward, multi-head, c = 16 or 32 per head
// (counters `dfa3d_win_bwd_mh` at 32, `dfa3d_win_bwd_mh_c16` at 16, the -L
// configs' width).
//
// Replaces the windowed TPU backwards experiments/dfa3d_pallas4.py::
// _bwd_kernel_wh (per head: dimg += S^T U per chunk, dw4, ddvec) and
// experiments/dfa3d_pallas5.py::_bwd_kernel_ws (the same over raw rows),
// together with the XLA chain that turned their per-corner outputs into
// location and attention gradients.  The function is dfa3d_bwd.cu's (the
// formulas are spelled out there); this kernel computes it for queries
// ordered by their projected pixel.  The stage-1 backward of the sorted
// path stays K6 (dfa3d_bwd.cu), as on the TPU, whose windowed stage 1 has
// no backward.
//
// Design: the blocks and windows of dfa3d_win_fwd.cu's multi-head kernel,
// one block of 256 threads per (chunk of qc queries, view) over all heads
// (qc = 8 at c = 32, 32 at c = 16: ops/dfa3d_windowed.py::QC_BWD), the
// window the union of its heads' bands (sgc::union_window).
// Where the window fits the wwin pixels the launch reserves, the block
// zeroes an f32 d_depth sum of the window in shared memory (48 B a pixel at
// 12 bins).  Each warp then takes items of the chunk on K5's rows
// (sgc::WarpRows::span: a head group of as many whole consecutive queries
// as a warp holds, one at 8 heads of 32 channels and two at c = 16, the
// counted ones first, a view's last query alone where K is odd) and runs
// K5's warp (sgc::mh_bwd_warp, csrc/
// dfa3d_mh.cuh): a query's eight heads in 8-channel lanes, the incoming
// gradient in registers, 16-byte value loads, the dot product in 2
// shuffle steps, d_value by 16-byte vector reductions into global memory
// in K5's slot layout, and the location and attention gradients written
// once per point.  Only the depth gradient goes through the window: each
// in-window corner's pair of d_depth updates is a shared-memory atomic
// instead of an L2 request.  After a sync the block adds its sums to
// global memory by 16-byte vector reductions, skipping all-zero quads (a
// pixel's 12 bins are three).  Corners outside the window (none, when plan
// and kernel agree), and every corner of a chunk whose union is wider than
// wwin, take K5's global branch as they are: such a chunk costs what K5
// costs.  K5's flags stay: no depth atomics without d_depth (and then no
// window), no value read or dot product without sample or depth gradients
// (DOT); counted-out queries get zero location and attention gradients
// and scatter nothing.
//
// What bounds it on this card, as K5: the d_value reductions and the value
// gathers.  The d_depth atomics the window takes out of L2 were ~2.5 % of
// its time (PERF.md).  Measured choices (H100 80GB HBM3): the depth
// bins are read from global memory as K5 reads them, not staged: staging
// them too (96 B a pixel) left two blocks an SM and ran 8-16 % slower;
// at c = 32 chunks of 8 queries, a query a warp (16 and 32 queries, two
// and four a warp, ran 6 and 18 % slower); at c = 16 chunks of 32, four
// items a warp (8, whose four items left half the warps idle, ran 1.49x
// slower, 16 1.09x, 64 1.04x); three blocks an SM (80 registers); blocks
// a view's chunks after one another (a chunk's views after one another ran
// 2 % slower sorted and 25 % slower on random locations: forty views'
// d_value sums at once exceed the L2).  d_value is not summed
// in shared memory: at 8 heads x 32 channels it takes 1 KB a pixel, so a
// block could hold ~227 pixels, and no union at level 2 is that narrow at
// any chunk of 8-256 queries (the heads' offsets alone span ~9 image
// rows).
#include <type_traits>

#include "dfa3d_mh.cuh"

namespace {

constexpr int kThreads = 256;

template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
__global__ void __launch_bounds__(kThreads, 3) dfa3d_win_bwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*C)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    const VT* __restrict__ g,        // (N, K, heads*C) incoming gradient
    float* __restrict__ d_value,     // (N, H, W, heads*C), zeroed by the caller
    float* __restrict__ d_depth,     // (N, H, W, D), zeroed by the caller, or null
    float* __restrict__ d_locs,      // (N, K, heads, P, 3) or null
    float* __restrict__ d_attn,      // (N, K, heads, P) or null
    int h, int w, int heads, int dsize, int k, int p, int qc, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 s_warp[kThreads / 32];
  float* s_dd = reinterpret_cast<float*>(smem);  // [wwin][D] d_depth sums
  constexpr int HPW = 32 / (C / 8);              // heads per warp
  const int hgroups = (heads + HPW - 1) / HPW;
  const int chunk = blockIdx.x, cam = blockIdx.y;
  const int count = counts == nullptr ? k : counts[cam];
  const int q0 = chunk * qc, q1 = min(k, q0 + qc);
  const int nqc = max(0, min(q1, count) - q0);  // counted queries of the chunk
  int2 box = make_int2(0, -1);
  if (nqc > 0 && wwin > 0 && d_depth != nullptr)  // uniform; wwin is 0 without d_depth
    box = sgc::union_window<kThreads>(locs + ((long long)cam * k + q0) * heads * p * 3,
                                      nqc * heads * p, h, w, s_warp);
  const int base = box.x, span = box.y >= 0 ? box.y - box.x + 1 : 0;
  const bool staged = span > 0 && span <= wwin;
  const long long hw = (long long)h * w, vstride = hw * heads * C;
  float* ddmap = d_depth == nullptr ? nullptr : d_depth + cam * hw * dsize;
  if (staged) {  // uniform over the block
    sgc::zero_shared(s_dd, span * dsize);
    __syncthreads();
  }

  const sgc::WindowDepth<DT, false> dep{{depth + cam * hw * dsize, ddmap, dsize}, nullptr,
                                        s_dd, base, staged ? span : 0};
  // a warp's item: qpw whole queries (two at C = 16, one at 8 heads of 32
  // or 256 channels) and a head group
  const int qpw = sgc::WarpRows<HPW>::queries(heads);
  const int items = (q1 - q0 + qpw - 1) / qpw * hgroups;
  for (int item = threadIdx.x >> 5; item < items; item += kThreads / 32) {
    const int q = q0 + item / hgroups * qpw, h0 = (item % hgroups) * HPW;
    sgc::mh_bwd_warp<VT, DT, C, SAMPLE_GRADS, DOT>(
        value + cam * vstride, locs, attn, g, d_value + cam * vstride, d_locs, d_attn,
        sgc::WarpRows<HPW>::span((long long)cam * k, q, q1, count, h0, heads),
        h, w, heads, dsize, p, dep);
  }
  if (staged) {  // uniform over the block
    __syncthreads();
    sgc::flush_add(ddmap + (long long)base * dsize, s_dd, span * dsize);
  }
}

// Dynamic shared memory of a block (ops/dfa3d_windowed.py::window_bytes
// computes the same): the d_depth sums, with depth_grad.
size_t bwd_smem(int dsize, int wwin, bool depth_grad) {
  return depth_grad ? (size_t)wwin * dsize * sizeof(float) : 0;
}

template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT>
int launch(const void* value, const void* depth, const float* locs,
           const float* attn, const int* counts, const void* g, float* d_value,
           float* d_depth, float* d_locs, float* d_attn, int n, int h, int w,
           int heads, int dsize, int k, int p, int qc, int wwin,
           cudaStream_t stream) {
  const size_t smem = bwd_smem(dsize, wwin, d_depth != nullptr);
  auto kernel = dfa3d_win_bwd_kernel<VT, DT, C, SAMPLE_GRADS, DOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (k + qc - 1) / qc;
  const dim3 grid(nchunk, n);  // a view's chunks after one another
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<const VT*>(g), d_value, d_depth, d_locs, d_attn,
      h, w, heads, dsize, k, p, qc, wwin);
  return (int)cudaGetLastError();
}

}  // namespace

// value (N, H, W, heads*c) of type vdtype, c = 16 or 32, depth (N, H, W,
// dsize) of type ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P)
// f32, counts (N,) int32 or null, g (N, K, heads*c) of type vdtype, chunks of qc
// queries, windows of at most wwin pixels -> d_value (f32, zeroed by the
// caller, 16-byte aligned), d_depth (likewise, or null: not computed) and,
// where both pointers are non-null, d_locs and d_attn (f32, every element
// written).
extern "C" int sgc_dfa3d_win_bwd(int vdtype, int ddtype, const void* value,
                                 const void* depth, const float* locs,
                                 const float* attn, const int* counts,
                                 const void* g, float* d_value,
                                 float* d_depth, float* d_locs, float* d_attn,
                                 int n, int h, int w, int heads, int c, int dsize,
                                 int k, int p, int qc, int wwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if ((d_locs == nullptr) != (d_attn == nullptr) || qc <= 0 || wwin < 0)
    return (int)cudaErrorInvalidValue;
  if (c != 16 && c != 32) return (int)cudaErrorInvalidValue;
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    auto by_flags = [&](auto width) {
      constexpr int C = decltype(width)::value;
      if (d_locs != nullptr)
        return launch<VT, DT, C, true, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
      if (d_depth != nullptr)
        return launch<VT, DT, C, false, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
      return launch<VT, DT, C, false, false>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
    };
    return c == 16 ? by_flags(std::integral_constant<int, 16>{})
                   : by_flags(std::integral_constant<int, 32>{});
  });
}

// The resources of the kernel that sgc_dfa3d_win_bwd launches for these
// types, c and flags (sample_grads implies the dot products; depth_grad),
// at dsize and wwin: out[5] as sgc::kernel_attributes writes it.
extern "C" int sgc_dfa3d_win_bwd_attributes(int vdtype, int ddtype, int c, int sample_grads,
                                            int depth_grad, int dsize, int wwin, int* out) {
  if (c != 16 && c != 32) return (int)cudaErrorInvalidValue;
  return sgc::dispatch_types(vdtype, ddtype, [&](auto v, auto d) {
    using VT = decltype(v);
    using DT = decltype(d);
    const size_t smem = bwd_smem(dsize, wwin, depth_grad);
    auto by_flags = [&](auto width) {
      constexpr int C = decltype(width)::value;
      if (sample_grads)
        return sgc::kernel_attributes(dfa3d_win_bwd_kernel<VT, DT, C, true, true>, kThreads, smem, out);
      if (depth_grad)
        return sgc::kernel_attributes(dfa3d_win_bwd_kernel<VT, DT, C, false, true>, kThreads, smem, out);
      return sgc::kernel_attributes(dfa3d_win_bwd_kernel<VT, DT, C, false, false>, kThreads, smem, out);
    };
    return c == 16 ? by_flags(std::integral_constant<int, 16>{})
                   : by_flags(std::integral_constant<int, 32>{});
  });
}
