// Fused DFA3D sampling backward (kernels K6 `dfa3d_bwd_s1`, K5
// `dfa3d_bwd_mh` and their bf16-depth instances K6' `dfa3d_bwd_s1_bd`, K5'
// `dfa3d_bwd_mh_bd`): one template, one entry point; the wrapper counts the
// four apart.
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
//   d_value   += (b * a * s) * g                         (atomics)
//   d_dpt[d0c]+= t * b * a * wd0,  d_dpt[d1c] += t * b * a * wd1  (atomics)
//   d_attn     = sum_corners t * b * s
//   d_lx, d_ly = sum_corners t * a * s * db/dlx, db/dly
//   d_ld       = sum_corners t * b * a * (valid1 * dpt[d1c] - valid0 * dpt[d0c])
//   d_locs     = (d_lx * W, d_ly * H, d_ld * D)   (pixel = loc * size - 0.5)
//
// Queries at or past valid_counts[n] get zero d_locs / d_attn and scatter
// nothing (dfa3d_pallas.py:448-465).  Coordinates are clipped as in the
// forward, so NaN and far-off samples touch no corner.  All gradients are
// accumulated in f32 (d_dpt too at bf16 depth); the wrapper casts them
// once to the input dtypes.  With SAMPLE_GRADS
// off (stage 1 in the model: its locations are fixed voxel centres and its
// attention is 1) only d_value and d_dpt are produced; with a null d_depth
// (the 2D path: its uniform depth is a constant) the depth atomics are
// skipped.  Where both are off (the 2D stage 1) nothing needs t, so DOT is
// off too: the kernel reads no value row and does no warp reduction, and
// only scatters (b * a * s) * g.
//
// What bounds it on this card: the scatter.  Per (query, head, point,
// corner) the kernel gathers two depth bins and, with DOT, one c-channel
// value row, and adds c (+ 2) f32 values by atomics into the (N, H, W, C)
// (and (N, H, W, D)) buffers, which resolve in L2.  The counted rows past
// each camera's visible count (most of them at the finest level) cost one
// broadcast load of the count.
//
// Design (the warp's code is sgc::mh_bwd_warp in csrc/dfa3d_mh.cuh, which
// the windowed backward of the sorted path shares): eight contiguous
// channels per lane (one 16-byte load of a bf16 row piece, two of f32), so
// a head of c channels takes LANES = c / 8 lanes and a warp takes 32 /
// LANES heads of one (view, query): at c = 32 (stage 2) a warp is one
// query's eight heads, four lanes each; at c = 256
// (stage 1) a warp is one head, as the forward.  The incoming gradient row
// is loaded once into registers, in 16-byte pieces; each corner's dot
// product t is a reduction over the head's lanes (2 shuffle steps at
// c = 32, 5 at c = 256), after which every lane of the head carries the
// location and attention gradients; its first lane writes them once per
// point, and its first two lanes add the two d_dpt bins in one instruction
// (a single L2 request for the pair).  d_value takes two 16-byte vector
// reductions per lane per corner, laid out so that each instruction adds
// four whole 128-byte rows (a lane takes its target head's weight and
// pixel by shuffle): at c = 32 that is eight vector operations and two
// line requests per head and corner where the one-head-per-warp layout
// issued 32 scalar ones, and a warp walks its eight heads' samples side by
// side instead of one after another.  Counted-out queries are per warp:
// zero location and attention gradients for its heads, nothing scattered.
// launch_sg turns DOT off only with SAMPLE_GRADS off and a null d_depth.
// No pair/quad row images, no dquad/un-quad pass and no transposed windows
// (those worked around Mosaic).
#include "dfa3d_mh.cuh"

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

template <typename VT, typename DT>
int dispatch_c(int c, const void* value, const void* depth, const float* locs,
               const float* attn, const int* counts, const void* g,
               float* d_value, float* d_depth, float* d_locs, float* d_attn,
               int n, int h, int w, int heads, int dsize, int k, int p,
               cudaStream_t stream) {
  switch (c) {
    case 32: launch_sg<VT, DT, 32>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, stream); break;
    case 256: launch_sg<VT, DT, 256>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// value (N, H, W, heads*c) of type vdtype, depth (N, H, W, dsize) of type
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
  if ((d_locs == nullptr) != (d_attn == nullptr)) return (int)cudaErrorInvalidValue;
  if (ddtype == sgc::kBFloat16) {
    if (vdtype != sgc::kBFloat16) return (int)cudaErrorInvalidValue;
    return dispatch_c<__nv_bfloat16, __nv_bfloat16>(c, value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, s);
  }
  if (ddtype != sgc::kFloat32) return (int)cudaErrorInvalidValue;
  if (vdtype == sgc::kBFloat16)
    return dispatch_c<__nv_bfloat16, float>(c, value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, s);
  if (vdtype == sgc::kFloat32)
    return dispatch_c<float, float>(c, value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, s);
  return (int)cudaErrorInvalidValue;
}
