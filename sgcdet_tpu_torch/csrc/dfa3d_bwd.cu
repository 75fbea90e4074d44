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
// Design: eight contiguous channels per lane (one 16-byte load of a bf16
// row piece, two of f32), so a head of c channels takes LANES = c / 8
// lanes and a warp takes 32 / LANES heads of one (view, query): at c = 32
// (stage 2) a warp is one query's eight heads, four lanes each; at c = 256
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
#include "common.cuh"

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
  constexpr int VEC = 8;           // channels per lane
  constexpr int LANES = C / VEC;   // lanes per head
  constexpr int HPW = 32 / LANES;  // heads per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;
  const int hgroups = (heads + HPW - 1) / HPW;
  const long long warp_id =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id >= (long long)n * k * hgroups) return;
  const int head0 = (int)(warp_id % hgroups) * HPW;
  const long long nq = warp_id / hgroups;  // cam * k + q
  const int q = (int)(nq % k);
  const int cam = (int)(nq / k);
  const int cfull = heads * C;

  if (counts != nullptr && q >= counts[cam]) {
    if (SAMPLE_GRADS) {
      const long long row = nq * heads + head0;  // first (query, head) of the warp
      const int nh = min(HPW, heads - head0);
      for (int i = lane; i < nh * p * 3; i += 32) d_locs[row * p * 3 + i] = 0.f;
      for (int i = lane; i < nh * p; i += 32) d_attn[row * p + i] = 0.f;
    }
    return;
  }

  // lanes of a head past the last (heads not a multiple of HPW) read the
  // last head's operands, take part in the shuffles and write nothing
  const bool active = head0 + lane / LANES < heads;
  const int head = min(head0 + lane / LANES, heads - 1);
  const bool first = active && sub == 0;
  float gv[VEC];
  sgc::load_f32<VT, VEC>(g + nq * cfull + head * C + sub * VEC, gv);
  const long long hw = (long long)h * w;
  const long long qh = nq * heads + head;  // (query, head) row of locs / attn
  const float* lp = locs + qh * p * 3;
  const float* ap = attn + qh * p;
  const VT* vbase = value + cam * hw * cfull + head * C + sub * VEC;
  // d_value is written in SLOTS instructions per corner; slot s covers the
  // warp's channels [128 s, 128 s + 128) in head order, four per lane, so
  // each instruction adds four whole 128-byte rows.  A lane therefore
  // writes for the head whose sample sits in lane wsrc[s], and holds that
  // head's incoming gradient at its four channels.
  constexpr int SLOTS = VEC / 4;
  int wsrc[SLOTS], woff[SLOTS];
  float gw[SLOTS][4];
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const int f = 128 * sl + 4 * lane, hiw = f / C;
    wsrc[sl] = hiw * LANES;
    woff[sl] = min(head0 + hiw, heads - 1) * C + f % C;
    sgc::load_f32<VT, 4>(g + nq * cfull + woff[sl], gw[sl]);
  }
  float* dvcam = d_value + cam * hw * cfull;
  const DT* dbase = depth + cam * hw * dsize;
  float* ddbase = d_depth == nullptr ? nullptr : d_depth + cam * hw * dsize;

  for (int pt = 0; pt < p; ++pt) {
    const float u = sgc::clip_coord(lp[3 * pt] * w - 0.5f, -4.f, w + 4.f);
    const float v = sgc::clip_coord(lp[3 * pt + 1] * h - 0.5f, -4.f, h + 4.f);
    const float dd = sgc::clip_coord(lp[3 * pt + 2] * dsize - 0.5f, -4.f,
                                     dsize + 4.f);
    const float a = ap[pt];
    const float x0f = floorf(u), y0f = floorf(v), d0f = floorf(dd);
    const float lx = u - x0f, ly = v - y0f, ld = dd - d0f;
    const int x0 = (int)x0f, y0 = (int)y0f, d0 = (int)d0f;
    const bool dv0 = d0 >= 0 && d0 <= dsize - 1;
    const bool dv1 = d0 + 1 >= 0 && d0 + 1 <= dsize - 1;
    const float wd0 = dv0 ? 1.f - ld : 0.f;
    const float wd1 = dv1 ? ld : 0.f;
    const int d0c = min(max(d0, 0), dsize - 1);
    const int d1c = min(max(d0 + 1, 0), dsize - 1);
    float g_lx = 0.f, g_ly = 0.f, g_ld = 0.f, g_a = 0.f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1, dx = corner & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      // uniform over a head's lanes; the shuffles below take every lane
      const bool in = active && yi >= 0 && yi <= h - 1 && xi >= 0 && xi <= w - 1;
      const long long pix = (long long)yi * w + xi;
      const float by = dy ? ly : 1.f - ly, bx = dx ? lx : 1.f - lx;
      const float b = by * bx;
      float dp0 = 0.f, dp1 = 0.f, t = 0.f, wgt = 0.f;
      if (in) {
        const DT* drow = dbase + pix * dsize;
        dp0 = sgc::to_f32(drow[d0c]);
        dp1 = sgc::to_f32(drow[d1c]);
        wgt = (b * a) * (dp0 * wd0 + dp1 * wd1);
        if (DOT) {
          float val[VEC];
          sgc::load_f32<VT, VEC>(vbase + pix * cfull, val);
#pragma unroll
          for (int i = 0; i < VEC; ++i) t += gv[i] * val[i];
        }
      }
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        const float ws = __shfl_sync(0xffffffffu, wgt, wsrc[sl]);
        const int ps = __shfl_sync(0xffffffffu, (int)pix, wsrc[sl]);
        if (!__shfl_sync(0xffffffffu, (int)in, wsrc[sl])) continue;
        float upd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) upd[i] = ws * gw[sl][i];
        sgc::atomic_add_f32<4>(dvcam + (long long)ps * cfull + woff[sl], upd);
      }
      if (!DOT) continue;
      t = sgc::group_sum<LANES>(t);
      if (!in) continue;
      const float s = dp0 * wd0 + dp1 * wd1;
      const float t_s = t * b * a;  // gradient of the depth score s
      if (active && sub < 2 && ddbase != nullptr) {  // one instruction, both bins
        const float wd = sub == 0 ? wd0 : wd1;
        if (wd != 0.f) atomicAdd(ddbase + pix * dsize + (sub == 0 ? d0c : d1c), t_s * wd);
      }
      if (SAMPLE_GRADS) {
        const float t_b = t * a * s;  // gradient of the bilinear weight b
        g_a += t * b * s;
        g_lx += t_b * (dx ? by : -by);
        g_ly += t_b * (dy ? bx : -bx);
        g_ld += t_s * ((dv1 ? dp1 : 0.f) - (dv0 ? dp0 : 0.f));
      }
    }
    if (SAMPLE_GRADS && first) {
      float* dl = d_locs + (qh * p + pt) * 3;
      dl[0] = g_lx * w;
      dl[1] = g_ly * h;
      dl[2] = g_ld * dsize;
      d_attn[qh * p + pt] = g_a;
    }
  }
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
