// Fused DFA3D sampling forward (kernels K2 `dfa3d_fwd_s1`, K3
// `dfa3d_fwd_mh` and their bf16-depth instances K2' `dfa3d_fwd_s1_bd`, K3'
// `dfa3d_fwd_mh_bd`): a one-point template (stage 1) and a multi-head one,
// behind one entry point; the wrapper counts the four apart.
//
// Replaces every Pallas DFA3D forward of sgcdet_tpu/ops, which compute one
// function at different type pairs, head counts and counted or not:
//   f32 depth (K2, K3): dfa3d_pallas.py::_fwd_kernel_s1 (stage 1: heads=1,
//     P=1, attention 1, all C channels, counted), dfa3d_pallas2.py::
//     _fwd_kernel_v2 (stage 2: heads x P points, c channels per head,
//     counted or not), dfa3d_pallas.py::_fwd_kernel (v1 multi-head; it casts
//     both inputs to f32) and dfa3d_pallas3.py::_fwd_kernel_q /
//     _fwd_kernel_q_s1 (v3 f32 quad rows);
//   bf16 value with bf16 depth (K2', K3'): dfa3d_pallas3.py::
//     _fwd_kernel_pq_s1 (stage 1, counted or not: pq_s1 / pq_s1c, which the
//     2D lifting path's stage 1 reaches with a uniform 2-bin depth) and
//     ::_fwd_kernel_pq (multi-head packed quads; its function is the 2D
//     path's stage 2 at bf16).
// For every (view n, query q, head h):
//
//   out[n, q, h*c:(h+1)*c] = sum_p attn[n,q,h,p] * sum_corners bilinear(corner)
//                            * depth_score(corner) * value[n, corner, h*c:(h+1)*c]
//
// where the depth score is the depth distribution at the corner pixel,
// linearly interpolated along the D bins with validity per side, and
// coordinates follow the spec of sgcdet_tpu/ops/msda.py (pixel = loc*size -
// 0.5, zero padding per corner).  Queries at or past valid_counts[n] are
// written as zeros, as the TPU kernels return.  Value and depth types are
// independent template parameters, instantiated for the pairs the TPU
// kernels take: bf16 value with f32 depth (the DFA3D main path), f32/f32
// (the f32 config) and bf16/bf16 (the 2D path at bf16; the packed-quad
// kernels), at the widths of the ScanNet config (c = 256 at stage 1, 32 a
// head at stage 2) and of the -L configs (128 and 16), and multi-head at
// 128 and 256 too.  The math is f32 and the output is written once, in the
// value type.
//
// What bounds it on this card: bytes.  Per (query, head, point) the kernel
// reads four data-dependent value rows (c channels each) and two depth
// bins per corner, and it streams the per-query locations and attention
// in and the output row out; at stage 2 those streamed bytes are most of
// the bound.  The value maps of one call (40 x 59 x 80 x 256 bf16 = 97 MB
// at the finest level) exceed the 50 MB L2, so the rows come from L2 where
// projections of nearby queries overlap and from HBM otherwise.
//
// Design of the multi-head case (K3, K3'; K5's lane layout, csrc/
// dfa3d_bwd.cu; the warp's code is sgc::mh_fwd_warp in csrc/dfa3d_mh.cuh,
// which the windowed forward of the sorted path shares): eight contiguous
// channels per lane (one 16-byte load of a bf16 row piece, two of f32), so
// a head of c channels takes LANES = c / 8 lanes and a warp takes HPW = 32
// / LANES (query, head) rows of one view (sgc::WarpRows): at c = 32 a warp
// is one query's eight heads, four lanes each; where a query's heads fill
// less than a warp, whole queries share it (at c = 16 and 8 heads, two
// queries of eight 2-lane heads: one query a warp left lanes 16-31 idle
// and measured 0.61 ms against 0.51 on an H100 at the -L level 2, PERF.md).
// Any c that is a multiple of 8 up to 256 fits the layout.
//   1. The sample quantities are computed once per (head, point), not once
//      per lane: in a round, lane sub of a row takes the row's point sub of
//      the round's LANES points (at c = 32 and 4 points the 32 lanes are
//      exactly the warp's 32 samples, one round; at c = 16 two rounds of
//      two points), loads its location and attention (a row's points are
//      contiguous, so the loads coalesce), computes the four corner pixels
//      (-1 off the image) and bilinear x attention weights, and issues the
//      loads of its two depth bins per corner.
//   2. A row's lanes take each point's corner pixels by shuffle and issue
//      the corner loads of two points (8 loads of 16 bytes) before any
//      multiply-add.  Only then are the depth scores folded into the
//      weights and the weights shuffled over, so the value and depth loads
//      are in flight together: location, then value and depth, is the whole
//      chain of dependent loads.
//   3. The warp's output rows are stored by one coalesced instruction (8
//      heads x 32 channels = 512 bytes at c = 32).
// Counted-out queries come last in a view: a warp with none counted writes
// its zeros and returns, and the rows of a partly counted warp past its
// counted queries take part in the shuffles, load nothing and write zeros.
// Lanes past the last row (heads not a multiple of HPW, a view's last
// queries) take part in the shuffles and write nothing.  The grid is (a
// view's warps, views), so a warp finds its rows by 32-bit arithmetic.
// The one-point case (stage 1, K2 and K2') keeps the earlier design: a
// warp per (view, query, head), c / 32 channels a lane, every lane
// computing the sample itself.  Off-image corners are never loaded.  No
// pair/quad row images (those worked around Mosaic).
#include "dfa3d_mh.cuh"

namespace {

// The multi-head layout (P > 1), PG points a round.  Three blocks an SM
// (at most 85 registers a thread) measured faster for K3 than the
// compiler's own choice.
template <typename VT, typename DT, int C, int PG>
__global__ void __launch_bounds__(256, 3) dfa3d_fwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int n, int h, int w, int heads, int dsize, int k, int p) {
  using Rows = sgc::WarpRows<32 / (C / 8)>;
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= Rows::per_view(k, heads)) return;
  const int cam = blockIdx.y;
  const long long hw = (long long)h * w;
  const sgc::GlobalDepth<DT> dep{depth + cam * hw * dsize, nullptr, dsize};
  sgc::mh_fwd_warp<VT, DT, C, PG>(value + cam * hw * heads * C, locs, attn, out,
                                  Rows::of(cam, warp, k, heads, counts), h, w, heads,
                                  dsize, p, dep);
}

// One point a head (stage 1: heads = P = 1, K2 and K2'): a warp per
// (view, query, head), C / 32 channels a lane; every lane computes the
// sample from broadcast loads and walks the corners one after another.  A
// warp has a single sample, so sharing its arithmetic gains nothing, and
// the multi-head layout ran this case slower in f32 (PERF.md).
template <typename VT, typename DT, int VEC>
__global__ void __launch_bounds__(256) dfa3d_fwd_one_point_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, 1, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, 1)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int n, int h, int w, int heads, int dsize, int k) {
  static_assert(VEC >= 1, "the one-point kernel takes c = 32 * VEC channels");
  constexpr int C = 32 * VEC;  // channels per head
  const int lane = threadIdx.x & 31;
  const long long warp_id =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id >= (long long)n * k * heads) return;
  const int head = (int)(warp_id % heads);
  const long long nq = warp_id / heads;  // cam * k + q
  const int q = (int)(nq % k);
  const int cam = (int)(nq / k);
  const int cfull = heads * C;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  if (counts == nullptr || q < counts[cam]) {
    const long long hw = (long long)h * w;
    const float* lp = locs + warp_id * 3;
    const VT* vbase = value + cam * hw * cfull + head * C + lane * VEC;
    const DT* dbase = depth + cam * hw * dsize;
    const float u = sgc::clip_coord(lp[0] * w - 0.5f, -4.f, w + 4.f);
    const float v = sgc::clip_coord(lp[1] * h - 0.5f, -4.f, h + 4.f);
    const float dd = sgc::clip_coord(lp[2] * dsize - 0.5f, -4.f, dsize + 4.f);
    const float a = attn[warp_id];
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
      const long long pix = (long long)yi * w + xi;
      const DT* drow = dbase + pix * dsize;
      const float ds = sgc::to_f32(drow[d0c]) * wd0 + sgc::to_f32(drow[d1c]) * wd1;
      const float wgt = ((dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * a) * ds;
      float val[VEC];
      sgc::load_f32<VT, VEC>(vbase + pix * cfull, val);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += wgt * val[i];
    }
  }
  sgc::store_from_f32<VT, VEC>(out + nq * cfull + head * C + lane * VEC, acc);
}

template <typename VT, typename DT, int C>
void launch(const void* value, const void* depth, const float* locs,
            const float* attn, const int* counts, void* out, int n, int h,
            int w, int heads, int dsize, int k, int p, cudaStream_t stream) {
  const int threads = 256;
  if constexpr (C % 32 == 0) {  // the one-point kernel takes whole lanes of channels
    if (p == 1) {
      const long long warps = (long long)n * k * heads;
      const long long blocks = (warps + (threads / 32) - 1) / (threads / 32);
      dfa3d_fwd_one_point_kernel<VT, DT, C / 32><<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
          counts, static_cast<VT*>(out), n, h, w, heads, dsize, k);
      return;
    }
  }
  const int warps = sgc::WarpRows<32 / (C / 8)>::per_view(k, heads);
  const dim3 grid((warps + (threads / 32) - 1) / (threads / 32), n);  // (a view's warps, views)
  dfa3d_fwd_kernel<VT, DT, C, 2><<<grid, threads, 0, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<VT*>(out), n, h, w, heads, dsize, k, p);
}

template <typename VT, typename DT>
int dispatch_c(int c, const void* value, const void* depth, const float* locs,
               const float* attn, const int* counts, void* out, int n, int h,
               int w, int heads, int dsize, int k, int p, cudaStream_t stream) {
  switch (c) {
    case 16: launch<VT, DT, 16>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
    case 32: launch<VT, DT, 32>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
    case 128: launch<VT, DT, 128>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
    case 256: launch<VT, DT, 256>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// value (N, H, W, heads*c) of type vdtype, depth (N, H, W, dsize) of type
// ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P) f32, counts
// (N,) int32 or null -> out (N, K, heads*c) of type vdtype.
extern "C" int sgc_dfa3d_fwd(int vdtype, int ddtype, const void* value,
                             const void* depth, const float* locs,
                             const float* attn, const int* counts, void* out,
                             int n, int h, int w, int heads, int c, int dsize,
                             int k, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if (ddtype == sgc::kBFloat16) {
    if (vdtype != sgc::kBFloat16) return (int)cudaErrorInvalidValue;
    return dispatch_c<__nv_bfloat16, __nv_bfloat16>(c, value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, s);
  }
  if (ddtype != sgc::kFloat32) return (int)cudaErrorInvalidValue;
  if (vdtype == sgc::kBFloat16)
    return dispatch_c<__nv_bfloat16, float>(c, value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, s);
  if (vdtype == sgc::kFloat32)
    return dispatch_c<float, float>(c, value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, s);
  return (int)cudaErrorInvalidValue;
}
