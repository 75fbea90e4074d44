// Fused DFA3D sampling forward (kernels K2 `dfa3d_fwd_s1`, K3
// `dfa3d_fwd_mh` and their bf16-depth instances K2' `dfa3d_fwd_s1_bd`, K3'
// `dfa3d_fwd_mh_bd`): one template, one entry point; the wrapper counts the
// four apart.
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
// kernels), at c = 256 (stage 1) and c = 32 (stage 2).  The math is f32
// and the output is written once, in the value type.
//
// What bounds it on this card: gathered bytes.  Per (query, head, point)
// the kernel reads four data-dependent value rows (c channels each) and two
// depth bins per corner (2 bytes each at bf16 depth, 4 at f32); the
// arithmetic is a few flops per byte.  The value
// maps of one call (40 x 59 x 80 x 256 bf16 = 97 MB at the finest level)
// exceed the 50 MB L2, so the rows come from L2 where projections of nearby
// queries overlap and from HBM otherwise.
//
// Design: one warp per (view, query, head); its lanes spread over the c
// channels of that head (c / 32 contiguous channels per lane: one 16-byte
// load per corner row at stage 1's c=256 bf16).  The sample coordinates,
// corner weights and depth scores are computed inline by every lane from
// the same scalars (broadcast loads), so nothing is staged in shared memory
// and no pair/quad row images are built (those worked around Mosaic).
// Corners outside the image are skipped, never loaded.  Accumulation is in
// f32 registers; the output row is stored once.
#include "common.cuh"

namespace {

template <typename VT, typename DT, int VEC>
__global__ void __launch_bounds__(256) dfa3d_fwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*c)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, heads*c)
    int n, int h, int w, int heads, int dsize, int k, int p) {
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
    const float* lp = locs + warp_id * p * 3;
    const float* ap = attn + warp_id * p;
    const VT* vbase = value + cam * hw * cfull + head * C + lane * VEC;
    const DT* dbase = depth + cam * hw * dsize;
    for (int pt = 0; pt < p; ++pt) {
      const float u = sgc::clip_coord(lp[3 * pt] * w - 0.5f, -4.f, w + 4.f);
      const float v = sgc::clip_coord(lp[3 * pt + 1] * h - 0.5f, -4.f, h + 4.f);
      const float dd = sgc::clip_coord(lp[3 * pt + 2] * dsize - 0.5f, -4.f,
                                       dsize + 4.f);
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
        const long long pix = (long long)yi * w + xi;
        const DT* drow = dbase + pix * dsize;
        const float ds = sgc::to_f32(drow[d0c]) * wd0 + sgc::to_f32(drow[d1c]) * wd1;
        const float wgt =
            ((dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * a) * ds;
        float val[VEC];
        sgc::load_f32<VT, VEC>(vbase + pix * cfull, val);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += wgt * val[i];
      }
    }
  }
  sgc::store_from_f32<VT, VEC>(out + nq * cfull + head * C + lane * VEC, acc);
}

template <typename VT, typename DT, int VEC>
void launch(const void* value, const void* depth, const float* locs,
            const float* attn, const int* counts, void* out, int n, int h,
            int w, int heads, int dsize, int k, int p, cudaStream_t stream) {
  const long long warps = (long long)n * k * heads;
  const int threads = 256;
  const long long blocks = (warps + (threads / 32) - 1) / (threads / 32);
  dfa3d_fwd_kernel<VT, DT, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<VT*>(out), n, h, w, heads, dsize, k, p);
}

template <typename VT, typename DT>
int dispatch_c(int c, const void* value, const void* depth, const float* locs,
               const float* attn, const int* counts, void* out, int n, int h,
               int w, int heads, int dsize, int k, int p, cudaStream_t stream) {
  switch (c) {
    case 32: launch<VT, DT, 1>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
    case 256: launch<VT, DT, 8>(value, depth, locs, attn, counts, out, n, h, w, heads, dsize, k, p, stream); break;
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
