// Fused DFA3D sampling forward (kernels K2 `dfa3d_fwd_s1`, K3
// `dfa3d_fwd_mh` and their bf16-depth instances K2' `dfa3d_fwd_s1_bd`, K3'
// `dfa3d_fwd_mh_bd`): a stage-1 template (heads = P = 1) and a multi-head
// one (any other heads and P), behind one entry point; the wrapper counts
// the four apart.
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
//
// Design of stage 1 (K2, K2'; heads = P = 1: one sample a query, C channels),
// which PERF.md's row 4L found at 2.2x its bound with a warp a query: the
// lanes loaded the same location and attention, walked the chain location
// -> depth bins -> weights -> value rows one query at a time, and moved 8
// bytes each at c = 128.  Now a warp takes QW consecutive queries of one
// view, on a grid of (a view's warps, views), so its rows follow by 32-bit
// arithmetic:
//   1. lane i < QW loads query i's location and attention (one coalesced
//      load each), computes its four corner pixels (-1 off the image) and
//      bilinear x attention weights and the depth lerp, and issues the
//      eight depth-bin loads together;
//   2. the warp walks its queries in rounds: a query's row is moved in
//      16-byte lanes (C / 8 of them at bf16, C / 4 at f32, at most 32, so
//      a lane takes 16 or 32 bytes of a row), so a round takes 32 / lanes
//      queries: two at c = 128 bf16, eight at c = 32, one at c = 256.  A
//      lane takes its round's corner pixels by shuffle and issues the
//      corner loads of RG = 2 rounds (8 loads of 16 bytes at bf16) before
//      the weights, which wait on the depth loads, are folded and shuffled
//      over; then every lane stores its 16 bytes (a round's rows are one
//      contiguous piece of the output).
// A warp takes kS1Rounds = 4 rounds, so QW is 4 queries at c = 256 bf16, 8
// at c = 128 and 32 at c = 32.  32 queries a warp at every width (16 and 32
// rounds) ran the counted c = 256 calls slower than a warp a query: their
// views' counted queries leave about one wave of long warps, whose last
// ones run alone.  Fewer rounds a warp shorten that tail (PERF.md;
// python -m sgcdet_tpu_torch.experiments.variants).
// Queries at or past the view's count are written as zeros (a warp with
// none counted writes its zeros and returns), and a ragged last warp
// writes nothing past K.  Off-image corners are never loaded.  No pair /
// quad row images (those worked around Mosaic).
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

// Rounds of queries a stage-1 warp takes (up to 32 queries).
constexpr int kS1Rounds = 4;

// The stage-1 warp's layout at value type VT and C channels.
template <typename VT, int C>
struct S1Layout {
  static constexpr int VEC = 16 / sizeof(VT);                // elements a 16-byte move
  static constexpr int LANES = C / VEC < 32 ? C / VEC : 32;  // lanes of a query's row
  static constexpr int CPL = C / LANES;                      // channels a lane
  static constexpr int NV = CPL / VEC;                       // 16-byte moves a lane and corner
  static constexpr int QPR = 32 / LANES;                     // queries a round
  static constexpr int QW = QPR * kS1Rounds < 32 ? QPR * kS1Rounds : 32;  // queries a warp
  static_assert(C % VEC == 0 && CPL % VEC == 0 && 32 % LANES == 0,
                "a query's row is whole 16-byte lanes of a warp");
};

// Stage 1 (heads = P = 1, K2 and K2'): a warp takes QW consecutive
// queries of view blockIdx.y, as the design above says.
template <typename VT, typename DT, int C>
__global__ void __launch_bounds__(128) dfa3d_fwd_s1_kernel(
    const VT* __restrict__ value,    // (N, H, W, C)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, 1, 1, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, 1, 1)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    VT* __restrict__ out,            // (N, K, C)
    int h, int w, int dsize, int k) {
  using L = S1Layout<VT, C>;
  constexpr int VEC = L::VEC, LANES = L::LANES, CPL = L::CPL, NV = L::NV, QPR = L::QPR;
  constexpr int QW = L::QW;
  constexpr int RG = 2;  // rounds loaded together
  using Raw = sgc::Vec<VT, VEC>;
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * QW;
  if (q0 >= k) return;
  const int cam = blockIdx.y;
  const int nq = min(QW, k - q0);
  const int nlive = counts == nullptr ? nq : min(max(counts[cam] - q0, 0), nq);
  const long long row0 = (long long)cam * k + q0;  // the warp's first query row
  VT* obase = out + row0 * C;
  if (nlive == 0) {
    Raw zero;
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero.v[e] = sgc::from_f32<VT>(0.f);
    for (int i = lane; i < nq * (C / VEC); i += 32) reinterpret_cast<Raw*>(obase)[i] = zero;
    return;
  }
  const int hw = h * w;
  const VT* vmap = value + (long long)cam * hw * C;

  // 1. lane i's sample (query q0 + i) and the loads of its depth bins
  int cpix[4];
  float bw[4], dp0[4], dp1[4], wd0 = 0.f, wd1 = 0.f;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    cpix[corner] = -1;
    bw[corner] = dp0[corner] = dp1[corner] = 0.f;
  }
  if (lane < nlive) {
    const float* l = locs + (row0 + lane) * 3;
    const float u = sgc::GlobalDepth<DT>::coord(l[0], w);
    const float v = sgc::GlobalDepth<DT>::coord(l[1], h);
    const float dd = sgc::GlobalDepth<DT>::coord(l[2], dsize);
    const float a = attn[row0 + lane];
    const float x0f = floorf(u), y0f = floorf(v), d0f = floorf(dd);
    const float lx = u - x0f, ly = v - y0f, ld = dd - d0f;
    const int x0 = (int)x0f, y0 = (int)y0f, d0 = (int)d0f;
    wd0 = (d0 >= 0 && d0 <= dsize - 1) ? 1.f - ld : 0.f;
    wd1 = (d0 + 1 >= 0 && d0 + 1 <= dsize - 1) ? ld : 0.f;
    const int d0c = min(max(d0, 0), dsize - 1);
    const int d1c = min(max(d0 + 1, 0), dsize - 1);
    const DT* dmap = depth + (long long)cam * hw * dsize;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1, dx = corner & 1;
      const int yi = y0 + dy, xi = x0 + dx;
      const bool in = yi >= 0 && yi <= h - 1 && xi >= 0 && xi <= w - 1;
      cpix[corner] = in ? yi * w + xi : -1;
      bw[corner] = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * a;
      if (in) {
        const DT* drow = dmap + cpix[corner] * dsize;
        dp0[corner] = sgc::to_f32(drow[d0c]);
        dp1[corner] = sgc::to_f32(drow[d1c]);
      }
    }
  }

  // 2. the rounds, RG at a time: this lane's slice `sub` of query qs of
  // each round
  const int sub = lane % LANES, qs = lane / LANES;
  const int rounds = (nq + QPR - 1) / QPR;
  for (int r0 = 0; r0 < rounds; r0 += RG) {
    int pix[RG][4];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int src = ((r0 + i) * QPR + qs) & 31;  // lane holding the query
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int ps = __shfl_sync(0xffffffffu, cpix[corner], src);
        pix[i][corner] = r0 + i < rounds ? ps : -1;
      }
    }
    Raw raw[RG][4][NV];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int corner = 0; corner < 4; ++corner)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (pix[i][corner] >= 0) {
            raw[i][corner][j] = *reinterpret_cast<const Raw*>(
                vmap + pix[i][corner] * C + sub * CPL + j * VEC);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) raw[i][corner][j].v[e] = sgc::from_f32<VT>(0.f);
          }
        }
    float cw[4];  // waits on the depth loads
#pragma unroll
    for (int corner = 0; corner < 4; ++corner)
      cw[corner] = bw[corner] * (dp0[corner] * wd0 + dp1[corner] * wd1);
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int src = ((r0 + i) * QPR + qs) & 31;
      float acc[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[e] = 0.f;
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const float wgt = __shfl_sync(0xffffffffu, cw[corner], src);
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[j * VEC + e] += wgt * sgc::to_f32(raw[i][corner][j].v[e]);
      }
      const int q = (r0 + i) * QPR + qs;
      if (r0 + i < rounds && q < nq) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float part[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[e] = acc[j * VEC + e];
          sgc::store_from_f32<VT, VEC>(obase + q * C + sub * CPL + j * VEC, part);
        }
      }
    }
  }
}

template <typename VT, typename DT, int C>
void launch(const void* value, const void* depth, const float* locs,
            const float* attn, const int* counts, void* out, int n, int h,
            int w, int heads, int dsize, int k, int p, cudaStream_t stream) {
  if constexpr (C >= 32) {  // the stage-1 widths (ops/dfa3d.py::FWD_WIDTHS)
    if (heads == 1 && p == 1) {
      constexpr int threads = 128;
      const int warps = (k + S1Layout<VT, C>::QW - 1) / S1Layout<VT, C>::QW;  // a view's
      const dim3 grid((warps + threads / 32 - 1) / (threads / 32), n);
      dfa3d_fwd_s1_kernel<VT, DT, C><<<grid, threads, 0, stream>>>(
          static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
          counts, static_cast<VT*>(out), h, w, dsize, k);
      return;
    }
  }
  const int threads = 256;
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
