// The multi-head DFA3D warp: one (view, query) and a group of its heads,
// eight channels a lane.  The forward (mh_fwd_warp) is K3's and the
// backward (mh_bwd_warp) K5's; their designs are described in
// csrc/dfa3d_fwd.cu and csrc/dfa3d_bwd.cu.  The windowed kernels of the
// sorted path (csrc/dfa3d_win_fwd.cu, dfa3d_win_bwd.cu) run the same warps
// with their depth bins staged in shared memory, so a chunk that no window
// serves costs what the templates cost.
//
// What differs between the two users is one policy object, Depth, which
// says how a sample's pixel coordinate is computed and where a corner's
// depth bins are read and their gradients added:
//   GlobalDepth  — the templates: loc * size - 0.5 as nvcc compiles it, bins
//                  read from and d_dpt added to global memory;
//   WindowDepth  — the windowed kernels: pixel_coord (no fused multiply-add,
//                  so that kernel and plan agree on every window), and, for
//                  pixels [base, base + span), the bins read from shared
//                  memory (BINS, the forward) or the d_dpt updates summed
//                  there (the backward); any other pixel as GlobalDepth.
#pragma once

#include "common.cuh"

namespace sgc {

template <typename DT>
struct GlobalDepth {
  const DT* dmap;  // the view's depth (H, W, D)
  float* ddmap;    // the view's d_depth (H, W, D), or null: not computed
  int dsize;

  static __device__ __forceinline__ float coord(float loc, int size) {
    return clip_coord(loc * size - 0.5f, -4.f, size + 4.f);
  }
  __device__ __forceinline__ bool depth_grad() const { return ddmap != nullptr; }
  __device__ __forceinline__ void bins(long long pix, int d0c, int d1c, float& dp0,
                                       float& dp1) const {
    const DT* drow = dmap + pix * dsize;
    dp0 = to_f32(drow[d0c]);
    dp1 = to_f32(drow[d1c]);
  }
  __device__ __forceinline__ void add(long long pix, int bin, float x) const {
    atomicAdd(ddmap + pix * dsize + bin, x);
  }
};

// The depth bins of pixels [base, base + span) of the view's map dmap, as
// f32, into shared memory s (16-byte aligned), by 16-byte cp.async copies
// where the rows are f32 and aligned.  Every thread of the block calls it;
// the caller syncs.
template <typename DT>
__device__ __forceinline__ void stage_depth(float* s, const DT* dmap, int base,
                                            int span, int dsize) {
  const DT* src = dmap + (long long)base * dsize;
  const int n = span * dsize;
  if (sizeof(DT) == 4 && n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) cp_async16(s + 4 * i, src + 4 * i);
    cp_async_wait_all();
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = to_f32(src[i]);
}

// Zero n f32 of shared memory (16-byte aligned).
__device__ __forceinline__ void zero_shared(float* s, int n) {
  int i = threadIdx.x * 4;
  for (; i + 3 < n; i += blockDim.x * 4)
    *reinterpret_cast<float4*>(s + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n)
    for (int j = i; j < n; ++j) s[j] = 0.f;
}

// Add the n f32 sums s (shared, 16-byte aligned) to dst in global memory,
// skipping zeros: a 16-byte vector reduction per nonzero quad where dst is
// aligned and n a multiple of four (the d_depth rows of 12 bins are three
// quads a pixel), else a scalar atomic per nonzero element.  Every thread
// of the block calls it after a sync.
__device__ __forceinline__ void flush_add(float* dst, const float* s, int n) {
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const float4 x = reinterpret_cast<const float4*>(s)[i];
      if (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(dst) + i, x);
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (s[i] != 0.f) atomicAdd(dst + i, s[i]);
}

template <typename DT, bool BINS = true>
struct WindowDepth {
  GlobalDepth<DT> global;
  const float* s_dpt;  // bins of pixels [base, base + span) in f32, shared (BINS)
  float* s_dd;         // their d_depth sums, shared, or null
  int base, span;      // span 0: nothing staged

  static __device__ __forceinline__ float coord(float loc, int size) {
    return pixel_coord(loc, size);
  }
  __device__ __forceinline__ bool depth_grad() const { return global.depth_grad(); }
  __device__ __forceinline__ void bins(long long pix, int d0c, int d1c, float& dp0,
                                       float& dp1) const {
    const unsigned rel = (unsigned)((int)pix - base);
    if (BINS && rel < (unsigned)span) {
      const float* r = s_dpt + rel * global.dsize;
      dp0 = r[d0c];
      dp1 = r[d1c];
    } else {
      global.bins(pix, d0c, d1c, dp0, dp1);
    }
  }
  __device__ __forceinline__ void add(long long pix, int bin, float x) const {
    const unsigned rel = (unsigned)((int)pix - base);
    if (rel < (unsigned)span) atomicAdd(s_dd + rel * global.dsize + bin, x);
    else global.add(pix, bin, x);
  }
};

// The (query, head) rows a warp of K3 or K5 takes: a row is (view * K + q)
// * heads + head, and a warp holds HPW = 32 / (C / 8) of them.  Where a
// query's heads fill less than a warp, the warp takes as many whole
// queries of one view as it holds (HPW / heads: at C = 16 and 8 heads two
// queries, at C = 32 and 8 heads one), else HPW heads of one query.  The
// templates launch a grid of (warps of a view, views) so that a warp finds
// its rows by 32-bit arithmetic.  The windowed kernels take a chunk of a
// view a block, and a warp the same rows of the chunk (span).
template <int HPW>
struct WarpRows {
  long long row0;  // the warp's first row
  int nrows;       // its rows (HPW or fewer)
  int nlive;       // the first nlive of them are counted queries' rows
  int head0;       // the head of its first row

  static __host__ __device__ __forceinline__ int queries(int heads) {
    return heads < HPW ? HPW / heads : 1;
  }
  // warps a view takes
  static __host__ __device__ __forceinline__ int per_view(int k, int heads) {
    const int qpw = queries(heads);
    return (k + qpw - 1) / qpw * ((heads + HPW - 1) / HPW);
  }
  // the rows of warp `warp` (< per_view(k, heads)) of view `cam`; counts
  // null: every query counts
  static __device__ __forceinline__ WarpRows of(int cam, int warp, int k, int heads,
                                                const int* __restrict__ counts) {
    const int qpw = queries(heads), hgroups = (heads + HPW - 1) / HPW;
    const int q0 = warp / hgroups * qpw, h0 = warp % hgroups * HPW;
    const int nq = min(qpw, k - q0), nh = min(HPW, heads - h0);
    const int count = counts == nullptr ? k : counts[cam];
    // counted queries come first
    return {((long long)cam * k + q0) * heads + h0, nq * nh,
            min(max(count - q0, 0), nq) * nh, h0};
  }
  // heads [h0, h0 + HPW) of the queries [q, q + queries(heads)) of the view
  // whose first row is vq = view * K, cut at qend (the block's chunk end:
  // a view's last query may be alone); the view's first `count` queries
  // are counted (the windowed kernels' warps, as of())
  static __device__ __forceinline__ WarpRows span(long long vq, int q, int qend, int count,
                                                  int h0, int heads) {
    const int nq = min(queries(heads), qend - q), nh = min(HPW, heads - h0);
    return {(vq + q) * heads + h0, nq * nh, min(max(count - q, 0), nq) * nh, h0};
  }
  // the head of the warp's row i (a valid head for any i < HPW)
  __device__ __forceinline__ int head(int i, int heads) const {
    return i < heads - head0 ? head0 + i : i % heads;
  }
};

// K3's warp (csrc/dfa3d_fwd.cu): the rows [row0, row0 + nrows) of one
// view (at most HPW; a row's LANES lanes take its c channels), the first
// nlive of them counted; vmap is the view's value map.  A round takes
// LANES points of every row, lane sub of a row computing its point sub,
// and loads their corners PG points at a time.  Writes the rows' output
// (zeros past nlive).
template <typename VT, typename DT, int C, int PG, typename Depth>
__device__ __forceinline__ void mh_fwd_warp(
    const VT* __restrict__ vmap, const float* __restrict__ locs,
    const float* __restrict__ attn, VT* __restrict__ out, const WarpRows<32 / (C / 8)>& r,
    int h, int w, int heads, int dsize, int p, const Depth& dep) {
  static_assert(C % 8 == 0 && C <= 256, "a head is 1-32 lanes of 8 channels");
  constexpr int VEC = 8;          // channels per lane
  constexpr int LANES = C / VEC;  // lanes per row
  const int lane = threadIdx.x & 31;
  const int cfull = heads * C;
  const int hl = lane / LANES;  // this lane's row in the warp
  const int sub = lane % LANES;
  const long long row0 = r.row0;
  const int nrows = r.nrows, nlive = r.nlive;
  VT* orow = out + (row0 + min(hl, nrows - 1)) * C + sub * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  if (nlive > 0) {
    const bool live = hl < nlive;
    const VT* vbase = vmap + r.head(hl, heads) * C + sub * VEC;
    int cpix[4];
    float bw[4], dp0[4], dp1[4], wd0, wd1;
    for (int pb = 0; pb < p; pb += LANES) {
      // 1. sample (row hl, point pb + sub), and the loads of its depth bins
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        cpix[corner] = -1;
        bw[corner] = dp0[corner] = dp1[corner] = 0.f;
      }
      wd0 = wd1 = 0.f;
      if (live && pb + sub < p) {
        const long long smp = (row0 + hl) * p + pb + sub;
        const float* l = locs + smp * 3;
        const float u = Depth::coord(l[0], w);
        const float v = Depth::coord(l[1], h);
        const float dd = Depth::coord(l[2], dsize);
        const float a = attn[smp];
        const float x0f = floorf(u), y0f = floorf(v), d0f = floorf(dd);
        const float lx = u - x0f, ly = v - y0f, ld = dd - d0f;
        const int x0 = (int)x0f, y0 = (int)y0f, d0 = (int)d0f;
        wd0 = (d0 >= 0 && d0 <= dsize - 1) ? 1.f - ld : 0.f;
        wd1 = (d0 + 1 >= 0 && d0 + 1 <= dsize - 1) ? ld : 0.f;
        const int d0c = min(max(d0, 0), dsize - 1);
        const int d1c = min(max(d0 + 1, 0), dsize - 1);
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
          const int dy = corner >> 1, dx = corner & 1;
          const int yi = y0 + dy, xi = x0 + dx;
          const bool in = yi >= 0 && yi <= h - 1 && xi >= 0 && xi <= w - 1;
          cpix[corner] = in ? yi * w + xi : -1;
          bw[corner] = (dy ? ly : 1.f - ly) * (dx ? lx : 1.f - lx) * a;
          if (in) dep.bins(cpix[corner], d0c, d1c, dp0[corner], dp1[corner]);
        }
      }
      // 2. this lane's row's points of the round, PG at a time: the corner
      // pixels by shuffle, every corner load of the PG points, then the
      // weights (which wait on the depth loads) and the multiply-adds
      const int np = min(LANES, p - pb);  // points of the round
      for (int pt0 = 0; pt0 < np; pt0 += PG) {
        int pix[PG][4];
#pragma unroll
        for (int i = 0; i < PG; ++i) {
          const int src = hl * LANES + pt0 + i;  // lane holding the sample
          const bool mine = live && pt0 + i < np;
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            const int ps = __shfl_sync(0xffffffffu, cpix[corner], src & 31);
            pix[i][corner] = mine ? ps : -1;
          }
        }
        Vec<VT, VEC> raw[PG][4];
#pragma unroll
        for (int i = 0; i < PG; ++i)
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            if (pix[i][corner] >= 0) {
              raw[i][corner] = *reinterpret_cast<const Vec<VT, VEC>*>(
                  vbase + (long long)pix[i][corner] * cfull);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) raw[i][corner].v[j] = from_f32<VT>(0.f);
            }
          }
        float cw[4];
#pragma unroll
        for (int corner = 0; corner < 4; ++corner)
          cw[corner] = bw[corner] * (dp0[corner] * wd0 + dp1[corner] * wd1);
#pragma unroll
        for (int i = 0; i < PG; ++i) {
          const int src = hl * LANES + pt0 + i;
#pragma unroll
          for (int corner = 0; corner < 4; ++corner) {
            const float wgt = __shfl_sync(0xffffffffu, cw[corner], src & 31);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[j] += wgt * to_f32(raw[i][corner].v[j]);
          }
        }
      }
    }
  }
  if (hl < nrows) store_from_f32<VT, VEC>(orow, acc);
}

// K5's warp (csrc/dfa3d_bwd.cu): the rows [row0, row0 + nrows) of one
// view, the first nlive of them counted, as K3's; vmap, dvmap are the
// view's value map and d_value.  The rows of queries that are not counted
// get zero location and attention gradients and scatter nothing.
template <typename VT, typename DT, int C, bool SAMPLE_GRADS, bool DOT, typename Depth>
__device__ __forceinline__ void mh_bwd_warp(
    const VT* __restrict__ vmap, const float* __restrict__ locs,
    const float* __restrict__ attn, const VT* __restrict__ g,
    float* __restrict__ dvmap, float* __restrict__ d_locs,
    float* __restrict__ d_attn, const WarpRows<32 / (C / 8)>& r, int h, int w, int heads,
    int dsize, int p, const Depth& dep) {
  constexpr int VEC = 8;           // channels per lane
  constexpr int LANES = C / VEC;   // lanes per row
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;
  const int cfull = heads * C;
  const long long row0 = r.row0;
  const int nrows = r.nrows, nlive = r.nlive;

  if (nlive == 0) {
    if (SAMPLE_GRADS) {
      for (int i = lane; i < nrows * p * 3; i += 32) d_locs[row0 * p * 3 + i] = 0.f;
      for (int i = lane; i < nrows * p; i += 32) d_attn[row0 * p + i] = 0.f;
    }
    return;
  }

  // lanes past the last row (heads not a multiple of HPW, a view's last
  // queries) read the last row's operands, take part in the shuffles and
  // write nothing; those of a row past nlive scatter nothing
  const int hl = lane / LANES;
  const bool active = hl < nrows, live = hl < nlive;
  const long long row = row0 + min(hl, nrows - 1);  // (query, head) row of locs / attn
  const bool first = active && sub == 0;
  float gv[VEC];
  load_f32<VT, VEC>(g + row * C + sub * VEC, gv);
  const float* lp = locs + row * p * 3;
  const float* ap = attn + row * p;
  const VT* vbase = vmap + r.head(hl, heads) * C + sub * VEC;
  // d_value is written in SLOTS instructions per corner; slot s covers the
  // warp's channels [128 s, 128 s + 128) in row order, four per lane, so
  // each instruction adds four whole 128-byte rows.  A lane therefore
  // writes for the row whose sample sits in lane wsrc[s], and holds that
  // row's incoming gradient at its four channels.
  constexpr int SLOTS = VEC / 4;
  int wsrc[SLOTS], woff[SLOTS];
  float gw[SLOTS][4];
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const int f = 128 * sl + 4 * lane, hiw = f / C, wr = min(hiw, nrows - 1);
    wsrc[sl] = hiw * LANES;
    woff[sl] = r.head(wr, heads) * C + f % C;
    load_f32<VT, 4>(g + (row0 + wr) * C + f % C, gw[sl]);
  }

  for (int pt = 0; pt < p; ++pt) {
    const float u = Depth::coord(lp[3 * pt], w);
    const float v = Depth::coord(lp[3 * pt + 1], h);
    const float dd = Depth::coord(lp[3 * pt + 2], dsize);
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
      // uniform over a row's lanes; the shuffles below take every lane
      const bool in = live && yi >= 0 && yi <= h - 1 && xi >= 0 && xi <= w - 1;
      const long long pix = (long long)yi * w + xi;
      const float by = dy ? ly : 1.f - ly, bx = dx ? lx : 1.f - lx;
      const float b = by * bx;
      float dp0 = 0.f, dp1 = 0.f, t = 0.f, wgt = 0.f;
      if (in) {
        dep.bins(pix, d0c, d1c, dp0, dp1);
        wgt = (b * a) * (dp0 * wd0 + dp1 * wd1);
        if (DOT) {
          float val[VEC];
          load_f32<VT, VEC>(vbase + pix * cfull, val);
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
        atomic_add_f32<4>(dvmap + (long long)ps * cfull + woff[sl], upd);
      }
      if (!DOT) continue;
      t = group_sum<LANES>(t);
      if (!in) continue;
      const float s = dp0 * wd0 + dp1 * wd1;
      const float t_s = t * b * a;  // gradient of the depth score s
      if (sub < 2 && dep.depth_grad()) {  // one instruction, both bins
        const float wd = sub == 0 ? wd0 : wd1;
        if (wd != 0.f) dep.add(pix, sub == 0 ? d0c : d1c, t_s * wd);
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
      float* dl = d_locs + (row * p + pt) * 3;
      dl[0] = g_lx * w;
      dl[1] = g_ly * h;
      dl[2] = g_ld * dsize;
      d_attn[row * p + pt] = g_a;
    }
  }
}

}  // namespace sgc
