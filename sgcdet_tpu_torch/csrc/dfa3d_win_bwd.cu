// Windowed DFA3D sampling backward, multi-head, c = 32 per head (counter
// `dfa3d_win_bwd_mh`).
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
// Design: the blocks and windows of dfa3d_win_fwd.cu, one block per (head,
// chunk of qc queries, view).  With a window [base, base + span) the block
// stages the head's 32 value channels (cp.async; only where a dot product
// is needed) and the depth bins (f32) of the window's pixels, and zeroes
// two f32 accumulators in shared memory: d_value (32 channels per pixel)
// and d_depth (D bins per pixel).  Each warp takes queries of the chunk,
// lanes over the head's channels, and per sample and corner computes what
// K5 computes in registers (the dot product t by a warp reduction, the
// location and attention gradients, written once per point by lane 0); the
// d_value and d_depth updates of in-window corners go to the shared
// accumulators by shared-memory atomics (native f32 on sm_90), those of
// other corners to global memory by global atomics, as in K5.  At the end
// each nonzero accumulator element is added to global memory by one atomic:
// neighbouring chunks' windows overlap, and the heads share the depth.
// Without a window the block runs K5's global path.  K5's flags stay: no
// depth atomics without d_depth, no value gather or dot product without
// sample or depth gradients (DOT).
//
// What bounds it on this card: the scatter.  Per window the kernel turns
// every in-window corner's 32 + 2 global atomics into shared ones, and adds
// at most span * (32 + D) global atomics at the flush; at 8 heads x 4
// points a chunk of 64 queries has 1024 corners per head against a window
// of up to ~700 pixels.  Shared memory (bf16 value, f32 depth with 12 bins,
// every gradient): 64 + 48 + 128 + 48 = 288 bytes a pixel, so the plan's
// window (ops/dfa3d_windowed.py::window_pixels) is ~700 pixels in ~200 KB,
// one block per SM; it has 1024 threads (32 warps, at most 64 registers a
// thread) to keep enough gathers and atomics in flight.
#include "common.cuh"

namespace {

constexpr int kC = 32;  // channels per head: one per lane
constexpr int kThreads = 1024;

template <typename VT, typename DT, bool SAMPLE_GRADS, bool DOT>
__global__ void __launch_bounds__(kThreads) dfa3d_win_bwd_kernel(
    const VT* __restrict__ value,    // (N, H, W, heads*32)
    const DT* __restrict__ depth,    // (N, H, W, D)
    const float* __restrict__ locs,  // (N, K, heads, P, 3) normalized (u, v, d)
    const float* __restrict__ attn,  // (N, K, heads, P)
    const int* __restrict__ counts,  // (N,) visible-query counts, or null
    const VT* __restrict__ g,        // (N, K, heads*32) incoming gradient
    float* __restrict__ d_value,     // (N, H, W, heads*32), zeroed by the caller
    float* __restrict__ d_depth,     // (N, H, W, D), zeroed by the caller, or null
    float* __restrict__ d_locs,      // (N, K, heads, P, 3) or null
    float* __restrict__ d_attn,      // (N, K, heads, P) or null
    int h, int w, int heads, int dsize, int k, int p, int qc, int wwin) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2];
  const bool dgrad = d_depth != nullptr;
  // the value window first (cp.async wants 16-byte alignment; a row is 64
  // or 128 bytes), then the f32 arrays
  VT* s_val = reinterpret_cast<VT*>(smem);                  // [wwin][32] if DOT
  float* s_dv = reinterpret_cast<float*>(smem + (DOT ? (size_t)wwin * kC * sizeof(VT) : 0));
  float* s_dpt = s_dv + (size_t)wwin * kC;                  // [wwin][D]
  float* s_dd = s_dpt + (size_t)wwin * dsize;               // [wwin][D] if dgrad
  const int head = blockIdx.x, chunk = blockIdx.y, cam = blockIdx.z;
  const int cfull = heads * kC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = counts == nullptr ? k : counts[cam];
  const int q0 = chunk * qc, q1 = min(k, q0 + qc);
  const int2 box = sgc::block_window(
      locs + (((long long)cam * k + q0) * heads + head) * p * 3, (long long)heads * p * 3,
      p, max(0, min(q1, count) - q0), h, w, s_box);
  const int base = box.x, span = box.y >= 0 ? box.y - box.x + 1 : 0;
  const long long hw = (long long)h * w;
  const VT* vmap = value + cam * hw * cfull + head * kC;  // pixel stride cfull
  float* dvmap = d_value + cam * hw * cfull + head * kC;
  const DT* dmap = depth + cam * hw * dsize;
  float* ddmap = dgrad ? d_depth + cam * hw * dsize : nullptr;
  const bool staged = span > 0 && span <= wwin;

  if (staged) {
    if (DOT) {
      constexpr int kVec = 16 / sizeof(VT);
      constexpr int kParts = kC / kVec;
      for (int i = threadIdx.x; i < span * kParts; i += kThreads) {
        const int r = i / kParts, part = i - r * kParts;
        sgc::cp_async16(s_val + r * kC + part * kVec,
                        vmap + (long long)(base + r) * cfull + part * kVec);
      }
    }
    const DT* dsrc = dmap + (long long)base * dsize;
    for (int i = threadIdx.x; i < span * dsize; i += kThreads) {
      s_dpt[i] = sgc::to_f32(dsrc[i]);
      if (dgrad) s_dd[i] = 0.f;
    }
    for (int i = threadIdx.x; i < span * kC; i += kThreads) s_dv[i] = 0.f;
    if (DOT) sgc::cp_async_wait_all();
  }
  __syncthreads();

  for (int q = q0 + warp; q < q1; q += kThreads / 32) {
    const long long sid = ((long long)cam * k + q) * heads + head;
    if (q >= count) {
      if (SAMPLE_GRADS) {
        for (int i = lane; i < 3 * p; i += 32) d_locs[sid * p * 3 + i] = 0.f;
        for (int i = lane; i < p; i += 32) d_attn[sid * p + i] = 0.f;
      }
      continue;
    }
    const float gv = sgc::to_f32(g[((long long)cam * k + q) * cfull + head * kC + lane]);
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
        if (yi < 0 || yi > h - 1 || xi < 0 || xi > w - 1) continue;
        const int pix = yi * w + xi;
        const int rel = pix - base;
        const bool in_win = staged && rel >= 0 && rel < span;
        float dp0, dp1;
        if (in_win) {
          dp0 = s_dpt[rel * dsize + d0c];
          dp1 = s_dpt[rel * dsize + d1c];
        } else {
          const DT* dr = dmap + (long long)pix * dsize;
          dp0 = sgc::to_f32(dr[d0c]);
          dp1 = sgc::to_f32(dr[d1c]);
        }
        const float s = dp0 * wd0 + dp1 * wd1;
        const float by = dy ? ly : 1.f - ly, bx = dx ? lx : 1.f - lx;
        const float b = by * bx;
        const float wgt = (b * a) * s;
        // explicit branches, so shared and global atomics compile as such
        if (in_win) atomicAdd(s_dv + rel * kC + lane, wgt * gv);
        else atomicAdd(dvmap + (long long)pix * cfull + lane, wgt * gv);
        if (!DOT) continue;
        const float val = sgc::to_f32(in_win ? s_val[rel * kC + lane]
                                             : vmap[(long long)pix * cfull + lane]);
        const float t = sgc::warp_sum(gv * val);
        const float t_s = t * b * a;  // gradient of the depth score s
        if (lane == 0 && dgrad) {
          if (in_win) {
            if (wd0 != 0.f) atomicAdd(s_dd + rel * dsize + d0c, t_s * wd0);
            if (wd1 != 0.f) atomicAdd(s_dd + rel * dsize + d1c, t_s * wd1);
          } else {
            float* drow = ddmap + (long long)pix * dsize;
            if (wd0 != 0.f) atomicAdd(drow + d0c, t_s * wd0);
            if (wd1 != 0.f) atomicAdd(drow + d1c, t_s * wd1);
          }
        }
        if (SAMPLE_GRADS) {
          const float t_b = t * a * s;  // gradient of the bilinear weight b
          g_a += t * b * s;
          g_lx += t_b * (dx ? by : -by);
          g_ly += t_b * (dy ? bx : -bx);
          g_ld += t_s * ((dv1 ? dp1 : 0.f) - (dv0 ? dp0 : 0.f));
        }
      }
      if (SAMPLE_GRADS && lane == 0) {
        float* dl = d_locs + (sid * p + pt) * 3;
        dl[0] = g_lx * w;
        dl[1] = g_ly * h;
        dl[2] = g_ld * dsize;
        d_attn[sid * p + pt] = g_a;
      }
    }
  }
  __syncthreads();

  if (staged) {  // one global atomic per nonzero accumulated element
    for (int i = threadIdx.x; i < span * kC; i += kThreads) {
      const float x = s_dv[i];
      if (x != 0.f) atomicAdd(dvmap + (long long)(base + i / kC) * cfull + (i % kC), x);
    }
    if (dgrad) {
      float* dd = ddmap + (long long)base * dsize;
      for (int i = threadIdx.x; i < span * dsize; i += kThreads) {
        const float x = s_dd[i];
        if (x != 0.f) atomicAdd(dd + i, x);
      }
    }
  }
}

template <typename VT, typename DT, bool SAMPLE_GRADS, bool DOT>
int launch(const void* value, const void* depth, const float* locs,
           const float* attn, const int* counts, const void* g, float* d_value,
           float* d_depth, float* d_locs, float* d_attn, int n, int h, int w,
           int heads, int dsize, int k, int p, int qc, int wwin,
           cudaStream_t stream) {
  const size_t per_pixel = kC * sizeof(float) + dsize * sizeof(float)
                           + (d_depth != nullptr ? dsize * sizeof(float) : 0)
                           + (DOT ? kC * sizeof(VT) : 0);
  const size_t smem = (size_t)wwin * per_pixel;
  auto kernel = dfa3d_win_bwd_kernel<VT, DT, SAMPLE_GRADS, DOT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, (k + qc - 1) / qc, n);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const VT*>(value), static_cast<const DT*>(depth), locs, attn,
      counts, static_cast<const VT*>(g), d_value, d_depth, d_locs, d_attn,
      h, w, heads, dsize, k, p, qc, wwin);
  return (int)cudaGetLastError();
}

template <typename VT, typename DT>
int launch_flags(const void* value, const void* depth, const float* locs,
                 const float* attn, const int* counts, const void* g,
                 float* d_value, float* d_depth, float* d_locs,
                 float* d_attn, int n, int h, int w, int heads, int dsize, int k,
                 int p, int qc, int wwin, cudaStream_t stream) {
  if (d_locs != nullptr)
    return launch<VT, DT, true, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, stream);
  if (d_depth != nullptr)
    return launch<VT, DT, false, true>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, stream);
  return launch<VT, DT, false, false>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, stream);
}

}  // namespace

// value (N, H, W, heads*32) of type vdtype, depth (N, H, W, dsize) of type
// ddtype, locs (N, K, heads, P, 3) and attn (N, K, heads, P) f32, counts
// (N,) int32 or null, g (N, K, heads*32) of type vdtype, chunks of qc
// queries, windows of at most wwin pixels -> d_value (f32, zeroed by the caller),
// d_depth (likewise, or null: not computed) and, where both pointers are
// non-null, d_locs and d_attn (f32, every element written).
extern "C" int sgc_dfa3d_win_bwd(int vdtype, int ddtype, const void* value,
                                 const void* depth, const float* locs,
                                 const float* attn, const int* counts,
                                 const void* g, float* d_value,
                                 float* d_depth, float* d_locs, float* d_attn,
                                 int n, int h, int w, int heads, int dsize,
                                 int k, int p, int qc, int wwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n * (long long)k == 0) return (int)cudaSuccess;
  if ((d_locs == nullptr) != (d_attn == nullptr) || qc <= 0 || wwin <= 0)
    return (int)cudaErrorInvalidValue;
  if (ddtype == sgc::kBFloat16) {
    if (vdtype != sgc::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch_flags<__nv_bfloat16, __nv_bfloat16>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
  }
  if (ddtype != sgc::kFloat32) return (int)cudaErrorInvalidValue;
  if (vdtype == sgc::kBFloat16)
    return launch_flags<__nv_bfloat16, float>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
  if (vdtype == sgc::kFloat32)
    return launch_flags<float, float>(value, depth, locs, attn, counts, g, d_value, d_depth, d_locs, d_attn, n, h, w, heads, dsize, k, p, qc, wwin, s);
  return (int)cudaErrorInvalidValue;
}
