// Row gather and row scatter-add, each direct or through a shared-memory
// window (counters `row_gather`, `row_scatter_add`): the Hopper
// counterparts of the TPU probes the windowed DFA3D kernels were built on.
//
// Replaces:
//   row_gather, out[i] = img[rows[i]]:
//     experiments/probe_window_lowering.py::_copy_kernel (single-row copies,
//     bf16 and f32), experiments/probe_window_matmul.py::_kernel (one-hot
//     window gather), experiments/probe_gather_batch.py::_kernel_single,
//     ::_kernel_g8 and ::_kernel_p4 (one row per copy, eight per store,
//     four points' rows), which differ only in how Mosaic batched the
//     copies: on this card they are one kernel timed at each width;
//     with the epilogue flag, probe_gather_batch.py::_kernel_p4_epi (the
//     gather of four points' quad rows followed by the DFA3D corner
//     epilogue, probe_gather_batch.py:104-126).
//   row_scatter_add, out[rows[i]] += u[i]:
//     probe_window_lowering.py::_scat_kernel (windowed S^T U accumulate)
//     and experiments/probe_f32_onehot.py::_kernel (f32 one-hot scatter into
//     one window).
//
// Design.  A block takes a chunk of cm consecutive rows of the output
// (gather) or of u (scatter) and a 256-byte column tile (the epilogue takes
// whole rows).  Direct: each thread moves 16 bytes (gather) or adds one f32
// by a global atomic (scatter).  Windowed: the plan (per chunk the lowest
// row its indices name and the span to the highest, or -1 where the span
// exceeds the window; sgcdet_tpu_torch/experiments/probes.py::plan_rows)
// lets the block stage the window's rows of its tile in shared memory with
// cp.async and gather from there, or sum u into an f32 window with shared
// atomics and add each nonzero element to global memory with one atomic.
// A chunk whose span exceeds the window runs the direct path.
//
// What bounds them on this card: bytes.  The gather writes every output
// row and reads each distinct source row (from L2 after its first reader);
// the scatter reads every u row and resolves its atomics in L2.  The window
// cuts the L2 transactions of repeated rows; whether that shows against
// L2's own rate is what these probes measure.
#include "common.cuh"

namespace {

constexpr int kTileBytes = 256;  // column tile of a block
constexpr int kThreads = 256;

// out[m, tile] = img[rows[m], tile] (EPI false; p = 1), or, with EPI (f32,
// whole rows of width l = 4 (c + D)), for every output row m:
//   out[m, :c] = sum_pt sum_j winfo[pt, m, j] * <row_j depth, dvec> * row_j value
//   out[m, c:] = 0,  row = img[rows[pt, m]], dvec = the lerp bins of winfo.
template <typename T, bool EPI>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const T* __restrict__ img, const int* __restrict__ rows,
    const float* __restrict__ winfo, const int* __restrict__ meta,
    T* __restrict__ out, int l, int m, int p, int cm, int c, int dsize) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte move
  const int row_bytes = l * (int)sizeof(T);
  const int col0 = EPI ? 0 : blockIdx.x * (kTileBytes / (int)sizeof(T));
  const int tile_vecs = EPI ? row_bytes / 16 : min(kTileBytes, row_bytes - col0 * (int)sizeof(T)) / 16;
  const int s_stride = EPI ? l : kTileBytes / (int)sizeof(T);  // smem row, elements
  const int chunk = blockIdx.y;
  const int m0 = chunk * cm, m1 = min(m, m0 + cm);
  const int base = meta == nullptr ? 0 : meta[2 * chunk];
  const int span = meta == nullptr ? -1 : meta[2 * chunk + 1];
  T* s = reinterpret_cast<T*>(smem);
  if (span > 0) {
    for (int i = threadIdx.x; i < span * tile_vecs; i += kThreads) {
      const int r = i / tile_vecs, v = i - r * tile_vecs;
      sgc::cp_async16(s + r * s_stride + v * kVec,
                      img + (long long)(base + r) * l + col0 + v * kVec);
    }
    sgc::cp_async_wait_all();
  }
  __syncthreads();
  // the source row's tile, from the window where it lies there
  auto src = [&](int row) -> const T* {
    const int rel = row - base;
    return (span > 0 && rel >= 0 && rel < span) ? s + rel * s_stride
                                                : img + (long long)row * l + col0;
  };
  if constexpr (!EPI) {
    for (int i = threadIdx.x; i < (m1 - m0) * tile_vecs; i += kThreads) {
      const int mi = i / tile_vecs, v = i - mi * tile_vecs;
      const uint4 x = reinterpret_cast<const uint4*>(src(rows[m0 + mi]))[v];
      reinterpret_cast<uint4*>(out + (long long)(m0 + mi) * l + col0)[v] = x;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int mi = m0 + warp; mi < m1; mi += kThreads / 32) {
      float* orow = reinterpret_cast<float*>(out) + (long long)mi * l;
      for (int ch = lane; ch < c; ch += 32) {
        float acc = 0.f;
        for (int pt = 0; pt < p; ++pt) {
          const long long sm = (long long)pt * m + mi;
          const float* row = reinterpret_cast<const float*>(src(rows[sm]));
          const float* wi = winfo + sm * 8;
          const int d0 = (int)wi[6], d1 = (int)wi[7];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* dj = row + 4 * c + j * dsize;
            const float ds = (d0 >= 0 && d0 < dsize ? dj[d0] * wi[4] : 0.f)
                             + (d1 >= 0 && d1 < dsize ? dj[d1] * wi[5] : 0.f);
            acc += (wi[j] * ds) * row[j * c + ch];
          }
        }
        orow[ch] = acc;
      }
      for (int ch = c + lane; ch < l; ch += 32) orow[ch] = 0.f;
    }
  }
}

// out[rows[i], tile] += u[i, tile], f32; out zeroed by the caller.
__global__ void __launch_bounds__(kThreads) row_scatter_add_kernel(
    const float* __restrict__ u, const int* __restrict__ rows,
    const int* __restrict__ meta, float* __restrict__ out, int l, int m, int cm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTile = kTileBytes / 4;
  const int col0 = blockIdx.x * kTile;
  const int tile = min(kTile, l - col0);
  const int chunk = blockIdx.y;
  const int m0 = chunk * cm, m1 = min(m, m0 + cm);
  const int base = meta == nullptr ? 0 : meta[2 * chunk];
  const int span = meta == nullptr ? -1 : meta[2 * chunk + 1];
  float* s = reinterpret_cast<float*>(smem);  // [span][kTile]
  const bool win = span > 0;
  if (win) {
    for (int i = threadIdx.x; i < span * kTile; i += kThreads) s[i] = 0.f;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < (m1 - m0) * tile; i += kThreads) {
    const int mi = i / tile, col = i - mi * tile;
    const int row = rows[m0 + mi];
    const float x = u[(long long)(m0 + mi) * l + col0 + col];
    const int rel = row - base;
    if (win && rel >= 0 && rel < span) atomicAdd(s + rel * kTile + col, x);
    else atomicAdd(out + (long long)row * l + col0 + col, x);
  }
  if (win) {
    __syncthreads();
    for (int i = threadIdx.x; i < span * tile; i += kThreads) {
      const int r = i / tile, col = i - r * tile;
      const float x = s[r * kTile + col];
      if (x != 0.f) atomicAdd(out + (long long)(base + r) * l + col0 + col, x);
    }
  }
}

template <typename T, bool EPI>
int launch_gather(const void* img, const int* rows, const float* winfo,
                  const int* meta, void* out, int l, int m, int p, int cm,
                  int wwin, int c, int dsize, cudaStream_t stream) {
  const int row_bytes = l * (int)sizeof(T);
  const size_t smem = meta == nullptr ? 0 : (size_t)wwin * (EPI ? row_bytes : kTileBytes);
  auto kernel = row_gather_kernel<T, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(EPI ? 1 : (row_bytes + kTileBytes - 1) / kTileBytes, (m + cm - 1) / cm);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(img), rows,
                                           winfo, meta, static_cast<T*>(out),
                                           l, m, p, cm, c, dsize);
  return (int)cudaGetLastError();
}

}  // namespace

// img (R, L) of type dtype with L * sizeof(dtype) a multiple of 16; rows
// (P, M) int32 in [0, R); winfo null (copy: P = 1, out (M, L) of type dtype)
// or (P, M, 8) f32 (epilogue: f32 only, quad rows of c value and dsize
// depth lanes per corner, L = 4 (c + dsize), out (M, L) f32); meta null
// (direct) or (ceil(M / cm), 2) int32 [base, span or -1] with span <= wwin.
extern "C" int sgc_row_gather(int dtype, const void* img, const int* rows,
                              const float* winfo, const int* meta, void* out,
                              int l, int m, int p, int cm, int wwin, int c,
                              int dsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaSuccess;
  if (cm <= 0 || (meta != nullptr && wwin <= 0)) return (int)cudaErrorInvalidValue;
  if (winfo != nullptr) {
    if (dtype != sgc::kFloat32 || 4 * (c + dsize) != l) return (int)cudaErrorInvalidValue;
    return launch_gather<float, true>(img, rows, winfo, meta, out, l, m, p, cm, wwin, c, dsize, s);
  }
  if (p != 1) return (int)cudaErrorInvalidValue;
  if (dtype == sgc::kBFloat16)
    return launch_gather<__nv_bfloat16, false>(img, rows, winfo, meta, out, l, m, p, cm, wwin, c, dsize, s);
  if (dtype == sgc::kFloat32)
    return launch_gather<float, false>(img, rows, winfo, meta, out, l, m, p, cm, wwin, c, dsize, s);
  return (int)cudaErrorInvalidValue;
}

// u (M, L) f32, rows (M,) int32 in [0, R), meta as for the gather ->
// out (R, L) f32, zeroed by the caller.
extern "C" int sgc_row_scatter_add(const float* u, const int* rows,
                                   const int* meta, float* out, int l, int m,
                                   int cm, int wwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaSuccess;
  if (cm <= 0 || (meta != nullptr && wwin <= 0)) return (int)cudaErrorInvalidValue;
  const size_t smem = meta == nullptr ? 0 : (size_t)wwin * kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(
      row_scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + kTileBytes / 4 - 1) / (kTileBytes / 4), (m + cm - 1) / cm);
  row_scatter_add_kernel<<<grid, kThreads, smem, s>>>(u, rows, meta, out, l, m, cm);
  return (int)cudaGetLastError();
}
