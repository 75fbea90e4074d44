// Row gather and row scatter-add, each direct or through a window
// (counters `row_gather`, `row_scatter_add`): the Hopper counterparts of
// the TPU probes the windowed DFA3D kernels were built on.
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
// Indices are read at the caller's type (int32 or int64).  The window plan
// of a chunk of cm consecutive indices (its lowest row and the span to the
// highest, sgcdet_tpu_torch/experiments/probes.py::plan_rows) is computed
// by the kernels themselves; a chunk whose span exceeds the window takes
// the direct path.
//
// Gather.  A block takes 64 output rows (direct), 128 (windowed) or a
// whole chunk (with the epilogue) and a 256-byte column tile (the epilogue
// whole rows); each thread moves 16 bytes.  Windowed, the block reduces its
// chunk's indices to the plan and, where the chunk spans at most the
// window and kStageRows rows, stages that span of its tile in shared
// memory with cp.async and gathers from there: shared memory is reserved
// for the rows a block stages (24 KB a block), not for the window, so the
// window no longer sets the occupancy (blocks that also staged the next
// chunk while storing this one, two stages a block, ran 1.3x slower: fewer
// blocks fit an SM).  What bounds it: the bytes written; the source rows
// come from L2.
//
// Scatter.  Up to three kernels: the plan, where one block cannot hold
// every index; the sum where the output lives (each block owns 8 output
// rows x 128 columns, finds the indices of the windowed chunks that name
// its rows by warp ballots, and adds their u rows in index order by
// 16-byte loads, so every output element is stored once, rows no index
// names as zeros, and the result is the same from run to run); then the
// direct chunks (all of them without a window), added by 16-byte vector
// reductions.  The kernels after the first start while the one ahead
// ends (programmatic dependent launch).  What bounds it: the bytes of u,
// read once.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kTileBytes = 256;    // column tile of a gather block
constexpr int kThreads = 256;
constexpr int kStageRows = 96;     // most rows of a column tile a windowed gather stages
constexpr int kWindowBlockRows = 128;  // output rows of a windowed gather block
constexpr int kDirectBlockRows = 64;   // and of a direct one
constexpr int kScatterRows = 8;    // output rows of a scatter block, one a warp
constexpr int kScatterTile = 2048; // indices a scatter block scans at a time
constexpr int kScatterList = 64;   // matches a warp holds before it adds them
constexpr int kBatch = 8;          // u rows a warp loads together

// The lowest and the highest of at(0..n).  Every thread of the block calls
// it; s_box is two shared ints.
template <typename F>
__device__ __forceinline__ int2 chunk_bounds(int n, F at, int* s_box) {
  if (threadIdx.x == 0) {
    s_box[0] = INT_MAX;
    s_box[1] = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = at(i);
    lo = min(lo, r);
    hi = max(hi, r);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(s_box, lo);
    atomicMax(s_box + 1, hi);
  }
  __syncthreads();
  return make_int2(s_box[0], s_box[1]);
}

// out[m, tile] = img[rows[m], tile] (EPI false; p = 1), or, with EPI (f32,
// whole rows of width l = 4 (c + D)), for every output row m:
//   out[m, :c] = sum_pt sum_j winfo[pt, m, j] * <row_j depth, dvec> * row_j value
//   out[m, c:] = 0,  row = img[rows[pt, m]], dvec = the lerp bins of winfo.
// wwin > 0: a chunk spanning at most wwin rows is staged in shared memory.
template <typename T, typename I, bool EPI>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const T* __restrict__ img, const I* __restrict__ rows,
    const float* __restrict__ winfo, T* __restrict__ out, int l, int m, int p,
    int cm, int br, int wwin, int c, int dsize) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_box[2];
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte move
  const int row_bytes = l * (int)sizeof(T);
  const int col0 = EPI ? 0 : blockIdx.x * (kTileBytes / (int)sizeof(T));
  const int tile_vecs = EPI ? row_bytes / 16 : min(kTileBytes, row_bytes - col0 * (int)sizeof(T)) / 16;
  const int s_stride = EPI ? l : kTileBytes / (int)sizeof(T);  // smem row, elements
  // the block's br output rows of its chunk (blocks along y, then z)
  const int parts = (cm + br - 1) / br;
  const int blk = blockIdx.z * gridDim.y + blockIdx.y;
  if (blk >= (m + cm - 1) / cm * parts) return;
  const int chunk = blk / parts, c0 = chunk * cm, c1 = min(m, c0 + cm);
  const int m0 = c0 + (blk - chunk * parts) * br, m1 = min(c1, m0 + br);
  int base = 0, span = -1;
  if (wwin > 0) {  // the chunk's plan, over all p rows of it
    const int n = c1 - c0;
    const int2 b = chunk_bounds(
        p * n, [&](int i) { const int pt = i / n; return (int)rows[(long long)pt * m + c0 + i - pt * n]; },
        s_box);
    base = b.x;
    span = b.y - b.x + 1 <= wwin ? b.y - b.x + 1 : -1;
  }
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
      const uint4 x = reinterpret_cast<const uint4*>(src((int)rows[m0 + mi]))[v];
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
          const float* row = reinterpret_cast<const float*>(src((int)rows[sm]));
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

// meta[ch] = {lowest row, span} of chunk ch's indices, span -1 where it
// exceeds wwin.
template <typename I>
__global__ void __launch_bounds__(kThreads) scatter_plan_kernel(
    const I* __restrict__ rows, int* __restrict__ meta, int m, int cm, int wwin) {
  __shared__ int s_box[2];
  sgc::launch_dependents();
  const int m0 = blockIdx.x * cm, n = min(cm, m - m0);
  const I* r = rows + m0;
  const int2 b = chunk_bounds(n, [&](int i) { return (int)r[i]; }, s_box);
  if (threadIdx.x == 0) {
    const int span = b.y - b.x + 1;
    meta[2 * blockIdx.x] = b.x;
    meta[2 * blockIdx.x + 1] = span <= wwin ? span : -1;
  }
}

// out[row, cols] for kScatterRows rows (a warp each) x 32 float4 columns
// (a lane each): the sum, in index order, of u[i, cols] over the indices i
// of the windowed chunks with rows[i] == row; zeros where there is none.
// Each element is stored once.  The windowed chunks: none where wwin is 0
// (direct); where meta is null (at most kScatterTile indices in at most
// kThreads chunks), found by the block from all the indices it holds;
// else read from meta (scatter_plan_kernel, ahead in the stream).
template <typename I>
__global__ void __launch_bounds__(kThreads) scatter_owner_kernel(
    const float* __restrict__ u, const I* __restrict__ rows, const int* __restrict__ meta,
    float* __restrict__ out, int l4, int m, int n_rows, int cm, int wwin) {
  __shared__ int s_row[kScatterTile];               // the tile's indices
  __shared__ int s_sel[kThreads];                   // chunks of a group that touch the block's rows
  __shared__ int s_hi[kThreads];                    // (one tile: each chunk's highest row)
  __shared__ int s_list[kScatterRows][kScatterList];  // a warp's matches (u rows), in order
  __shared__ int s_count[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kScatterRows, r1 = min(n_rows, r0 + kScatterRows);
  const int row = r0 + warp;
  const int col = blockIdx.y * 32 + lane;  // float4 column
  const bool live = row < n_rows && col < l4;
  const float4* u4 = reinterpret_cast<const float4*>(u);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int pending = 0;  // warp-uniform
  auto flush = [&]() {
    __syncwarp();
    for (int q = 0; q < pending; q += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (live && q + j < pending) x[j] = u4[(long long)s_list[warp][q + j] * l4 + col];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (live && q + j < pending) {
          acc.x += x[j].x;
          acc.y += x[j].y;
          acc.z += x[j].z;
          acc.w += x[j].w;
        }
    }
    pending = 0;
    __syncwarp();
  };
  // a warp's matches among tile positions [0, n): position k holds s_row[k]
  // and names u row at(k) where ok(k)
  auto scan = [&](int n, auto at, auto ok) {
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int k = k0 + lane;
      const bool match = k < n && s_row[k] == r0 + warp && ok(k);
      const unsigned mm = __ballot_sync(0xffffffffu, match);
      if (mm == 0) continue;
      if (pending + 32 > kScatterList) flush();
      if (match) s_list[warp][pending + __popc(mm & ((1u << lane) - 1))] = at(k);
      pending += __popc(mm);
    }
  };
  constexpr int kPer = kScatterTile / kThreads;  // tile positions a thread loads
  if (wwin > 0 && meta == nullptr) {  // every index in one tile; the plan from it
    const int nchunks = (m + cm - 1) / cm;
    if (threadIdx.x < nchunks) {
      s_sel[threadIdx.x] = INT_MAX;
      s_hi[threadIdx.x] = -1;
    }
    int v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kThreads;
      v[j] = k < m ? (int)rows[k] : -1;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < m) s_row[k] = v[j];
      if (cm % 32 == 0) {  // a warp's 32 positions lie in one chunk
        const int lo = __reduce_min_sync(0xffffffffu, k < m ? v[j] : INT_MAX);
        const int hi = __reduce_max_sync(0xffffffffu, v[j]);
        if (lane == 0 && k < m) {
          atomicMin(s_sel + k / cm, lo);
          atomicMax(s_hi + k / cm, hi);
        }
      } else if (k < m) {
        atomicMin(s_sel + k / cm, v[j]);
        atomicMax(s_hi + k / cm, v[j]);
      }
    }
    __syncthreads();
    scan(m, [](int k) { return k; },
         [&](int k) { const int ch = k / cm; return s_hi[ch] - s_sel[ch] + 1 <= wwin; });
    flush();
  } else if (wwin > 0) {
    sgc::wait_for_prerequisite();  // meta
    const int nchunks = (m + cm - 1) / cm;
    const int per_tile = kScatterTile / cm;  // whole chunks a tile holds
    for (int g = 0; g < nchunks; g += kThreads) {
      // this group's windowed chunks whose window meets [r0, r1), in order
      const int ch = g + threadIdx.x;
      bool hit = false;
      if (ch < nchunks) {
        const int base = meta[2 * ch], span = meta[2 * ch + 1];
        hit = span > 0 && base < r1 && base + span > r0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_count[warp] = __popc(mask);
      __syncthreads();
      int before = 0, nsel = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? s_count[w] : 0;
        nsel += s_count[w];
      }
      if (hit) s_sel[before + __popc(mask & ((1u << lane) - 1))] = ch;
      __syncthreads();
      for (int q0 = 0; q0 < nsel; q0 += per_tile) {
        const int n = min(per_tile, nsel - q0) * cm;  // tile positions
        int v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int k = threadIdx.x + j * kThreads, q = k / cm;
          const long long i = k < n ? (long long)s_sel[q0 + q] * cm + (k - q * cm) : m;
          v[j] = i < m ? (int)rows[i] : -1;  // past the ragged last chunk: no row
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int k = threadIdx.x + j * kThreads;
          if (k < n) s_row[k] = v[j];
        }
        __syncthreads();
        scan(n, [&](int k) { const int q = k / cm; return s_sel[q0 + q] * cm + k - q * cm; },
             [](int) { return true; });
        __syncthreads();  // s_row and s_sel are rewritten next
      }
    }
    flush();
  }
  if (live) reinterpret_cast<float4*>(out)[(long long)row * l4 + col] = acc;
  sgc::launch_dependents();
}

// out[rows[i]] += u[i] for the indices of the direct chunks (every chunk
// where wwin is 0; else those spanning more than wwin rows), by 16-byte
// vector reductions.  Launched behind scatter_owner_kernel, which stores
// every element of out first.
template <typename I>
__global__ void __launch_bounds__(kThreads) scatter_direct_kernel(
    const float* __restrict__ u, const I* __restrict__ rows, float* __restrict__ out,
    int l4, int m, int cm, int wwin) {
  __shared__ int s_box[2];
  const int m0 = blockIdx.x * cm, n = min(cm, m - m0);
  const I* r = rows + m0;
  if (wwin > 0) {
    const int2 b = chunk_bounds(n, [&](int i) { return (int)r[i]; }, s_box);
    if (b.y - b.x + 1 <= wwin) return;  // summed by scatter_owner_kernel
  }
  sgc::wait_for_prerequisite();  // out stored
  const float4* u4 = reinterpret_cast<const float4*>(u);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int e = threadIdx.x; e < n * l4; e += kThreads) {
    const int i = e / l4, v = e - i * l4;
    atomicAdd(o4 + (long long)r[i] * l4 + v, u4[(long long)(m0 + i) * l4 + v]);
  }
}

// Launch kernel on grid x kThreads in stream s, allowed to start before
// the kernel ahead of it ends where `early` (it then waits in
// wait_for_prerequisite).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t s, bool early,
                   Args... args) {
  return sgc::launch_kernel(kernel, grid, dim3(kThreads), 0, s, early, args...);
}

template <typename T, typename I, bool EPI>
int launch_gather(const void* img, const void* rows, const float* winfo, void* out,
                  int l, int m, int p, int cm, int wwin, int c, int dsize,
                  cudaStream_t stream) {
  const int row_bytes = l * (int)sizeof(T);
  const int tiles = EPI ? 1 : (row_bytes + kTileBytes - 1) / kTileBytes;
  const int nchunks = (m + cm - 1) / cm;
  if (!EPI && wwin > 0) wwin = min(wwin, kStageRows);
  const size_t smem = wwin > 0 ? (size_t)wwin * (EPI ? row_bytes : kTileBytes) : 0;
  const int br = EPI ? cm : min(cm, wwin > 0 ? kWindowBlockRows : kDirectBlockRows);
  auto kernel = row_gather_kernel<T, I, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = nchunks * ((cm + br - 1) / br), max_y = 65535;
  const dim3 grid(tiles, min(blocks, max_y), (blocks + max_y - 1) / max_y);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const I*>(rows), winfo,
      static_cast<T*>(out), l, m, p, cm, br, wwin, c, dsize);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch_gather(int dtype, const void* img, const void* rows, const float* winfo,
                    void* out, int l, int m, int p, int cm, int wwin, int c, int dsize,
                    cudaStream_t s) {
  if (winfo != nullptr) {
    if (dtype != sgc::kFloat32 || 4 * (c + dsize) != l) return (int)cudaErrorInvalidValue;
    return launch_gather<float, I, true>(img, rows, winfo, out, l, m, p, cm, wwin, c, dsize, s);
  }
  if (p != 1) return (int)cudaErrorInvalidValue;
  if (dtype == sgc::kBFloat16)
    return launch_gather<__nv_bfloat16, I, false>(img, rows, winfo, out, l, m, p, cm, wwin, c, dsize, s);
  if (dtype == sgc::kFloat32)
    return launch_gather<float, I, false>(img, rows, winfo, out, l, m, p, cm, wwin, c, dsize, s);
  return (int)cudaErrorInvalidValue;
}

template <typename I>
int launch_scatter(const float* u, const void* rows_v, int* meta, float* out, int l4,
                   int m, int n_rows, int cm, int wwin, cudaStream_t s) {
  const I* rows = static_cast<const I*>(rows_v);
  const int nchunks = (m + cm - 1) / cm;
  // the plan ahead of the owners where one block cannot hold every index
  const bool plan = wwin > 0 && (m > kScatterTile || nchunks > kThreads);
  cudaError_t err = cudaSuccess;
  if (plan) {
    scatter_plan_kernel<I><<<nchunks, kThreads, 0, s>>>(rows, meta, m, cm, wwin);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_rows + kScatterRows - 1) / kScatterRows, (l4 + 31) / 32);
  err = launch(scatter_owner_kernel<I>, grid, s, plan, u, rows,
               static_cast<const int*>(plan ? meta : nullptr), out, l4, m, n_rows, cm, wwin);
  if (err != cudaSuccess || m == 0) return (int)err;
  return (int)launch(scatter_direct_kernel<I>, dim3(nchunks), s, true, u, rows, out, l4, m,
                     cm, wwin);
}

}  // namespace

// img (R, L) of type dtype with L * sizeof(dtype) a multiple of 16; rows
// (P, M) int32 (idx64 0) or int64 (idx64 1) in [0, R); winfo null (copy:
// P = 1, out (M, L) of type dtype) or (P, M, 8) f32 (epilogue: f32 only,
// quad rows of c value and dsize depth lanes per corner, L = 4 (c +
// dsize), out (M, L) f32); wwin 0 (direct) or the most rows a chunk of cm
// indices may span to be served from shared memory.
extern "C" int sgc_row_gather(int dtype, const void* img, const void* rows, int idx64,
                              const float* winfo, void* out, int l, int m, int p,
                              int cm, int wwin, int c, int dsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaSuccess;
  if (cm <= 0 || wwin < 0) return (int)cudaErrorInvalidValue;
  return idx64 ? dispatch_gather<long long>(dtype, img, rows, winfo, out, l, m, p, cm, wwin, c, dsize, s)
               : dispatch_gather<int>(dtype, img, rows, winfo, out, l, m, p, cm, wwin, c, dsize, s);
}

// u (M, L) f32 with L a multiple of 4, rows (M,) int32 (idx64 0) or int64
// (idx64 1) in [0, R) -> out (R, L) f32, every element written (no zeroing
// by the caller); wwin 0 (direct) or the most rows a chunk of cm <= 2048
// indices may span to be summed where the output lives, with meta
// (ceil(M / cm), 2) int32 scratch for the plan.
extern "C" int sgc_row_scatter_add(const float* u, const void* rows, int idx64, int* meta,
                                   float* out, int l, int m, int n_rows, int cm, int wwin,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows == 0 || l == 0) return (int)cudaSuccess;
  if (l % 4 || cm <= 0 || wwin < 0 || (wwin > 0 && (meta == nullptr || cm > kScatterTile)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) wwin = 0;
  return idx64 ? launch_scatter<long long>(u, rows, meta, out, l / 4, m, n_rows, cm, wwin, s)
               : launch_scatter<int>(u, rows, meta, out, l / 4, m, n_rows, cm, wwin, s);
}
