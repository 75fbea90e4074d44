// The frozen BatchNorm epilogue of ResNet-50, forward and backward
// (`frozen_bn`).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the frozen BN's affine,
// the residual add and the ReLU into the convolution's epilogue
// (sgcdet_tpu/models/layers.py:229-232 computes the BN in f32 from the
// running statistics and casts the result back).  On this card cuDNN runs
// the convolution, and the same arithmetic as separate PyTorch ops (an f32
// copy of x, the batch_norm, the cast back, the add, the ReLU, each a pass
// over device memory, and the copy kept for the backward) took most of the
// backbone's time.  This kernel is the whole epilogue in one pass over
// channels-last memory:
//
//   y = relu(f32(x) * scale[c] + shift[c] (+ f32(identity)))    in x's type
//   scale = weight * 1 / sqrt(running_var + eps),  shift = bias - running_mean * scale
//
// and its backward, with g' = g * (y > 0) where the ReLU applies:
//
//   dx = g' * scale,  d_identity = g',  d_bias = sum g',
//   d_weight = 1 / sqrt(running_var + eps) * sum g' * (x - running_mean)
//
// the sums in f32 over every row, deterministic: each block sums its rows
// in a fixed order and writes one partial row per block, and a second
// kernel sums the blocks' partials in a fixed order (no atomics), so two
// runs give the same bits.
//
// What bounds it on this card: device memory.  It does a few flops a byte,
// so the least time is the bytes over 3.35 TB/s: x, the identity and y
// once (forward: 6 bytes an element in bf16 with the identity); g, x, y,
// dx and d_identity once (backward: 10).
//
// Design: x is (rows, C) with C innermost (channels-last NCHW is row-major
// NHWC).  A thread owns VEC = 8 channels of one row at a time (16 bytes in
// bf16, 32 in f32): C / 8 lanes cover a row, a block of at most 256
// threads covers 256 / (C / 8) rows, and the grid strides over the rows.
// A thread's channels never change, so it computes their scale and shift
// (and, backward, sums their gradients) in registers once.  The forward
// loads two rows before it stores either, so more bytes are in flight.
// The backward's block folds its row slots in shared memory, in order.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int VEC = 8;          // channels a thread
constexpr int THREADS = 256;    // at most, a block
constexpr int SUM_COLS = 32;    // partial columns a block of the sum pass
constexpr int SUM_SLICES = 8;   // ... and the slices of blocks it splits them in

// scale and shift of channels c0 .. c0 + VEC, in f32
__device__ __forceinline__ void affine(const float* weight, const float* bias,
                                       const float* mean, const float* var, float eps,
                                       int c0, float (&scale)[VEC], float (&shift)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float inv = 1.f / sqrtf(var[c0 + j] + eps);
    scale[j] = weight[c0 + j] * inv;
    shift[j] = bias[c0 + j] - mean[c0 + j] * scale[j];
  }
}

// ReLU as torch's: 0 for x <= 0 (and -0), NaN kept
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

template <typename T, bool IDENTITY, bool RELU>
__global__ void __launch_bounds__(THREADS) frozen_bn_fwd_kernel(
    const T* __restrict__ x,          // (m, c)
    const T* __restrict__ identity,   // (m, c) where IDENTITY
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    T* __restrict__ y,                // (m, c)
    long long m, int c) {
  const int lanes = c / VEC, rows = blockDim.x / lanes;
  const int c0 = (threadIdx.x % lanes) * VEC;
  float scale[VEC], shift[VEC];
  affine(weight, bias, mean, var, eps, c0, scale, shift);
  const long long step = (long long)gridDim.x * rows;
  for (long long r = (long long)blockIdx.x * rows + threadIdx.x / lanes; r < m; r += 2 * step) {
    const bool two = r + step < m;
    const long long off[2] = {r * c + c0, (r + step) * c + c0};
    float v[2][VEC], id[2][VEC];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
      sgc::load_f32<T, VEC>(x + off[k], v[k]);
      if constexpr (IDENTITY) sgc::load_f32<T, VEC>(identity + off[k], id[k]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float t = v[k][j] * scale[j] + shift[j];
        if constexpr (IDENTITY) t += id[k][j];
        v[k][j] = RELU ? relu(t) : t;
      }
      sgc::store_from_f32<T, VEC>(y + off[k], v[k]);
    }
  }
}

template <typename T, bool RELU, bool D_IDENTITY>
__global__ void __launch_bounds__(THREADS) frozen_bn_bwd_kernel(
    const T* __restrict__ g,          // (m, c) gradient of y
    const T* __restrict__ x,          // (m, c)
    const T* __restrict__ y,          // (m, c) where RELU
    const float* __restrict__ weight, const float* __restrict__ mean,
    const float* __restrict__ var, float eps,
    T* __restrict__ dx,               // (m, c)
    T* __restrict__ d_identity,       // (m, c) where D_IDENTITY
    float* __restrict__ partial,      // (gridDim.x, 2, c): sum g', sum g' (x - mean)
    long long m, int c) {
  __shared__ float s_sum[2 * THREADS * VEC];
  const int lanes = c / VEC, rows = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes, c0 = (threadIdx.x % lanes) * VEC;
  float scale[VEC], mu[VEC], sg[VEC], sgx[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    scale[j] = weight[c0 + j] * (1.f / sqrtf(var[c0 + j] + eps));
    mu[j] = mean[c0 + j];
    sg[j] = 0.f;
    sgx[j] = 0.f;
  }
  const long long step = (long long)gridDim.x * rows;
  for (long long r = (long long)blockIdx.x * rows + slot; r < m; r += step) {
    const long long off = r * c + c0;
    float gv[VEC], xv[VEC];
    sgc::load_f32<T, VEC>(g + off, gv);
    sgc::load_f32<T, VEC>(x + off, xv);
    if constexpr (RELU) {
      float yv[VEC];
      sgc::load_f32<T, VEC>(y + off, yv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) gv[j] = yv[j] <= 0.f ? 0.f : gv[j];  // torch's mask
    }
    float d[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      d[j] = gv[j] * scale[j];
      sg[j] += gv[j];
      sgx[j] += gv[j] * (xv[j] - mu[j]);
    }
    sgc::store_from_f32<T, VEC>(dx + off, d);
    if constexpr (D_IDENTITY) sgc::store_from_f32<T, VEC>(d_identity + off, gv);
  }
  // fold the block's row slots, slot by slot in order
  float* s_g = s_sum;
  float* s_gx = s_sum + rows * c;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s_g[slot * c + c0 + j] = sg[j];
    s_gx[slot * c + c0 + j] = sgx[j];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * c; o += blockDim.x) {
    const float* col = o < c ? s_g + o : s_gx + (o - c);
    float t = 0.f;
    for (int k = 0; k < rows; ++k) t += col[k * c];
    partial[(long long)blockIdx.x * 2 * c + o] = t;
  }
}

// The blocks' partials summed, each column by SUM_SLICES slices of blocks
// in order and the slices in order: d_bias and d_weight.
__global__ void __launch_bounds__(SUM_COLS * SUM_SLICES) frozen_bn_bwd_sum_kernel(
    const float* __restrict__ partial, int blocks, const float* __restrict__ var, float eps,
    float* __restrict__ d_weight, float* __restrict__ d_bias, int c) {
  __shared__ float s[SUM_SLICES][SUM_COLS];
  const int col = threadIdx.x % SUM_COLS, slice = threadIdx.x / SUM_COLS;
  const int o = blockIdx.x * SUM_COLS + col;
  float t = 0.f;
  if (o < 2 * c) {
#pragma unroll 8
    for (int b = slice; b < blocks; b += SUM_SLICES) t += partial[(long long)b * 2 * c + o];
  }
  s[slice][col] = t;
  __syncthreads();
  if (slice != 0 || o >= 2 * c) return;
#pragma unroll
  for (int k = 1; k < SUM_SLICES; ++k) t += s[k][col];
  if (o < c) {
    d_bias[o] = t;
  } else {
    d_weight[o - c] = t * (1.f / sqrtf(var[o - c] + eps));
  }
}

// f(T{}) at the value type of the dtype code
template <typename F>
int with_type(int dtype, F&& f) {
  if (dtype == sgc::kBFloat16) return f(__nv_bfloat16{});
  if (dtype == sgc::kFloat32) return f(float{});
  return (int)cudaErrorInvalidValue;
}

// f(std::bool_constant<b>{})
template <typename F>
int with_flag(bool b, F&& f) {
  return b ? f(std::true_type{}) : f(std::false_type{});
}

// the block of a row of c channels: c / VEC lanes times the rows that fit
// THREADS; 0 where c is not a multiple of VEC or wider than THREADS lanes
int block_threads(int c) {
  if (c <= 0 || c % VEC || c / VEC > THREADS) return 0;
  return c / VEC * (THREADS / (c / VEC));
}

}  // namespace

// y = relu(x * scale + shift (+ identity)) over (m, c) rows; identity may be
// null; blocks of the grid chosen by the wrapper (ops/frozen_bn.py::grid).
extern "C" int sgc_frozen_bn_fwd(int dtype, const void* x, const void* identity,
                                 const float* weight, const float* bias, const float* mean,
                                 const float* var, float eps, int relu, void* y,
                                 long long m, int c, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(c);
  if (threads == 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  return with_type(dtype, [&](auto t) {
    using T = decltype(t);
    return with_flag(identity != nullptr, [&](auto has_identity) {
      return with_flag(relu != 0, [&](auto has_relu) {
        frozen_bn_fwd_kernel<T, decltype(has_identity)::value, decltype(has_relu)::value>
            <<<blocks, threads, 0, s>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(identity), weight, bias, mean,
                                        var, eps, static_cast<T*>(y), m, c);
        return (int)cudaGetLastError();
      });
    });
  });
}

// dx (and d_identity where not null: relu only), d_weight and d_bias of the
// forward above for the gradient g of y; partial holds (blocks, 2, c) f32.
extern "C" int sgc_frozen_bn_bwd(int dtype, const void* g, const void* x, const void* y,
                                 const float* weight, const float* mean, const float* var,
                                 float eps, int relu, void* dx, void* d_identity,
                                 float* partial, float* d_weight, float* d_bias,
                                 long long m, int c, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = block_threads(c);
  if (threads == 0 || blocks <= 0 || (d_identity != nullptr && !relu))
    return (int)cudaErrorInvalidValue;
  const int err = with_type(dtype, [&](auto t) {
    using T = decltype(t);
    return with_flag(relu != 0, [&](auto has_relu) {
      return with_flag(d_identity != nullptr, [&](auto has_d_identity) {
        frozen_bn_bwd_kernel<T, decltype(has_relu)::value, decltype(has_d_identity)::value>
            <<<blocks, threads, 0, s>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                        static_cast<const T*>(y), weight, mean, var, eps,
                                        static_cast<T*>(dx), static_cast<T*>(d_identity),
                                        partial, m, c);
        return (int)cudaGetLastError();
      });
    });
  });
  if (err != (int)cudaSuccess) return err;
  frozen_bn_bwd_sum_kernel<<<(2 * c + SUM_COLS - 1) / SUM_COLS, SUM_COLS * SUM_SLICES, 0, s>>>(
      partial, blocks, var, eps, d_weight, d_bias, c);
  return (int)cudaGetLastError();
}
