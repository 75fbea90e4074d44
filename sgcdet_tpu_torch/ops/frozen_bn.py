"""A frozen BatchNorm with its residual add and ReLU as one op: ResNet-50's
conv epilogue (csrc/frozen_bn.cu; replaces no TPU kernel, where XLA fuses
the same arithmetic into the convolution).

    y = relu(bn(x) (+ identity))

with the BN normalising by its running statistics, in f32, and the result
in x's dtype (sgcdet_tpu/models/layers.py:229-232).

* ``frozen_bn_plain`` — the plain version: exactly the sequence the model
  ran before the kernel (``F.batch_norm`` on ``x.float()``, the cast back,
  the add, the ReLU), so on the CPU the numerics are those of the JAX
  package's port bit for bit; its backward is autograd's.
* ``frozen_bn_fwd_cuda`` / ``frozen_bn_bwd_cuda`` — the kernels on CUDA
  tensors in channels-last memory: the forward rounds once (``bf16(relu(x
  * scale + shift + identity))``, within one ulp of the plain version's two
  roundings); the backward computes dx, d_identity and the affine's
  gradients, the sums in a fixed order.
* ``frozen_bn`` — the differentiable op: a ``torch.autograd.Function``
  whose forward and backward are the kernels for CUDA tensors, and the
  plain version and its autograd for CPU tensors or under ``plain_ops()``.
  It saves x and y (y is the next conv's input anyway) and no f32 copy.
  The BN's weight and bias get gradients (the clip norm reads them) though
  the optimizer leaves them fixed.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import tracing
from ._cuda import DTYPE_CODE, Kernel, use_kernel

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# sgc_frozen_bn_fwd(dtype, x, identity, weight, bias, mean, var, eps, relu, y,
#                   m, c, blocks, stream)
FROZEN_BN_FWD = Kernel("sgc_frozen_bn_fwd",
                       [_I, _P, _P, _P, _P, _P, _P, _F, _I, _P, _L, _I, _I])
# sgc_frozen_bn_bwd(dtype, g, x, y, weight, mean, var, eps, relu, dx,
#                   d_identity, partial, d_weight, d_bias, m, c, blocks, stream)
FROZEN_BN_BWD = Kernel("sgc_frozen_bn_bwd",
                       [_I, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P, _L, _I, _I])

VEC = 8          # channels a thread (csrc/frozen_bn.cu)
THREADS = 256    # threads a block, at most
# blocks an SM of the grids: the forward's threads compute their channels'
# scale and shift once and stride over rows; the backward's blocks each
# write a partial row of 2 C floats that the sum pass reads again
FWD_BLOCKS_PER_SM = 16
BWD_BLOCKS_PER_SM = 4


def frozen_bn_plain(x, identity, weight, bias, mean, var, eps, relu):
    """relu(bn(x) + identity) as separate ops, in x's dtype; identity may
    be None, relu False."""
    y = F.batch_norm(x.float(), mean, var, weight, bias, False, 0.0, eps).to(x.dtype)
    if identity is not None:
        y = y + identity
    return F.relu(y) if relu else y


def frozen_bn_bwd_plain(g, x, y, weight, mean, var, eps, relu, identity):
    """Plain version of the backward kernel, given the forward's y: (dx,
    d_identity, d_weight, d_bias), d_identity = g' (g * (y > 0) where
    ``relu``, else g) where the forward had an ``identity``, else None; the
    sums in f32."""
    gf = g.float()
    if relu:
        gf = torch.where(y <= 0, 0.0, gf)
    inv = torch.rsqrt(var + eps)
    dims = (0, 2, 3)
    d_bias = gf.sum(dims)
    d_weight = (gf * (x.float() - mean[:, None, None])).sum(dims) * inv
    dx = gf * (weight * inv)[:, None, None]
    return dx.to(x.dtype), gf.to(x.dtype) if identity else None, d_weight, d_bias


def _rows(x: torch.Tensor) -> tuple[int, int]:
    n, c, h, w = x.shape
    return n * h * w, c


def _check(x, name, dtype, shape):
    if not x.is_cuda:
        raise ValueError(f"{name} is on {x.device}, expected a CUDA tensor")
    if x.dtype not in DTYPE_CODE or x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype} "
                        "(float32 or bfloat16)")
    if x.dim() != 4 or x.shape != shape:
        raise ValueError(f"{name} must be {tuple(shape)} (N, C, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_params(c, device, *params):
    for p in params:
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != device \
                or not p.is_contiguous():
            raise ValueError(f"BN parameters must be contiguous float32 ({c},) on {device}")


def grid(m, c, per_sm, device) -> int:
    """Blocks of a launch over m rows of c channels: enough to cover them,
    at most ``per_sm`` an SM."""
    if c % VEC or c // VEC > THREADS or c <= 0:
        raise ValueError(f"the frozen BN kernels take C a multiple of {VEC} up to "
                         f"{VEC * THREADS}, got {c}")
    rows = THREADS // (c // VEC)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-m // rows), per_sm * sms))


def frozen_bn_fwd_cuda(x, identity, weight, bias, mean, var, eps, relu):
    """The forward kernel on channels-last CUDA tensors; same contract as
    ``frozen_bn_plain``."""
    _check(x, "x", x.dtype, x.shape)
    if identity is not None:
        _check(identity, "identity", x.dtype, x.shape)
    m, c = _rows(x)
    _check_params(c, x.device, weight, bias, mean, var)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    FROZEN_BN_FWD(x.device, DTYPE_CODE[x.dtype], x.data_ptr(),
                  None if identity is None else identity.data_ptr(),
                  weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(),
                  float(eps), int(relu), y.data_ptr(), m, c,
                  grid(m, c, FWD_BLOCKS_PER_SM, x.device))
    return y


def frozen_bn_bwd_cuda(g, x, y, weight, mean, var, eps, relu, identity):
    """The backward kernels on channels-last CUDA tensors; same contract as
    ``frozen_bn_bwd_plain`` (d_identity is g itself where not ``relu``)."""
    g = g.contiguous(memory_format=torch.channels_last)
    _check(x, "x", x.dtype, x.shape)
    _check(g, "g", x.dtype, x.shape)
    if relu:
        _check(y, "y", x.dtype, x.shape)
    m, c = _rows(x)
    _check_params(c, x.device, weight, mean, var)
    blocks = grid(m, c, BWD_BLOCKS_PER_SM, x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    write_identity = relu and identity
    d_identity = (torch.empty_like(x, memory_format=torch.channels_last) if write_identity
                  else g if identity else None)
    partial = torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)
    d_weight = torch.empty(c, dtype=torch.float32, device=x.device)
    d_bias = torch.empty_like(d_weight)
    FROZEN_BN_BWD(x.device, DTYPE_CODE[x.dtype], g.data_ptr(), x.data_ptr(),
                  y.data_ptr() if relu else None, weight.data_ptr(), mean.data_ptr(),
                  var.data_ptr(), float(eps), int(relu), dx.data_ptr(),
                  d_identity.data_ptr() if write_identity else None, partial.data_ptr(),
                  d_weight.data_ptr(), d_bias.data_ptr(), m, c, blocks)
    return dx, d_identity, d_weight, d_bias


class _FrozenBN(torch.autograd.Function):
    """The kernels' forward and backward on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, identity, weight, bias, mean, var, eps, relu):
        y = frozen_bn_fwd_cuda(x, identity, weight, bias, mean, var, eps, relu)
        ctx.eps, ctx.relu, ctx.identity = eps, relu, identity is not None
        ctx.save_for_backward(x, y if relu else None, weight, mean, var)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, weight, mean, var = ctx.saved_tensors
        dx, d_identity, d_weight, d_bias = frozen_bn_bwd_cuda(
            g, x, y, weight, mean, var, ctx.eps, ctx.relu, ctx.identity)
        return dx, d_identity, d_weight, d_bias, None, None, None, None


def frozen_bn(x, identity, weight, bias, mean, var, eps, relu):
    """relu(bn(x) (+ identity)) of a frozen BN, differentiable in x,
    identity, weight and bias: the kernels for CUDA tensors (channels-last,
    or the call raises), the plain version otherwise.  Where no gradient is
    wanted (serving) the forward kernel runs without autograd's
    bookkeeping."""
    if not use_kernel(x):
        return frozen_bn_plain(x, identity, weight, bias, mean, var, eps, relu)
    tracing.count("bn.fused", 1)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, identity, weight, bias)):
        return _FrozenBN.apply(x, identity, weight, bias, mean, var, eps, relu)
    return frozen_bn_fwd_cuda(x, identity, weight, bias, mean, var, eps, relu)
