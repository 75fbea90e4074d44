"""Building blocks with the JAX package's numerics (sgcdet_tpu/models/layers.py).

* Conv / ConvTranspose / Linear cast their input and weights to the
  module's ``compute_dtype`` (None = f32), as ``layers._maybe_cast`` does.
  The model sets the attribute on every such layer (``set_compute_dtype``);
  there is no process-global knob.
* BatchNorm computes in f32 and casts back to the input dtype
  (layers.py:229-232); a plain ``nn.BatchNorm2d`` on bf16 input does not.
  Inside ``sync_batchnorm(group)`` (the data-parallel train step) every
  train-mode BN that is not frozen averages its batch statistics over the
  ranks, as the JAX package's BN does under a mesh (layers.py:210-225);
  inside ``parallel.view_sharding(group)`` (the per-view region of a
  view-sharded step) it takes them over every view of the scene.
  ``remat_contexts`` is the ``context_fn`` of a checkpointed region
  (``depth_remat``): its recomputation normalises as the forward did and
  leaves the running statistics alone, which the forward moved once, as
  flax's ``nn.remat`` moves them once a step.
* LayerNorm, MultiheadAttention and the interpolations follow the JAX code
  step by step, including its dtype promotion (bf16 activations times f32
  parameters give f32).

Parameter and buffer names are the torch ones, so ``state_dict`` keys use
the reference naming that ``train/checkpoint.py::convert_torch_state_dict``
reads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops.frozen_bn import frozen_bn
from ..parallel import mean_over_ranks, view_group, view_sharding


class _Cast:
    """Mixin of the layers that compute in the model's compute dtype."""

    compute_dtype: torch.dtype | None = None

    def _cast(self, t):
        if t is None or self.compute_dtype is None:
            return t
        return t.to(self.compute_dtype)


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(self._cast(x), self._weight_like(x), self._cast(self.bias))

    def _weight_like(self, x):
        """The weight in the compute dtype and, for a channels-last x, laid
        out channels-last too, in one copy (cuDNN would transpose the cast
        weight again)."""
        w = self.weight
        if is_channels_last(x):
            return w.to(self.compute_dtype or w.dtype, memory_format=torch.channels_last)
        return self._cast(w)


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(self._cast(x), self._cast(self.weight),
                                  self._cast(self.bias))


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(
            self._cast(x), self._cast(self.weight), self._cast(self.bias),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class ConvTranspose3d(_Cast, nn.ConvTranspose3d):
    def forward(self, x):
        return F.conv_transpose3d(
            self._cast(x), self._cast(self.weight), self._cast(self.bias),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


class Linear(_Cast, nn.Linear):
    def forward(self, x):
        return F.linear(self._cast(x), self._cast(self.weight),
                        self._cast(self.bias))


_BN_SYNC = {"group": None, "recompute": False}


@contextlib.contextmanager
def sync_batchnorm(group, recompute=False):
    """Within the block, train-mode BNs that are not frozen sync their batch
    statistics over the ranks of ``group`` (None: no sync); with
    ``recompute`` they leave their running statistics as they are."""
    previous = dict(_BN_SYNC)
    _BN_SYNC.update(group=group, recompute=recompute)
    try:
        yield
    finally:
        _BN_SYNC.update(previous)


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for a region whose
    train-mode BNs must move their running statistics once: the forward
    runs as it is; the recomputation in the backward, which runs outside
    the step's ``sync_batchnorm`` and ``view_sharding`` blocks, takes the
    forward's process groups (a synced BN all-reduces its batch statistics
    again, counted as ``bn_sync_recompute`` or ``view_bn_recompute``: the
    same inputs give the same statistics; a view-sharded region gathers its
    views again) and updates no running statistic."""
    return contextlib.nullcontext(), _recomputing(_BN_SYNC["group"], view_group())


@contextlib.contextmanager
def _recomputing(group, view):
    with sync_batchnorm(group, recompute=True), view_sharding(view):
        yield


class _F32BatchNorm:
    """BatchNorm in f32, result in the input dtype (layers.py:187-232).

    Eval mode, or ``frozen=True`` whatever the mode: running statistics,
    never updated.  A frozen BN is ``ops.frozen_bn`` (``fused``, which also
    takes ResNet-50's residual add and ReLU): the hand-written kernel on
    the card, the same ops as eval mode elsewhere.  Train mode: biased
    batch statistics over (N, spatial), and the running variance moves by
    the unbiased n/(n-1) estimate with momentum 0.1, which is what
    ``F.batch_norm`` does.  A frozen BN's affine
    still gets gradients (the optimizer leaves it alone).

    Train mode with a process group: the f32 per-channel mean and mean of
    squares are averaged over the ranks (``parallel.mean_over_ranks``,
    whose backward averages their gradients too), var = mean2 - mean^2,
    and the running variance moves by var * n / (n - 1).  The count n
    depends on the mode, as the JAX package's BN gets it from the shape it
    sees (layers.py:215-228):

    * inside ``sync_batchnorm(group)``, data parallel (one scene a rank,
      the ``pmean`` of a mesh step): n is the local count of elements a
      channel, x.numel() / C;
    * inside ``parallel.view_sharding(group)`` (G equal slices of one
      scene's views, which GSPMD sees as one global batch): n is the
      global count, G x.numel() / C, the count of a single process that
      holds every view.

    (Not ``nn.SyncBatchNorm``, which weighs by the global count in both.)
    A BN outside the per-view region (the 3D neck) sees no view group: its
    input is the replicated volume, alike on every rank."""

    def __init__(self, *args, frozen: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.frozen = frozen

    def forward(self, x):
        if self.frozen:
            return self.fused(x)
        train = self.training
        if train and _BN_SYNC["group"] is not None:
            return self._synced(x, _BN_SYNC["group"], views=False)
        if train and view_group() is not None:
            return self._synced(x, view_group(), views=True)
        mean, var = self.running_mean, self.running_var
        if not train:
            tracing.count("bn.running", 1)
        elif _BN_SYNC["recompute"]:  # the same call, on copies it may move
            mean, var = mean.clone(), var.clone()
        y = F.batch_norm(x.float(), mean, var, self.weight, self.bias, train,
                         self.momentum, self.eps)
        return y.to(x.dtype)

    def fused(self, x, identity=None, relu=False):
        """A frozen BN's relu(bn(x) (+ identity)) as one op
        (``ops.frozen_bn``): the kernel on a CUDA tensor, which must be
        channels-last; the plain sequence of ops on the CPU and under
        ``plain_ops()``."""
        if not self.frozen:
            raise ValueError("only a frozen BN normalises by its running statistics "
                             "in training too")
        tracing.count("bn.running", 1)
        return frozen_bn(x, identity, self.weight, self.bias, self.running_mean,
                         self.running_var, self.eps, relu)

    def _synced(self, x, group, views):
        ch = x.shape[1]
        axes = (0,) + tuple(range(2, x.ndim))
        xf = x.float()
        recompute = _BN_SYNC["recompute"]
        prefix = "view_bn" if views else "bn_sync"
        stats = mean_over_ranks(torch.cat([xf.mean(axes), xf.square().mean(axes)]), group,
                                prefix + ("_recompute" if recompute else ""),
                                prefix + "_backward")
        mean, mean2 = stats[:ch], stats[ch:]
        var = mean2 - mean.square()
        n = x.numel() // ch * (dist.get_world_size(group) if views else 1)
        if not recompute:  # a recomputation's forward moved them
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * n / max(n - 1, 1)))
        shape = (1, ch) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = xf * inv.reshape(shape) + (self.bias - mean * inv).reshape(shape)
        return y.to(x.dtype)


class BatchNorm2d(_F32BatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_F32BatchNorm, nn.BatchNorm3d):
    pass


class LayerNorm(nn.Module):
    """layers.py::LayerNorm: statistics in the input dtype, affine in the
    promoted dtype of input and parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def dropout(x, rate: float, generator: torch.Generator | None):
    """``flax.linen.Dropout`` in train mode: keep with probability
    1 - rate and scale the kept values by 1 / (1 - rate).  The mask comes
    from ``generator`` (on x's device), never from torch's global one."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Dropout -> Linear -> Dropout, residual
    add (layers.py:266-280); the dropouts act in train mode only.  Names
    ``layers.0.0`` / ``layers.1`` as in the reference state dict."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList([
            nn.Sequential(Linear(embed_dims, feedforward_channels), nn.ReLU()),
            Linear(feedforward_channels, embed_dims),
        ])

    def forward(self, x, identity=None, generator=None):
        rate = self.dropout if self.training else 0.0
        y = dropout(self.layers[0](x), rate, generator)
        y = dropout(self.layers[1](y), rate, generator)
        return (x if identity is None else identity) + y


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``-compatible attention (sequence first) with
    the JAX package's numerics: the in-projection runs in the promoted dtype
    of input and f32 weights, fully masked rows get zero attention, and the
    out-projection casts to the compute dtype (layers.py:283-322)."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, query, key, value, key_padding_mask=None):
        """query: (Lq, B, E); key/value: (Lk, B, E); key_padding_mask:
        (B, Lk) True where padded.  Returns (Lq, B, E)."""
        e, h = self.embed_dims, self.num_heads
        hd = e // h
        w, b = self.in_proj_weight, self.in_proj_bias

        def proj(x, i):
            dt = torch.promote_types(x.dtype, w.dtype)
            return F.linear(x.to(dt), w[i * e:(i + 1) * e].to(dt),
                            b[i * e:(i + 1) * e].to(dt))

        q, k, v = proj(query, 0), proj(key, 1), proj(value, 2)
        lq, bsz, _ = q.shape
        lk = k.shape[0]
        q = q.reshape(lq, bsz, h, hd).permute(1, 2, 0, 3)
        k = k.reshape(lk, bsz, h, hd).permute(1, 2, 0, 3)
        v = v.reshape(lk, bsz, h, hd).permute(1, 2, 0, 3)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if key_padding_mask is not None:
            mask = key_padding_mask[:, None, None, :]
            logits = logits.masked_fill(mask, float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        if key_padding_mask is not None:
            all_masked = key_padding_mask.all(-1)[:, None, None, None]
            attn = torch.where(all_masked, 0.0, attn)
        out = (attn @ v).permute(2, 0, 1, 3).reshape(lq, bsz, e)
        return self.out_proj(out)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every casting layer under ``module``."""
    dtype = None if dtype == torch.float32 else dtype
    for m in module.modules():
        if isinstance(m, _Cast):
            m.compute_dtype = dtype


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialization with the JAX package's initializers: torch's
    default uniform(+-1/sqrt(fan_in)) for conv/linear weights and biases,
    ones/zeros for norms, then each module's ``reset_special_parameters``
    (xavier, zero or constant inits where the JAX modules use them)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.ConvTranspose3d, nn.Linear)):
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.reset_parameters()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MultiheadAttention):
                bound = 1.0 / math.sqrt(m.embed_dims)
                nn.init.uniform_(m.in_proj_weight, -bound, bound,
                                 generator=generator)
                m.in_proj_bias.zero_()
        for m in module.modules():
            hook = getattr(m, "reset_special_parameters", None)
            if hook is not None:
                hook(generator)


def is_channels_last(x: torch.Tensor) -> bool:
    """x is 4-D and laid out channels-last (and not also NCHW)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def interpolate_nearest_size(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """F.interpolate(size=..., mode='nearest') on NC... tensors, with the
    JAX package's f32 index arithmetic.  A channels-last 4-D input gives a
    channels-last output (the rows are gathered in NHWC order)."""
    last = is_channels_last(x)
    out = x.permute(0, 2, 3, 1) if last else x
    first = 1 if last else 2
    for axis, new_s in enumerate(size):
        s = out.shape[axis + first]
        if new_s == s:
            continue
        idx = torch.floor(torch.arange(new_s, dtype=torch.float32, device=x.device)
                          * (s / new_s)).long().clamp(0, s - 1)
        out = out.index_select(axis + first, idx)
    return out.permute(0, 3, 1, 2) if last else out


def _linear_resize_1d(length_in, length_out, align_corners, device):
    if align_corners and length_out > 1:
        src = (torch.arange(length_out, dtype=torch.float32, device=device)
               * (length_in - 1) / (length_out - 1))
    else:
        scale = length_in / length_out
        src = (torch.arange(length_out, dtype=torch.float32, device=device)
               + 0.5) * scale - 0.5
        src = src.clamp(min=0.0)
    lo = torch.floor(src).long().clamp(0, length_in - 1)
    hi = (lo + 1).clamp(0, length_in - 1)
    return lo, hi, src - lo


def interpolate_linear(x: torch.Tensor, size: Sequence[int],
                       align_corners: bool = False) -> torch.Tensor:
    """Separable bi/trilinear resize over the trailing spatial dims of an
    NC... tensor (F.interpolate semantics), axis by axis as in the JAX
    package."""
    if len(size) != x.dim() - 2:
        raise ValueError(f"size {tuple(size)} does not match {tuple(x.shape)}")
    out = x
    for axis, new_s in enumerate(size):
        s = out.shape[axis + 2]
        if new_s == s:
            continue
        lo, hi, w = _linear_resize_1d(s, new_s, align_corners, x.device)
        a = out.index_select(axis + 2, lo)
        b = out.index_select(axis + 2, hi)
        shape = [1] * out.dim()
        shape[axis + 2] = new_s
        w = w.reshape(shape)
        out = a * (1 - w) + b * w
    return out
