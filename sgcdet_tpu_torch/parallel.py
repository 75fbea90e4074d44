"""Data parallelism of the port, the counterpart of sgcdet_tpu/parallel/mesh.py
and of the ``pmean`` reductions of the JAX package's mesh step.

One process per card, one scene per process.  ``from_env`` reads the
process group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on the card, with
device ``cuda:LOCAL_RANK``, and gloo only when the caller asks for the CPU.
Its ``rank`` and ``world`` go to the loader and to the sharded eval.

Every collective of the port goes through ``all_reduce_sum_``,
``all_reduce_mean_``, ``mean_over_ranks`` or the view sharding's
``gather_views`` and ``sum_over_ranks``, which count each call by kind in
``COUNTS``:

* ``bn_sync`` / ``bn_sync_backward``: a train-mode BatchNorm's mean and
  mean of squares, and their gradient (``models/layers.py``);
  ``bn_sync_recompute``: the same statistics again where the backward
  recomputes a checkpointed region (``depth_remat``'s depth net);
* ``n_pos``: the positive count that normalises the head's losses;
* ``gradients``, ``metrics``, ``bn_stats``: the train step's flat gradient
  buffer, its loss terms with the total and n_pos, and the BatchNorm
  running statistics (``train/loop.py``).

View sharding (``train/loop.py::make_view_sharded_train_step`` and
``make_view_sharded_eval_step``): the N views of one scene split into G
equal slices over the ranks of a group, rank r holding views r N/G to
(r + 1) N/G - 1 (``view_slice``).  Inside ``view_sharding(group)`` the
per-view region of the model (backbone, FPN, depth net, the DFA3D stages)
runs on this rank's views and places its collectives by hand where the JAX
package's GSPMD places them; everything after the inter-view fusion is
replicated.  Their kinds in ``COUNTS``:

* ``view_gather``: the depth net's all-gathers of the matching features
  and projections (the sweep's neighbours may lie on any rank), and the
  eval step's of the depth distributions;
* ``view_fusion``: the lifting's all-gathers of each level's per-view
  queries and visibility mask before the fusion over views;
* ``view_scatter``: the reduce-scatters (sum) that carry the gradients of
  gathered tensors back to their views' ranks, the all-gather's transpose;
* ``view_bn``, ``view_bn_backward``, ``view_bn_recompute``: a train-mode
  BatchNorm's statistics over every view of the scene, their gradient,
  and the same statistics again in ``depth_remat``'s recomputation;
* ``view_depth_loss``, ``view_depth_loss_backward``: the depth loss's BCE
  sum and foreground count over every view (all-reduce sum, whose
  transpose is an all-reduce sum);
* ``view_gradients``: the train step's flat gradient buffer (a sum).

They are the backend's ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce``: NCCL's on the cards, gloo's on the CPU and, two
processes sharing one card, on CUDA tensors too (``chip_smoke.py`` phase
19).  Gathers copy bytes, so every dtype gathers exactly; gloo sums 16-bit
floats in f32.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

COUNTS = dict.fromkeys(
    ("bn_sync", "bn_sync_backward", "bn_sync_recompute", "n_pos", "gradients", "metrics",
     "bn_stats", "view_gather", "view_fusion", "view_scatter", "view_bn", "view_bn_backward",
     "view_bn_recompute", "view_depth_loss", "view_depth_loss_backward", "view_gradients"), 0)

# the keys of a scene that hold one entry a view (loop.py:180-183 of the
# JAX package); the rest is replicated
VIEW_KEYS = ("imgs", "proj_img", "proj_feat4", "gt_depth")


@dataclass(frozen=True)
class Context:
    """Where this process runs: its rank of ``world``, its device, and the
    process group (None when it runs alone)."""

    rank: int
    world: int
    device: torch.device
    group: object | None


def from_env(device="cuda") -> Context:
    """The process group of this process from torchrun's environment, joined
    (NCCL on the card, gloo on the CPU); without ``WORLD_SIZE`` > 1 a
    context of one process on ``device``.  ``device="cuda"`` without a card
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Context(0, 1, dev, None)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return Context(rank, world, dev, dist.group.WORLD)


def barrier(ctx: Context):
    if ctx.group is not None:
        dist.barrier(group=ctx.group)


def shutdown(ctx: Context):
    if ctx.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce_sum_(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` replaced in place by its sum over the ranks of ``group``
    (``lax.psum``); counted under ``kind``."""
    COUNTS[kind] += 1
    dist.all_reduce(t, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` replaced in place by its mean over the ranks of ``group``
    (``lax.pmean``); counted under ``kind``."""
    return all_reduce_sum_(t, group, kind).div_(dist.get_world_size(group))


class _MeanOverRanks(torch.autograd.Function):
    """pmean with pmean as its transpose: the gradient of each rank's input
    is the mean of every rank's output gradient."""

    @staticmethod
    def forward(ctx, t, group, kind, backward_kind):
        ctx.group, ctx.backward_kind = group, backward_kind
        return all_reduce_mean_(t.clone(), group, kind)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean_(grad.clone(memory_format=torch.contiguous_format),
                                ctx.group, ctx.backward_kind), None, None, None


def mean_over_ranks(t: torch.Tensor, group, kind="bn_sync",
                    backward_kind="bn_sync_backward") -> torch.Tensor:
    """Differentiable mean of ``t`` over the ranks of ``group``, counted
    under ``kind`` (its gradient's under ``backward_kind``)."""
    return _MeanOverRanks.apply(t, group, kind, backward_kind)


# ---------------------------------------------------------------------------
# view sharding
# ---------------------------------------------------------------------------

_VIEW = {"group": None}


@contextlib.contextmanager
def view_sharding(group):
    """Within the block, the model's per-view region holds this rank's
    slice of the scene's views and communicates over ``group`` (None: the
    whole scene in this process)."""
    previous = _VIEW["group"]
    _VIEW["group"] = group
    try:
        yield
    finally:
        _VIEW["group"] = previous


def view_group():
    """The group of the enclosing ``view_sharding`` block, or None."""
    return _VIEW["group"]


def view_slice(scene: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s slice of ``world`` equal slices of the scene's views
    (the ``VIEW_KEYS`` entries; the rest is shared).  A view count that
    ``world`` does not divide is refused, as the JAX package's sharding
    refuses it."""
    n = len(scene["imgs"])
    if n % world:
        raise ValueError(f"a scene of {n} views does not split into {world} equal "
                         f"slices: the view count must divide by the ranks of the group")
    m = n // world
    return {k: v[rank * m:(rank + 1) * m] if k in VIEW_KEYS else v for k, v in scene.items()}


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` (n, ...) one after another in rank order, (G n, ...),
    copied as bytes."""
    n = t.shape[0]
    raw = t.contiguous().reshape(n, -1).view(torch.uint8)
    out = raw.new_empty((dist.get_world_size(group) * n, raw.shape[1]))
    dist.all_gather_into_tensor(out, raw, group=group)
    return out.view(t.dtype).reshape((-1,) + t.shape[1:])


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of the sum over the ranks of ``t`` (G n, ...):
    (n, ...)."""
    dtype = t.dtype
    if dist.get_backend(group) == "gloo" and dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // dist.get_world_size(group),) + t.shape[1:])
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.to(dtype)


class _GatherViews(torch.autograd.Function):
    """All-gather over the view axis, whose transpose is a reduce-scatter
    (sum): each rank's slice gets the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group = group
        COUNTS[kind] += 1
        return _all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        COUNTS["view_scatter"] += 1
        return _reduce_scatter(grad, ctx.group), None, None


def gather_views(t: torch.Tensor, group, kind="view_gather") -> torch.Tensor:
    """Every rank's slice of a view-major tensor, (G n, ...) in view order;
    differentiable, counted under ``kind``."""
    return _GatherViews.apply(t, group, kind)


class _SumOverRanks(torch.autograd.Function):
    """All-reduce sum, whose transpose is an all-reduce sum."""

    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce_sum_(t.clone(memory_format=torch.contiguous_format), group, kind)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone(memory_format=torch.contiguous_format),
                               ctx.group, ctx.kind + "_backward"), None, None


def sum_over_ranks(t: torch.Tensor, group, kind) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks of ``group``, counted
    under ``kind`` (its gradient's under ``kind + "_backward"``)."""
    return _SumOverRanks.apply(t, group, kind)


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own, on ``generator``'s device, seeded from
    one draw of ``generator`` (which every rank makes alike) and the rank:
    the counterpart of ``jax.random.fold_in(rng, axis_index)``."""
    draw = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device)
    seed = int(draw.item()) ^ ((rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1))
    return torch.Generator(device=generator.device).manual_seed(seed)
