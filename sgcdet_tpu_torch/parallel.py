"""Data parallelism of the port, the counterpart of sgcdet_tpu/parallel/mesh.py
and of the ``pmean`` reductions of the JAX package's mesh step.

One process per card, one scene per process.  ``from_env`` reads the
process group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on the card, with
device ``cuda:LOCAL_RANK``, and gloo only when the caller asks for the CPU.
Its ``rank`` and ``world`` go to the loader and to the sharded eval.

Every all-reduce of the port goes through ``all_reduce_mean_`` or
``mean_over_ranks``, which count each call by kind in ``COUNTS``:

* ``bn_sync`` / ``bn_sync_backward``: a train-mode BatchNorm's mean and
  mean of squares, and their gradient (``models/layers.py``);
* ``n_pos``: the positive count that normalises the head's losses;
* ``gradients``, ``metrics``, ``bn_stats``: the train step's flat gradient
  buffer, its loss terms with the total and n_pos, and the BatchNorm
  running statistics (``train/loop.py``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

COUNTS = dict.fromkeys(
    ("bn_sync", "bn_sync_backward", "n_pos", "gradients", "metrics", "bn_stats"), 0)


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


def all_reduce_mean_(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``t`` replaced in place by its mean over the ranks of ``group``
    (``lax.pmean``); counted under ``kind``."""
    COUNTS[kind] += 1
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


class _MeanOverRanks(torch.autograd.Function):
    """pmean with pmean as its transpose: the gradient of each rank's input
    is the mean of every rank's output gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_mean_(t.clone(), group, "bn_sync")

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean_(grad.clone(memory_format=torch.contiguous_format),
                                ctx.group, "bn_sync_backward"), None


def mean_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable mean of ``t`` over the ranks of ``group``."""
    return _MeanOverRanks.apply(t, group)


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own, on ``generator``'s device, seeded from
    one draw of ``generator`` (which every rank makes alike) and the rank:
    the counterpart of ``jax.random.fold_in(rng, axis_index)``."""
    draw = torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device)
    seed = int(draw.item()) ^ ((rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1))
    return torch.Generator(device=generator.device).manual_seed(seed)
