"""Checkpoints and warm starts (sgcdet_tpu/train/checkpoint.py).

* ``save_checkpoint`` / ``latest_checkpoint`` / ``restore_checkpoint``: one
  ``torch.save`` file per step, ``<path>/step_<n>``, holding the model's
  ``state_dict``, the optimizer's and the step; every step's file is kept
  and ``<path>/last`` names the newest (the reference's
  ModelCheckpoint(every_n_epochs=1, save_top_k=-1, save_last=True)).
* ``load_torch_checkpoint``: a released Lightning ``.ckpt`` or a ``.pth``
  in the reference's naming, which the port's modules share, so it is a
  ``load_state_dict`` of the stripped dict.
* ``convert_torchvision_pretrained`` / ``load_torchvision_pretrained``: the
  ImageNet warm start from plain torchvision resnet50 / resnet18 state
  dicts.

Local paths only: nothing is downloaded.  The loaders keep the JAX
converter's reading of a state dict: ``num_batches_tracked`` counters and
the head's geometry buffers (``.vox_coords``, ``.ref_3d``) are skipped,
and the matching extractor's downsample BN, which the reference registers
twice (``bn3`` and ``downsample.1``, the same module in the port), takes
the ``bn3`` entry.
"""
from __future__ import annotations

import os

import torch

_SKIP = ("num_batches_tracked", ".vox_coords", ".ref_3d")
_MATCHING = "depth_head.fnet_mvs."


def save_checkpoint(path, model, optimizer, step):
    """Write ``<path>/step_<step>`` (model, optimizer, step) and point
    ``<path>/last`` at it.  ``path`` is made absolute; a save at a step that
    has a checkpoint overwrites it (the final save can fall on the last
    epoch's); both files are written to a temporary name and renamed."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    n = int(step)
    target = os.path.join(path, f"step_{n}")
    tmp = target + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": n}, tmp)
    os.replace(tmp, target)
    tmp = os.path.join(path, "last.tmp")
    with open(tmp, "w") as f:
        f.write(f"step_{n}")
    os.replace(tmp, os.path.join(path, "last"))


def latest_checkpoint(path):
    """The newest checkpoint under ``path``: the one ``last`` names, else
    the largest ``step_<n>``; None if there is none."""
    if not os.path.isdir(path):
        return None
    pointer = os.path.join(path, "last")
    if os.path.isfile(pointer):
        with open(pointer) as f:
            cand = os.path.join(path, f.read().strip())
        if os.path.isfile(cand):
            return cand
    steps = [int(name[5:]) for name in os.listdir(path)
             if name.startswith("step_") and name[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(path, f"step_{max(steps)}")


def restore_checkpoint(path, model, optimizer=None) -> int:
    """Load a ``save_checkpoint`` file into ``model`` (and ``optimizer``)
    on the model's device; returns its step.  The file is read to the host:
    the state dicts' loaders copy the weights and AdamW's moments to their
    parameters' devices and keep AdamW's step counts on the host, where the
    optimizer (not capturable) keeps them."""
    ckpt = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["step"])


def load_reference_state_dict(model, state_dict, partial=False):
    """Copy a state dict in the reference's naming into ``model``.

    Keys the JAX converter skips are skipped, and keys the model lacks are
    ignored.  With ``partial`` the model's entries missing from the dict
    keep their values (a warm start of some modules); otherwise a missing
    entry raises KeyError."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith(_SKIP)}
    own = model.state_dict()
    missing = []
    with torch.no_grad():
        for key, target in own.items():
            if key.endswith(_SKIP):
                continue
            src = key
            if key.startswith(_MATCHING) and ".downsample.1." in key:
                src = key.replace(".downsample.1.", ".bn3.")
            if src not in sd:
                missing.append(key)
                continue
            value = torch.as_tensor(sd[src])
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch at {key}: {tuple(target.shape)} "
                                 f"vs {tuple(value.shape)}")
            target.copy_(value.to(target.dtype))
    if missing and not partial:
        raise KeyError(f"state dict lacks {len(missing)} entries of the model, "
                       f"e.g. {missing[:3]}")


def strip_lightning_prefix(state_dict):
    """Keep the keys that contain 'model' and drop 'model.' from them (the
    JAX package's reading of pl_model.py:29-36)."""
    out = {}
    for k, v in state_dict.items():
        if "model" in k:
            out[k.replace("model.", "")] = v
    return out


def load_torch_checkpoint(path, model):
    """Load a released .ckpt / .pth file (Lightning ``state_dict`` with the
    ``model.`` prefix, or a bare state dict) into ``model``."""
    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    if any(k.startswith("model.") for k in sd):
        sd = strip_lightning_prefix(sd)
    load_reference_state_dict(model, sd)


def convert_torchvision_pretrained(backbone_sd=None, matching_sd=None) -> dict:
    """The reference-named state dict of an ImageNet warm start from plain
    torchvision state dicts: resnet50 keys under ``backbone.`` (``fc.``
    dropped); resnet18's conv1, bn1, layer1 and layer2 under
    ``depth_head.fnet_mvs.``, each ``downsample.1`` also as ``bn3``.  The
    matching extractor's ``final_conv_3ddet`` is not in it."""
    sd = {}
    if backbone_sd is not None:
        sd.update({f"backbone.{k}": v for k, v in backbone_sd.items()
                   if not k.startswith("fc.")})
    if matching_sd is not None:
        for k, v in matching_sd.items():
            if not k.startswith(("conv1.", "bn1.", "layer1.", "layer2.")):
                continue
            sd[f"{_MATCHING}{k}"] = v
            if ".downsample.1." in k:
                sd[f"{_MATCHING}{k.replace('.downsample.1.', '.bn3.')}"] = v
    return sd


def load_torchvision_pretrained(model, backbone_path=None, matching_path=None):
    """Warm-start ``model`` from torchvision resnet50 / resnet18 .pth files
    (either may be None); every other entry keeps its value."""

    def _load(path):
        if path is None:
            return None
        sd = torch.load(path, map_location="cpu", weights_only=False)
        return sd.get("state_dict", sd) if isinstance(sd, dict) else sd

    sd = convert_torchvision_pretrained(_load(backbone_path), _load(matching_path))
    load_reference_state_dict(model, sd, partial=True)
