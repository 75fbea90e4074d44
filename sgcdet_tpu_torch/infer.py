"""Serving entry point: one scene in, detections out (the eval step of
sgcdet_tpu/train/loop.py::make_eval_step plus the host half of
sgcdet_tpu/cli.py::run_eval)."""
from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .models.det_head import decode_bboxes

_SCENE_KEYS = ("imgs", "proj_img", "proj_feat4", "origin")


def scene_inputs(scene, dev) -> list:
    """The model's inputs imgs, proj_img, proj_feat4, origin of one scene
    (dict of arrays or tensors; arrays taken as f32), on ``dev``."""
    with tracing.span("sgc.detect.upload"):
        args = [x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
                for x in (scene[k] for k in _SCENE_KEYS)]
        return [a.to(dev) for a in args]


@torch.inference_mode()
def forward_scene(model, scene) -> dict:
    """Run ``model`` on one scene (dict of arrays or tensors with keys
    imgs, proj_img, proj_feat4, origin), on the model's device."""
    return model(*scene_inputs(scene, next(model.parameters()).device))


def detect(model, scene):
    """Detections of one scene, NumPy, after the host decode and NMS with
    the model config's test settings: (boxes, scores (M,), labels (M,)).
    The ScanNet head gives boxes (M, 6) in center form (cx, cy, cz, dx, dy,
    dz) after the aligned 3D NMS; the ARKit head (``head_type="sunrgbd"``)
    gives yawed boxes (M, 7) (cx, cy, cz, dx, dy, dz, yaw) after the
    per-class rotated BEV NMS.  z is at the geometric center."""
    with tracing.span("sgc.detect"):
        return decode(model, forward_scene(model, scene), scene["origin"])


def decode(model, out, origin):
    """``detect``'s host half: the detections of the outputs ``out`` of one
    scene (of ``forward_scene``, or of a view-sharded eval step, on one
    rank) whose origin is ``origin``."""
    with tracing.span("sgc.decode"):
        head_outs = [tuple(t.cpu().numpy() for t in scale) for scale in out["head_outs"]]
        origin = origin.cpu().numpy() if torch.is_tensor(origin) else np.asarray(origin)
        return decode_bboxes(head_outs, out["valid"].cpu().numpy(), origin,
                             model.cfg.voxel_size, model.cfg)
