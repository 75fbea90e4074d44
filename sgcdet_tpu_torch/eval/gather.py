"""Multi-host detection gather for sharded validation, the port's copy of
sgcdet_tpu/eval/gather.py (the same ``.npz`` keys, so a shard written by
either package loads in the other).

The reference evaluates the whole val set on rank 0 with dummy loaders on
the other ranks (LightningTools/pl_model.py:59-74, dataset_dm.py:50-53).
Here every rank evaluates its ``rank::world`` slice and ships the (cheap,
already-decoded) detections through a shared filesystem directory; rank 0
merges them in scene order and computes the metric.  A filesystem gather
needs no collective over padded device buffers and works between the
processes of one machine or of several that share a directory.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..geometry.boxes import DepthBoxes3D


def _shard_path(gather_dir, host_id):
    return os.path.join(gather_dir, f"eval_shard_{host_id}.npz")


def save_shard(gather_dir, host_id, indices, dt_annos):
    """Write one host's detections atomically (.npz + rename)."""
    os.makedirs(gather_dir, exist_ok=True)
    arrays = {"indices": np.asarray(indices, np.int64)}
    for p, det in enumerate(dt_annos):
        boxes = det["boxes_3d"]
        arrays[f"boxes_{p}"] = np.asarray(boxes.tensor, np.float32)
        arrays[f"yaw_{p}"] = np.asarray(boxes.with_yaw)
        arrays[f"scores_{p}"] = np.asarray(det["scores_3d"], np.float32)
        arrays[f"labels_{p}"] = np.asarray(det["labels_3d"], np.int64)
    path = _shard_path(gather_dir, host_id)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_shard(gather_dir, host_id):
    """Read one host's shard back as (indices, dt_annos)."""
    with np.load(_shard_path(gather_dir, host_id)) as z:
        indices = z["indices"].tolist()
        dt = []
        for p in range(len(indices)):
            boxes = z[f"boxes_{p}"]
            with_yaw = bool(z[f"yaw_{p}"])
            det = DepthBoxes3D(
                boxes,
                box_dim=boxes.shape[-1] if len(boxes) else (7 if with_yaw else 6),
                with_yaw=with_yaw,
                origin=(0.5, 0.5, 0.0),  # tensor is already bottom-center
            )
            dt.append(dict(boxes_3d=det, scores_3d=z[f"scores_{p}"],
                           labels_3d=z[f"labels_{p}"]))
    return indices, dt


def gather_detections(gather_dir, host_id, num_hosts, indices, dt_annos,
                      timeout=3600, poll=1.0):
    """Write own shard; host 0 waits for all shards and returns the merged
    scene-ordered detection list, other hosts return None."""
    save_shard(gather_dir, host_id, indices, dt_annos)
    if host_id != 0:
        return None
    deadline = time.time() + timeout
    merged: dict[int, dict] = {}
    for h in range(num_hosts):
        path = _shard_path(gather_dir, h)
        while not os.path.exists(path):
            if time.time() > deadline:
                raise TimeoutError(f"eval shard from host {h} never arrived")
            time.sleep(poll)
        idx_h, dt_h = load_shard(gather_dir, h)
        merged.update(dict(zip(idx_h, dt_h)))
    return [merged[i] for i in sorted(merged)]
