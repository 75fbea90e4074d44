"""Fixed-shape batching with multi-worker prefetch, the port's copy of
sgcdet_tpu/data/loader.py: a pool of ``num_workers`` scene-decoder threads
(OpenCV's image decode releases the GIL, so threads scale across host cores
without pickling scene dicts between processes); per-scene futures are
submitted with a bounded window and assembled into batches in deterministic
order; per-host sharding keeps each process on its slice of the epoch (in
train mode, an equal number of batches on every host); GT is padded to a
static (max_boxes,) so every step sees one shape.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def pad_gt(boxes, labels, max_boxes):
    """Pad (G, 7) / (G,) GT to static (max_boxes, ...) and a bool mask."""
    g = min(len(boxes), max_boxes)
    out_b = np.zeros((max_boxes, 7), np.float32)
    out_l = np.zeros((max_boxes,), np.int32)
    out_m = np.zeros((max_boxes,), bool)
    out_b[:g] = boxes[:g]
    out_l[:g] = labels[:g]
    out_m[:g] = True
    return out_b, out_l, out_m


class SceneLoader:
    """Iterates batches of scenes with threaded prefetch.

    Each batch element is one scene (the model is per-scene; data parallelism
    stacks `batch_size` scenes on the leading axis, one per device).
    """

    def __init__(
        self,
        dataset,
        batch_size=1,
        shuffle=True,
        repeat_times=1,
        num_workers=4,
        max_boxes=128,
        host_id=0,
        num_hosts=1,
        seed=0,
        drop_last=True,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat_times = repeat_times
        self.num_workers = num_workers
        self.max_boxes = max_boxes
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._ex: ThreadPoolExecutor | None = None  # lazily built, reused across epochs

    def close(self):
        if self._ex is not None:
            self._ex.shutdown(wait=False)
            self._ex = None

    def __del__(self):
        self.close()

    def _epoch_indices(self):
        idx = np.tile(np.arange(len(self.ds)), self.repeat_times)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last and self.num_hosts > 1:
            # every host runs the same number of batches: the epoch keeps
            # whole rounds of num_hosts x batch_size scenes.  With one
            # scene a host, host h's batch b is scene h of batch b of one
            # host with num_hosts scenes a batch
            idx = idx[: len(idx) // (self.num_hosts * self.batch_size)
                      * self.num_hosts * self.batch_size]
        # per-host contiguous shard (DistributedSampler-style interleave)
        return idx[self.host_id :: self.num_hosts]

    def _collate(self, scenes):
        batch = {}
        for k in ("imgs", "proj_img", "proj_feat4", "origin"):
            batch[k] = np.stack([s[k] for s in scenes])
        if "gt_boxes" in scenes[0]:
            padded = [
                pad_gt(s["gt_boxes"], s["gt_labels"], self.max_boxes) for s in scenes
            ]
            batch["gt_boxes"] = np.stack([p[0] for p in padded])
            batch["gt_labels"] = np.stack([p[1] for p in padded])
            batch["gt_mask"] = np.stack([p[2] for p in padded])
        if "gt_depth" in scenes[0]:
            batch["gt_depth"] = np.stack([s["gt_depth"] for s in scenes])
        batch["index"] = np.asarray([s["index"] for s in scenes])
        return batch

    def __iter__(self):
        indices = self._epoch_indices()
        self.epoch += 1
        n_batches = len(indices) // self.batch_size
        if not self.drop_last and len(indices) % self.batch_size:
            n_batches += 1
        n_scenes = min(len(indices), n_batches * self.batch_size)

        if self.num_workers <= 0:
            for b in range(n_batches):
                sel = indices[b * self.batch_size : (b + 1) * self.batch_size]
                yield self._collate([self.ds[int(i)] for i in sel])
            return

        # per-scene futures, bounded in-flight window, in-order assembly
        if self._ex is None:
            self._ex = ThreadPoolExecutor(max_workers=self.num_workers)
        ex = self._ex
        window = 2 * self.num_workers + self.batch_size
        futs: deque = deque()
        submitted = 0

        def submit_more():
            nonlocal submitted
            while submitted < n_scenes and len(futs) < window:
                futs.append(ex.submit(self.ds.__getitem__, int(indices[submitted])))
                submitted += 1

        try:
            submit_more()
            for b in range(n_batches):
                take = min(self.batch_size, n_scenes - b * self.batch_size)
                scenes = []
                for _ in range(take):
                    scenes.append(futs.popleft().result())
                    submit_more()
                yield self._collate(scenes)
        finally:
            # keep the pool alive for the next epoch; just drop leftover work
            for f in futs:
                f.cancel()

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
