"""How ``correct`` is decided: the numbers that hold what the timed path
produced against the plain reference, each read on the reference's side
at float32 with TF32 off.

Serving (``serve_readings``), for each sampled request:
  head_err         worst over scales and outputs (centerness, box
                   distances, class logits) of RMS(program - reference) /
                   std(reference) of the head outputs
  pick_gap         worst over the finer levels of how far past the
                   reference's own top-k cut (in occupancy score) a voxel
                   that the program picked, or left, lies
  decode_mismatch  boxes of the program's detections that the reference's
                   decode of the program's own head outputs does not give
The reference follows the program's occupancy picks (and so gives the same
``valid``); ``pick_gap`` judges those picks by the reference's scores.

Training (``train_readings``), over the set-up's first steps:
  loss_gap    worst over steps and loss terms of |program - reference| /
              |reference total loss|
  grad_gap    worst over trained leaves of the gap between the norms of the
              first clipped gradient (the program's from its AdamW state
              after one step) over max(that leaf's reference norm, the
              median leaf's)
  change_gap  the same of the parameters' change after the steps, and of
              the BatchNorm running statistics' change; leaves whose first
              reference gradient is under a thousandth of the median
              leaf's are left out (they move by round-off alone)
  pick_gap    as in serving, every step
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import model as refmodel
from .reference.decode import decode
from .reference.train import AdamW, losses, mean_over_ranks_, rank_generator

LOSS_KEYS = ("loss_centerness", "loss_bbox", "loss_cls", "loss_occ")
CHECK_STEPS = 3  # training steps of set-up that the reference follows


def f32_exact():
    """Context: float32 matmuls and convolutions without TF32."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved
    return _Ctx()


def picks_of(occ_preds, valid, mcfg):
    """The occupancy picks of a run, from its outputs: each finer level's
    top-k of its scores (highest first, lower index first among ties, the
    order of the program's documented top-k) and the last level's from
    ``valid``.  occ_preds: the finer levels' scores, finest first."""
    sizes = [int(np.prod(v)) for v in mcfg["n_voxels_list"][1:]]
    occ = torch.as_tensor(occ_preds).float()
    per_level, at = [], 0
    for size in sizes[::-1]:
        per_level.append(occ[at:at + size])
        at += size
    per_level = per_level[::-1]
    picks = []
    for lvl, (scores, k) in enumerate(zip(per_level, mcfg["topk_list"])):
        if lvl == len(sizes) - 1:
            picks.append(torch.as_tensor(valid).reshape(-1).nonzero()[:, 0])
        else:
            picks.append(torch.sort(scores, descending=True, stable=True)[1][:k])
    return picks


def pick_gap(scores, picks):
    """How far past the k-th score of ``scores`` a picked voxel lies below
    it, or an unpicked one above it (0 where the picks are a top-k)."""
    worst = 0.0
    for s, p in zip(scores, picks):
        s = s.detach().float()
        k = p.numel()
        if k == 0:
            continue
        cut = torch.sort(s, descending=True)[0][k - 1]
        chosen = torch.zeros_like(s, dtype=torch.bool)
        chosen[p.to(s.device)] = True
        below = (cut - s[chosen]).clamp(min=0).max()
        above = (s[~chosen] - cut).clamp(min=0).max() if (~chosen).any() else s.new_zeros(())
        worst = max(worst, float(below), float(above))
    return worst


def head_err(got, want):
    worst = 0.0
    for g_scale, w_scale in zip(got, want):
        for g, w in zip(g_scale, w_scale):
            g, w = torch.as_tensor(g).float().to(w.device), w.float()
            if g.shape != w.shape:
                return float("inf")
            std = w.std().clamp(min=1e-12)
            worst = max(worst, float((g - w).square().mean().sqrt() / std))
    return worst


def decode_mismatch(dets, want):
    """Boxes that differ between two detections (boxes, scores, labels):
    the difference in count, and the boxes (in score order) whose
    coordinates or score differ by more than 1e-5 of their magnitude, or
    whose label differs."""
    (b1, s1, l1), (b2, s2, l2) = dets, want
    n = min(len(b1), len(b2))
    o1, o2 = np.argsort(-s1, kind="stable")[:n], np.argsort(-s2, kind="stable")[:n]
    bad = (np.abs(b1[o1] - b2[o2]) > 1e-5 * (1 + np.abs(b2[o2]))).any(1)
    bad |= np.abs(s1[o1] - s2[o2]) > 1e-5 * (1 + np.abs(s2[o2]))
    bad |= l1[o1] != l2[o2]
    return abs(len(b1) - len(b2)) + int(bad.sum())


def scan_inputs(scan, dev):
    return [torch.from_numpy(np.asarray(scan[k], np.float32)).to(dev)
            for k in ("imgs", "proj_img", "proj_feat4", "origin")]


@torch.inference_mode()
def serve_readings(ref, samples, scans, cfg, log=None):
    """samples: [(pool index, outputs, detections)] of the program (outputs:
    head_outs per scale, valid, occ_preds, on any device).  Returns the
    readings' dict."""
    dev = next(ref.parameters()).device
    mcfg = cfg["model"]
    read = dict(head_err=0.0, pick_gap=0.0, decode_mismatch=0)
    ref.eval()
    with f32_exact():
        for j, out, dets in samples:
            imgs, proj_img, proj4, origin = scan_inputs(scans[j], dev)
            picks = picks_of(out["occ_preds"], out["valid"], mcfg)
            want = ref(imgs, proj_img, proj4, origin, tuple(cfg["data"]["img_shape"]),
                       picks=picks, log=log)
            read["head_err"] = max(read["head_err"], head_err(out["head_outs"], want["head_outs"]))
            read["pick_gap"] = max(read["pick_gap"], pick_gap(want["scores"], picks))
            head_np = [tuple(np.asarray(torch.as_tensor(t).float().cpu()) for t in s)
                       for s in out["head_outs"]]
            mine = decode(head_np, np.asarray(torch.as_tensor(out["valid"]).float().cpu()),
                          scans[j]["origin"], mcfg["voxel_size_list"][-1], mcfg["test_cfg"])
            read["decode_mismatch"] += decode_mismatch(dets, mine)
    return read


def train_reference(ref, cfg, scans, picks, gen_seed, log=None, group=None):
    """The reference's first steps on ``scans`` with the given picks of
    each step (None: its own top-k): (each step's losses, scores and picks,
    the first clipped gradients, the parameters and BN statistics after
    the steps), on the reference's device.  With a process ``group`` (data
    parallel, this rank's scans): BN statistics and the positive count are
    the ranks' means, each rank draws its dropout from its own fold of the
    generator, the gradients are averaged before the clip, and the loss
    terms and BN running statistics after the step."""
    dev = next(ref.parameters()).device
    opt = AdamW(ref, cfg["train"])
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    refmodel.set_group(ref, group)
    ref.train()
    stats = [b for n, b in ref.named_buffers() if n.endswith(("running_mean", "running_var"))]
    steps = []
    with f32_exact():
        for s, scan in enumerate(scans):
            imgs, proj_img, proj4, origin = scan_inputs(scan, dev)
            drop = gen if group is None else rank_generator(gen, rank)
            out = ref(imgs, proj_img, proj4, origin, tuple(cfg["data"]["img_shape"]),
                      generator=drop, picks=picks[s], log=log)
            gt = [torch.from_numpy(np.asarray(scan[k])).to(dev)
                  for k in ("gt_boxes", "gt_labels", "gt_mask")]
            terms = losses(cfg["model"], out, origin, gt[0], gt[1], gt[2].bool(), group)
            total = sum(terms.values())
            for p in ref.parameters():
                p.grad = None
            total.backward()
            scalars = torch.stack([v.detach() for v in terms.values()] + [total.detach()])
            if group is not None:
                with torch.no_grad():
                    for p in ref.parameters():
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    mean_over_ranks_([p.grad for p in ref.parameters()], group)
                    mean_over_ranks_([scalars], group)
                    mean_over_ranks_(stats, group)
            opt.step()
            steps.append(dict(zip(list(terms) + ["loss"], scalars.tolist()),
                              picks=out["picks"],
                              scores=[t.detach() for t in out["scores"]]))
    refmodel.set_group(ref, None)
    after = {n: t.detach().clone() for n, t in ref.state_dict().items()}
    return steps, opt.first_grads, after


def _norms(d):
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in d.items()}


def _gap(got, want):
    """Worst |norm(got) - norm(want)| over max(norm(want), median norm)."""
    if not want:
        return 0.0
    med = float(np.median(list(want.values())))
    return max(abs(got.get(n, 0.0) - w) / max(w, med, 1e-30) for n, w in want.items())


def train_readings(program, reference, start):
    """program: {"losses": [step dicts], "picks": [[per level] per step],
    "first_grads": {name: tensor}, "after": {name: tensor}}; reference: the
    output of ``train_reference``; start: the state dict both began from."""
    steps, first, after = reference
    loss_gap = 0.0
    for got, want in zip(program["losses"], steps):
        for k in LOSS_KEYS + ("loss",):
            loss_gap = max(loss_gap, abs(got[k] - want[k]) / max(abs(want["loss"]), 1e-30))
    want_g = _norms(first)
    got_g = _norms({n: program["first_grads"][n] for n in first if n in program["first_grads"]})
    med_g = float(np.median(list(want_g.values())))
    moving = [n for n in first if want_g[n] >= 1e-3 * med_g]
    stats = [n for n in start if n.endswith(("running_mean", "running_var"))]

    def change(state):
        return {n: state[n].float().cpu() - start[n].float().cpu() for n in moving + stats}

    pick = max(pick_gap(s["scores"], p) for s, p in zip(steps, program["picks"]))
    return dict(loss_gap=loss_gap, grad_gap=_gap(got_g, want_g),
                change_gap=_gap(_norms(change(program["after"])), _norms(change(after))),
                pick_gap=pick)
