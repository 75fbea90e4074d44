"""The serving slice of the PyTorch port as a whole, on the CPU.

* the tiny ScanNet-structured model (budget on) vs the JAX SGCDet at
  float32: identical ``valid``, head outputs within 5e-4 of their scale,
  identical decoded boxes through ``infer.detect``;
* ``state_dict_from_flax`` round trip through ``convert_torch_state_dict``;
* ``scene.example_scene`` vs ``__graft_entry__._example_scene``;
* the port imports (its data, eval and geometry packages too) and serves
  the ScanNet and ARKit heads, and scores detections with its indoor eval,
  with JAX, the JAX package, OpenCV and PIL made unimportable;
* ``chip_smoke.py`` refuses to run without a GPU, and without the repo;
* ``depth_remat``: one train step against JAX's remat step and equal to
  the port's step without it (``test_sgcdet_refuses_depth_remat``, whose
  name is from when the port refused the option).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models.det_head import decode_bboxes as jax_decode
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.infer import detect, forward_scene
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.models.det_head import decode_bboxes
from sgcdet_tpu_torch.scene import example_scene, example_train_scene

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    keep_global_torch_rng,
    randomize_batch_stats,
    tiny_model_cfg,
    to_numpy_tree,
)

from test_torch_options import assert_step_matches_jax, train_steps, zero_templates

REPO = Path(__file__).resolve().parents[1]
SCENE_KEYS = ("imgs", "proj_img", "proj_feat4", "origin")


@pytest.fixture(scope="module")
def slice_setup():
    mcfg = tiny_model_cfg()
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    jm = JSGCDet(cfg=mcfg, img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.asarray(scene[k]) for k in SCENE_KEYS]
    variables = jax.jit(lambda key, *a: jm.init({"params": key}, *a, train=False))(
        jax.random.PRNGKey(0), *args)
    params = to_numpy_tree(variables["params"])
    # zero class bias: scores near 0.25 instead of the 0.01 prior, so the
    # decode below has boxes to compare
    params["bbox_head"]["cls_conv"]["bias"][:] = 0.0
    stats = randomize_batch_stats(variables["batch_stats"])
    j_out = jax.jit(lambda p, s, *a: jm.apply(
        {"params": p, "batch_stats": s}, *a, train=False))(params, stats, *args)

    model = SGCDet(mcfg, IMG_SHAPE, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return dict(mcfg=mcfg, scene=scene, params=params, stats=stats,
                j_out=jax.tree_util.tree_map(np.asarray, j_out),
                model=model, t_out=forward_scene(model, scene))


def test_slice_valid_and_depth_match_jax(slice_setup):
    s = slice_setup
    np.testing.assert_array_equal(s["t_out"]["valid"].numpy(), s["j_out"]["valid"])
    assert 0 < s["t_out"]["valid"].sum() < s["t_out"]["valid"].numel()
    assert_close_scaled(s["t_out"]["dpt_dist"].numpy(), s["j_out"]["dpt_dist"],
                        5e-4, "dpt_dist")
    assert_close_scaled(s["t_out"]["occ_preds"].numpy(), s["j_out"]["occ_preds"],
                        1e-5, "occ_preds")


def test_slice_head_outputs_match_jax(slice_setup):
    s = slice_setup
    for lvl, (t_scale, j_scale) in enumerate(zip(s["t_out"]["head_outs"],
                                                 s["j_out"]["head_outs"])):
        for name, a, b in zip(("centerness", "bbox", "cls"), t_scale, j_scale):
            assert a.dtype == torch.float32
            assert_close_scaled(a.numpy(), b, 5e-4, f"{name} level {lvl}")


def test_slice_detect_gives_the_jax_boxes(slice_setup):
    s = slice_setup
    mcfg = s["mcfg"]
    boxes, scores, labels = detect(s["model"], s["scene"])
    j_boxes, j_scores, j_labels = jax_decode(
        s["j_out"]["head_outs"], s["j_out"]["valid"], s["scene"]["origin"],
        mcfg.voxel_size, mcfg)
    assert len(boxes) > 0
    assert boxes.shape == j_boxes.shape
    np.testing.assert_allclose(boxes, j_boxes, atol=1e-3)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4)
    np.testing.assert_array_equal(labels, j_labels)
    # the port's host decode is the JAX package's on the same head outputs
    p_boxes, p_scores, p_labels = decode_bboxes(
        s["j_out"]["head_outs"], s["j_out"]["valid"], s["scene"]["origin"],
        mcfg.voxel_size, mcfg)
    np.testing.assert_array_equal(p_boxes, j_boxes)
    np.testing.assert_array_equal(p_scores, j_scores)
    np.testing.assert_array_equal(p_labels, j_labels)


def test_state_dict_round_trip(slice_setup):
    """flax -> port state_dict -> convert_torch_state_dict -> the same flax
    trees, with no reference key left unconsumed."""
    s = slice_setup
    sd = {k: v.numpy() for k, v in state_dict_from_flax(s["params"], s["stats"]).items()}
    assert set(sd) == set(s["model"].state_dict())
    zeros = jax.tree_util.tree_map(np.zeros_like, (s["params"], s["stats"]))
    unused = set()
    params, stats = convert_torch_state_dict(sd, *zeros, unused_out=unused)
    assert unused == set()
    for a, b in ((params, s["params"]), (stats, s["stats"])):
        leaves_a, tree_a = jax.tree_util.tree_flatten(a)
        leaves_b, tree_b = jax.tree_util.tree_flatten(b)
        assert tree_a == tree_b
        for x, y in zip(leaves_a, leaves_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("trajectory", ["ring", "indoor"])
def test_scene_matches_graft_entry(trajectory):
    from __graft_entry__ import _example_scene

    ours = example_scene(IMG_SHAPE, PAD, 5, trajectory=trajectory)
    ref = _example_scene(IMG_SHAPE, PAD, 5, trajectory=trajectory)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))


_NO_JAX = """
import sys
# the JAX package and its frameworks, and the image libraries, which the
# card's machine lacks (the data pipeline imports them where it reads files)
for name in ("jax", "flax", "sgcdet_tpu", "cv2", "PIL"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import dataclasses
import numpy as np
import torch
import sgcdet_tpu_torch.data, sgcdet_tpu_torch.eval, sgcdet_tpu_torch.geometry
from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.eval import indoor_eval
from sgcdet_tpu_torch.geometry import DepthBoxes3D
from sgcdet_tpu_torch.infer import detect, forward_scene
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.scene import example_scene, example_train_scene
from torch_port_tiny import IMG_SHAPE, N_VIEWS, PAD, TINY_MODEL, tiny_model_cfg
scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
for dtype in ("float32", "bfloat16"):
    model = SGCDet(tiny_model_cfg(dtype, configs), IMG_SHAPE, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    out = forward_scene(model, scene)
    assert all(torch.isfinite(t).all() for s in out["head_outs"] for t in s)
    boxes, scores, labels = detect(model, scene)
    print(dtype, boxes.shape, flush=True)
# the ARKit head: yawed boxes after the rotated BEV NMS, scored by the eval
arkit = dataclasses.replace(configs.arkit().model, compute_dtype="float32", **TINY_MODEL)
model = SGCDet(arkit, IMG_SHAPE, device="cpu", generator=torch.Generator().manual_seed(1))
boxes, scores, labels = detect(model, scene)
assert boxes.shape[1] == 7 and len(boxes) > 0, boxes.shape
gt = dict(gt_num=len(boxes), gt_boxes_upright_depth=boxes, **{{"class": labels}})
dt = dict(boxes_3d=DepthBoxes3D(boxes, origin=(0.5, 0.5, 0.5)), scores_3d=scores,
          labels_3d=labels)
res = indoor_eval([gt], [dt], [0.25, 0.5], {{i: str(i) for i in range(3)}})
assert res["mAP_0.25"] == res["mAP_0.50"] == 1.0, res
print("arkit", boxes.shape, flush=True)
assert not any(m == "jax" or m.startswith(("jax.", "flax", "sgcdet_tpu.", "cv2", "PIL"))
               for m in sys.modules if sys.modules[m] is not None)
print("NO_JAX_OK")
"""


@pytest.fixture(scope="module")
def remat_templates():
    return zero_templates()


def test_sgcdet_refuses_depth_remat(remat_templates):
    """``depth_remat=True`` trains: one tiny f32 step (the ring rig, depth
    loss off, so the depth net's gradient reaches the trunk through the
    checkpoint) against JAX's step with ``nn.remat`` around the depth net
    (loss terms, n_pos, gradient norm, every gradient and the BN running
    statistics at tests/test_torch_train.py's tolerances), and equal to the
    port's step without the remat: the recomputation gives the forward's
    values, and the depth net's BNs move their statistics once."""
    scene = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, tiny_model_cfg().n_classes, 8,
                                trajectory="ring")
    remat = train_steps(remat_templates, scene, depth_remat=True)
    assert_step_matches_jax(remat)
    plain = train_steps(remat_templates, scene, jax_step=False)
    for name in remat["metrics"]:
        assert torch.equal(remat["metrics"][name], plain["metrics"][name]), name
    grads = {n: p.grad for n, p in plain["model"].named_parameters()}
    for name, p in remat["model"].named_parameters():
        assert torch.equal(p.grad, grads[name]), name
    bufs = plain["model"].state_dict()
    for name, buf in remat["model"].state_dict().items():
        assert torch.equal(buf, bufs[name]), name
    moved = [n for n, b in bufs.items() if n.startswith("depth_head.")
             and n.endswith("running_mean")
             and not torch.equal(b, torch.from_numpy(
                 state_dict_from_flax(plain["params"], plain["stats"])[n].numpy()))]
    assert len(moved) > 10


def test_port_serves_without_jax():
    code = _NO_JAX.format(repo=str(REPO), tests=str(REPO / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def _run_smoke(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=str(cwd), env=env)


def test_chip_smoke_refuses_without_gpu():
    proc = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
