"""The ScanNet200-L config of the PyTorch port (``configs.scannet200_large``)
against the JAX package, on the CPU.

* the config field by field, and its 189 class names;
* an SGCDet at the -L widths (embed 128, 8 heads x 4 points, so c = 128 at
  stage 1 and 16 a head at stage 2; 189 classes) on ``torch_port_tiny``'s
  4-view 47 x 64 scene, with a tiny grid ((4, 4, 2), (8, 8, 4), (16, 16,
  8) at the -L voxel sizes) and the visibility budget on, against the JAX
  SGCDet at float32 with the same weights (the port's seeded init carried
  to flax by ``train/checkpoint.py::convert_torch_state_dict``, back by
  ``convert.state_dict_from_flax``): identical ``valid``, head outputs
  within 5e-4 of their scale, the decoded boxes of ``infer.detect``; one
  f32 train step's loss terms within the tolerance of
  tests/test_torch_train.py (1e-4), its n_pos and gradient norm;
* the DFA3D wrappers refuse the widths no kernel is built for before any
  launch, the windowed ones too (here on the CPU device, where the checks
  run before any kernel is built).

The kernels at these widths are held against the plain versions in
tests/test_torch_cuda.py (card), the plain DFA3D at (1, 1, 128) and
(8, 4, 16) against the oracle in tests/test_torch_ops.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.configs import config as jconfigs
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models.det_head import decode_bboxes as jax_decode
from sgcdet_tpu.models.detector import compute_losses as jax_compute_losses
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.infer import detect, forward_scene
from sgcdet_tpu_torch.ops import KERNELS
from sgcdet_tpu_torch.ops.dfa3d import dfa3d_bwd_cuda, dfa3d_fwd_cuda
from sgcdet_tpu_torch.ops.dfa3d_windowed import dfa3d_win_bwd_cuda, dfa3d_win_fwd_cuda
from sgcdet_tpu_torch.scene import example_scene, example_train_scene
from sgcdet_tpu_torch.train import init_train_state, make_train_step

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    assert_close_scaled,
    dfa3d_inputs,
    keep_global_torch_rng,
    randomize_batch_stats,
    to_numpy_tree,
)

SCENE_KEYS = ("imgs", "proj_img", "proj_feat4", "origin")
# the -L config cut to a tiny grid: its widths, heads, points, classes and
# voxel sizes stay; level 2 keeps 512 of its 2048 voxels under a 0.5 budget
LARGE_TINY = dict(
    n_voxels_list=((4, 4, 2), (8, 8, 4), (16, 16, 8)), topk_list=(64, 512),
    dbound=(0.2, 3.4, 0.4), neck3d_out_channels=16, visibility_budget=(1.0, 1.0, 0.5),
    compute_dtype="float32", ffn_dropout=0.0,
)


def _tiny(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **LARGE_TINY))


@pytest.mark.parametrize("section", ["model", "model.test_cfg", "data", "train"])
def test_scannet200_large_config_matches_jax(section):
    ours, ref = configs.scannet200_large(), jconfigs.scannet200_large()
    assert ours.name == ref.name
    for name in section.split("."):
        ours, ref = getattr(ours, name), getattr(ref, name)
    for f in dataclasses.fields(ours):
        if dataclasses.is_dataclass(getattr(ours, f.name)):
            continue
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    if section == "model":
        for prop in ("depth_channels", "n_voxels", "voxel_size"):
            assert getattr(ours, prop) == getattr(ref, prop), prop
        assert (ours.embed_dims, ours.embed_dims // ours.num_heads) == (128, 16)


def test_scannet200_classes_match_jax():
    assert configs.SCANNET200_CLASSES == jconfigs.SCANNET200_CLASSES
    assert len(configs.SCANNET200_CLASSES) == configs.scannet200_large().model.n_classes == 189


@pytest.fixture(scope="module")
def large_setup():
    """The port's seeded tiny -L model, its weights in flax (zero class
    bias, so scores sit near 0.5 and the decode has boxes; random BN
    statistics), and both models' f32 outputs on the indoor scene."""
    cfg = _tiny(dataclasses.replace(configs.scannet200_large(),
                                    data=dataclasses.replace(configs.scannet200_large().data,
                                                             img_shape=IMG_SHAPE, pad_size=PAD)))
    j_mcfg = dataclasses.replace(jconfigs.scannet200_large().model, **LARGE_TINY)
    jm = JSGCDet(cfg=j_mcfg, img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.zeros((N_VIEWS, 3) + PAD), jnp.zeros((N_VIEWS, 3, 4)),
            jnp.zeros((N_VIEWS, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    templates = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model, _ = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    unused = set()
    params, stats = convert_torch_state_dict(sd, templates["params"],
                                             templates["batch_stats"], unused_out=unused)
    assert unused == set()
    params, stats = to_numpy_tree(params), randomize_batch_stats(stats)
    params["bbox_head"]["cls_conv"]["bias"][:] = 0.0
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    scene = example_scene(IMG_SHAPE, PAD, N_VIEWS, trajectory="indoor")
    j_out = jax.jit(lambda p, s, *a: jm.apply(
        {"params": p, "batch_stats": s}, *a, train=False))(
        params, stats, *(jnp.asarray(scene[k]) for k in SCENE_KEYS))
    return dict(cfg=cfg, j_mcfg=j_mcfg, jm=jm, scene=scene, params=params, stats=stats,
                model=model, j_out=jax.tree_util.tree_map(np.asarray, j_out),
                t_out=forward_scene(model, scene))


def test_large_model_has_the_large_widths(large_setup):
    model = large_setup["model"]
    attn = (model.voxel_head.base_heads[2].cross_transformer.encoder.layers[0]
            .attentions[0].deformable_attention)
    assert attn.value_proj.weight.shape == (128, 128)
    assert attn.sampling_offsets.weight.shape[0] == 8 * 4 * 2
    assert model.bbox_head.cls_conv.weight.shape[0] == 189


def test_large_valid_and_head_outputs_match_jax(large_setup):
    s = large_setup
    np.testing.assert_array_equal(s["t_out"]["valid"].numpy(), s["j_out"]["valid"])
    assert 0 < s["t_out"]["valid"].sum() < s["t_out"]["valid"].numel()
    for lvl, (t_scale, j_scale) in enumerate(zip(s["t_out"]["head_outs"],
                                                 s["j_out"]["head_outs"])):
        for name, a, b in zip(("centerness", "bbox", "cls"), t_scale, j_scale):
            assert a.dtype == torch.float32
            assert_close_scaled(a.numpy(), b, 5e-4, f"{name} level {lvl}")
    assert s["t_out"]["head_outs"][0][2].shape[0] == 189  # (classes, X, Y, Z)


def test_large_detect_gives_the_jax_boxes(large_setup):
    s = large_setup
    mcfg = s["cfg"].model
    boxes, scores, labels = detect(s["model"], s["scene"])
    j_boxes, j_scores, j_labels = jax_decode(
        s["j_out"]["head_outs"], s["j_out"]["valid"], s["scene"]["origin"],
        mcfg.voxel_size, mcfg)
    assert len(boxes) > 0
    assert boxes.shape == j_boxes.shape
    np.testing.assert_allclose(boxes, j_boxes, atol=1e-3)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4)
    np.testing.assert_array_equal(labels, j_labels)


def test_large_train_step_losses_match_jax(large_setup):
    """One f32 train step (ffn_dropout 0, depth loss on) on the ring rig
    (the indoor rig is ill-conditioned at this size: tests/
    test_torch_train.py) against ``jax.value_and_grad`` of the JAX
    package's scene loss: every loss term and the total within 1e-4, n_pos,
    the gradient norm within 1e-3."""
    s = large_setup
    cfg = dataclasses.replace(s["cfg"], model=dataclasses.replace(s["cfg"].model,
                                                                  depth_loss=True))
    j_mcfg = dataclasses.replace(s["j_mcfg"], depth_loss=True)
    scene = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, cfg.model.n_classes,
                                cfg.model.downsample_factor, trajectory="ring")
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    params, stats = s["params"], s["stats"]
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    metrics = make_train_step(model, cfg, optimizer)(scene, torch.Generator())

    x = {k: jnp.asarray(v) for k, v in scene.items()}

    def loss_fn(p):
        out, _ = JSGCDet(cfg=j_mcfg, img_shape=IMG_SHAPE, query_chunk=None).apply(
            {"params": p, "batch_stats": stats}, *(x[k] for k in SCENE_KEYS), train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        losses, n_pos = jax_compute_losses(j_mcfg, out, x["origin"], x["gt_boxes"],
                                           x["gt_labels"], x["gt_mask"],
                                           gt_depth=x["gt_depth"])
        return sum(losses.values()), (losses, n_pos)

    (total, (losses, n_pos)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    assert set(metrics) == set(losses) | {"loss", "n_pos", "grad_norm"}
    assert float(metrics["n_pos"]) == float(n_pos)
    for name in list(losses) + ["loss"]:
        want = float(total if name == "loss" else losses[name])
        assert np.isfinite(float(metrics[name])), name
        np.testing.assert_allclose(float(metrics[name]), want, rtol=1e-4, err_msg=name)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm, rtol=1e-3)


def _operands(heads, p, c):
    value, dpt, locs, attn = map(torch.from_numpy, dfa3d_inputs(heads, p, c, n=2, k=16))
    return value, dpt, locs, attn, torch.zeros((2, 16, heads * c))


# (heads, points, c, the wrapper, its message): a width no kernel is built
# for; the windowed kernels at multi-head widths no config runs (128; the
# backward also 256), where their c = 16, the -L stage 2's, is built
REFUSALS = [
    pytest.param(1, 1, 64, "fwd", r"take c in \(32, 128, 256\) per head at stage 1",
                 id="fwd_s1_c64"),
    pytest.param(1, 1, 16, "fwd", r"take c in \(32, 128, 256\) per head at stage 1",
                 id="fwd_s1_c16"),
    pytest.param(8, 4, 8, "fwd", r"take c in \(16, 32, 128, 256\) per head multi-head",
                 id="fwd_mh_c8"),
    pytest.param(8, 4, 64, "bwd", r"take c in \(16, 32, 128, 256\) per head multi-head",
                 id="bwd_mh_c64"),
    pytest.param(4, 4, 128, "bwd", "multi-head backward takes c = 16 or 32 per head",
                 id="bwd_mh_c128"),
    pytest.param(8, 4, 128, "win_fwd", r"windowed forward takes c in \(16, 32, 256\)",
                 id="win_fwd_c128_h8"),
    pytest.param(1, 4, 128, "win_fwd", r"windowed forward takes c in \(16, 32, 256\)",
                 id="win_fwd_c128"),
    pytest.param(2, 4, 256, "win_bwd", r"windowed backward takes c in \(16, 32\)",
                 id="win_bwd_c256"),
    pytest.param(1, 4, 128, "win_bwd", r"windowed backward takes c in \(16, 32\)",
                 id="win_bwd_c128"),
]


@pytest.mark.parametrize("heads,p,c,wrapper,match", REFUSALS)
def test_wrappers_refuse_widths_without_a_kernel(heads, p, c, wrapper, match):
    value, dpt, locs, attn, g = _operands(heads, p, c)
    call = {"fwd": lambda: dfa3d_fwd_cuda(value, dpt, locs, attn, heads),
            "bwd": lambda: dfa3d_bwd_cuda(value, dpt, locs, attn, g, heads),
            "win_fwd": lambda: dfa3d_win_fwd_cuda(value, dpt, locs, attn, heads),
            "win_bwd": lambda: dfa3d_win_bwd_cuda(value, dpt, locs, attn, g, heads)}
    before = {n: k.launches for n, k in KERNELS.items()}
    with pytest.raises(ValueError, match=match):
        call[wrapper]()
    assert {n: k.launches for n, k in KERNELS.items()} == before
