"""The ARKit head of the PyTorch port (``head_type="sunrgbd"``: yawed boxes,
the rotated 3D IoU loss, rotated BEV NMS) against the JAX package, on the
CPU.

* ``configs.arkit()``, ``arkit_large()`` and ``get_config`` field by field;
* ``rotated_iou_3d_torch``'s value (1e-6) and autograd gradient (1e-5 of
  the gradient's scale) against ``jax.grad`` of the JAX package's formula on
  disjoint, nested, identical, touching (side by side and stacked), 45 degree
  and random pairs;
* a tiny ARKit SGCDet (the ``torch_port_tiny`` widths, 4-view 47 x 64
  indoor scene, budget on) and a tiny ``arkit_large`` one (embed 128, 8
  heads x 4 points: c = 128 at stage 1, 16 a head at stage 2) with the
  port's seeded weights carried to flax by
  ``train/checkpoint.py::convert_torch_state_dict``: identical ``valid``,
  head outputs within 1e-4 of their scale (the 7-wide ``reg_conv`` and its
  raw yaw channel included); every loss term of ``compute_losses`` on the
  JAX model's head outputs and GT with FCOS positives within 1e-5 relative,
  n_pos, and the gradient of the total loss in every head output within
  1e-5 of its scale; the decode with ``box3d_multiclass_nms`` on the same
  head outputs: the same kept set and labels, boxes within 1e-5; and
  ``infer.detect`` serving (M, 7) boxes;
* the yawed synthetic train scene, on which a step has FCOS positives.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu.configs import config as jconfigs
from sgcdet_tpu.geometry.rotated_iou import rotated_iou_3d as jax_rotated_iou_3d
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models.det_head import decode_bboxes as jax_decode
from sgcdet_tpu.models.detector import compute_losses as jax_compute_losses
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.geometry import rotated_iou_3d, rotated_iou_3d_torch
from sgcdet_tpu_torch.infer import detect, forward_scene
from sgcdet_tpu_torch.models.det_head import decode_bboxes
from sgcdet_tpu_torch.models.detector import compute_losses
from sgcdet_tpu_torch.scene import example_scene, example_train_scene
from sgcdet_tpu_torch.train import init_train_state, make_train_step

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    TINY_MODEL,
    assert_close_scaled,
    keep_global_torch_rng,
    randomize_batch_stats,
    to_numpy_tree,
)

SCENE_KEYS = ("imgs", "proj_img", "proj_feat4", "origin")
# the tiny grid of torch_port_tiny at each config's widths; the decode keeps
# 200 candidates a scale (the tests' time), the rest of test_cfg is ARKit's
TINY = {
    "arkit": dict(TINY_MODEL),
    "arkit_large": dict(n_voxels_list=TINY_MODEL["n_voxels_list"], topk_list=(64, 512),
                        dbound=TINY_MODEL["dbound"], n_classes=3, neck3d_out_channels=16,
                        visibility_budget=(1.0, 1.0, 0.5)),
}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["arkit", "arkit_large", "scannet", "scannet200_large"])
@pytest.mark.parametrize("section", ["model", "model.test_cfg", "data", "train"])
def test_config_matches_jax(name, section):
    ours, ref = configs.get_config(name), jconfigs.get_config(name)
    assert ours.name == ref.name
    for part in section.split("."):
        ours, ref = getattr(ours, part), getattr(ref, part)
    for f in dataclasses.fields(ours):
        if not dataclasses.is_dataclass(getattr(ours, f.name)):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    if section == "model":
        for prop in ("depth_channels", "n_voxels", "voxel_size"):
            assert getattr(ours, prop) == getattr(ref, prop), prop


def test_class_lists_and_registry():
    assert configs.ARKIT_CLASSES == jconfigs.ARKIT_CLASSES
    assert configs.SCANNET_CLASSES == jconfigs.SCANNET_CLASSES
    assert configs.arkit().model.n_classes == len(configs.ARKIT_CLASSES) == 17
    assert configs.arkit_large().model.embed_dims == 128
    with pytest.raises(KeyError, match="unknown config"):
        configs.get_config("sunrgbd")


# ---------------------------------------------------------------------------
# the rotated IoU and its gradient
# ---------------------------------------------------------------------------


def _box(*v):
    return np.asarray([v], np.float32)


def _random_pairs(n=64, seed=0):
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.uniform(-1, 1, (n, 3)), rng.uniform(0.2, 1.5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = a + np.concatenate([rng.uniform(-0.5, 0.5, (n, 3)), rng.uniform(-0.1, 0.1, (n, 3)),
                            rng.uniform(-0.5, 0.5, (n, 1))], 1)
    return a.astype(np.float32), b.astype(np.float32)


_B = (0.3, 0.2, 0.5, 1.0, 0.8, 0.6, 0.4)
IOU_CASES = {
    "disjoint": (_box(*_B), _box(3.3, 0.2, 0.5, 1.0, 0.8, 0.6, 0.6)),
    "nested": (_box(*_B), _box(0.3, 0.2, 0.5, 0.5, 0.4, 0.3, 0.7)),
    "identical": (_box(*_B), _box(*_B)),
    # one shared face: a degenerate intersection polygon of area 0
    "touching": (_box(0, 0, 0.5, 1, 1, 1, 0), _box(1, 0, 0.5, 1, 1, 1, 0)),
    # one box on top of the other: the height overlap is exactly 0
    "stacked": (_box(0, 0, 0.5, 1, 1, 1, 0), _box(0.3, 0, 1.5, 1, 1, 1, 0)),
    "45deg": (_box(0, 0, 0.5, 1, 1, 1, 0), _box(0, 0, 0.5, 1, 1, 1, np.pi / 4)),
    "random": _random_pairs(),
}


@functools.lru_cache(maxsize=None)
def _jax_iou_reference():
    """Per case: the JAX formula's IoU and ``jax.grad`` in both boxes, from
    one call on all cases' pairs stacked (each pair's gradient is its own).
    Not jitted: op by op every product rounds as it does in torch, where
    XLA's fused CPU code contracts ``a * b - c * d`` into FMAs, which moves
    the exact vertex ties of identical boxes (and so which corner takes the
    gradient; 0.92 apart there, equal in the other cases)."""
    a = jnp.asarray(np.concatenate([IOU_CASES[c][0] for c in IOU_CASES]))
    b = jnp.asarray(np.concatenate([IOU_CASES[c][1] for c in IOU_CASES]))
    value = jax_rotated_iou_3d(a, b, xp=jnp)
    grads = jax.grad(lambda u, v: jax_rotated_iou_3d(u, v, xp=jnp).sum(),
                     argnums=(0, 1))(a, b)
    out, start = {}, 0
    for case, (x, _) in IOU_CASES.items():
        sl = slice(start, start + len(x))
        out[case] = (np.asarray(value[sl]), np.asarray(grads[0][sl]),
                     np.asarray(grads[1][sl]))
        start += len(x)
    return out


@pytest.mark.parametrize("case", list(IOU_CASES))
def test_rotated_iou_value_and_gradient_match_jax(case):
    a, b = IOU_CASES[case]
    want, *grads = _jax_iou_reference()[case]
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    got = rotated_iou_3d_torch(ta, tb)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    # the NumPy copy is the JAX package's NumPy path, bit for bit
    np.testing.assert_array_equal(rotated_iou_3d(a, b), jax_rotated_iou_3d(a, b))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads)
    for name, t, g in (("boxes1", ta, grads[0]), ("boxes2", tb, grads[1])):
        err = float(np.abs(t.grad.numpy() - np.asarray(g)).max())
        assert err <= 1e-5 * max(scale, 1.0), f"{case} {name}: gradient err {err:.3e}"
    if case == "identical":
        assert abs(float(got[0].detach()) - 1.0) < 1e-6
    if case in ("disjoint", "touching", "stacked"):
        assert float(got[0].detach()) == 0.0


# ---------------------------------------------------------------------------
# the tiny ARKit models
# ---------------------------------------------------------------------------


def _port_config(name):
    base = configs.get_config(name)
    model = dataclasses.replace(base.model, compute_dtype="float32", ffn_dropout=0.0,
                                test_cfg=dataclasses.replace(base.model.test_cfg,
                                                             nms_pre=200),
                                **TINY[name])
    return dataclasses.replace(base, model=model, data=dataclasses.replace(
        base.data, img_shape=IMG_SHAPE, pad_size=PAD))


def _gt_on_valid(valid, mcfg, origin, n=6, seed=5):
    """Padded (8) yawed GT boxes of n real ones, each centred on a voxel the
    sparse volume selected, so the FCOS assignment has positives."""
    from sgcdet_tpu_torch.voxel_grid import voxel_centers_zero_origin

    rng = np.random.RandomState(seed)
    centres = voxel_centers_zero_origin(mcfg.n_voxels, mcfg.voxel_size) + origin
    picks = rng.choice(np.flatnonzero(valid.reshape(-1) > 0), n, replace=False)
    extent = np.asarray(mcfg.voxel_size) * np.asarray(mcfg.n_voxels)
    boxes = np.zeros((8, 7), np.float32)
    boxes[:n, :3] = centres[picks]
    boxes[:n, 3:6] = rng.uniform(0.15, 0.4, (n, 3)) * extent
    boxes[:n, 6] = rng.uniform(-np.pi, np.pi, n)
    labels = rng.randint(0, mcfg.n_classes, 8).astype(np.int32)
    return boxes, labels, np.arange(8) < n


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The port's seeded tiny model of ``name``, its weights in flax (zero
    class bias, random BN statistics), both models' f32 eval outputs on the
    indoor scene, and GT with FCOS positives."""
    cfg = _port_config(name)
    j_mcfg = dataclasses.replace(jconfigs.get_config(name).model, compute_dtype="float32",
                                 ffn_dropout=0.0, test_cfg=cfg.model.test_cfg, **TINY[name])
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
    j_out = jax.tree_util.tree_map(np.asarray, j_out)
    gt = _gt_on_valid(j_out["valid"], cfg.model, scene["origin"])
    return dict(cfg=cfg, j_mcfg=j_mcfg, scene=scene, params=params, stats=stats,
                model=model, j_out=j_out, t_out=forward_scene(model, scene), gt=gt)


@pytest.fixture(scope="module", params=["arkit", "arkit_large"])
def arkit_setup(request):
    return _setup(request.param)


def test_reg_conv_is_seven_wide_and_converts(arkit_setup):
    s = arkit_setup
    head = s["model"].bbox_head
    assert head.reg_conv.weight.shape[0] == 7 and head.yawed
    np.testing.assert_array_equal(
        head.reg_conv.weight.detach().numpy(),
        np.transpose(s["params"]["bbox_head"]["reg_conv"]["kernel"], (4, 3, 0, 1, 2)))
    if s["cfg"].model.embed_dims == 128:  # the -L widths
        attn = (s["model"].voxel_head.base_heads[2].cross_transformer.encoder.layers[0]
                .attentions[0].deformable_attention)
        assert attn.value_proj.weight.shape == (128, 128)
        assert attn.sampling_offsets.weight.shape[0] == 8 * 4 * 2


def test_head_outputs_match_jax(arkit_setup):
    s = arkit_setup
    np.testing.assert_array_equal(s["t_out"]["valid"].numpy(), s["j_out"]["valid"])
    assert 0 < s["t_out"]["valid"].sum() < s["t_out"]["valid"].numel()
    for lvl, (t_scale, j_scale) in enumerate(zip(s["t_out"]["head_outs"],
                                                 s["j_out"]["head_outs"])):
        assert t_scale[1].shape[0] == 7
        for name, a, b in zip(("centerness", "bbox", "cls"), t_scale, j_scale):
            assert a.dtype == torch.float32
            assert_close_scaled(a.numpy(), b, 1e-4, f"{name} level {lvl}")
        # the yaw channel is the raw regression, the distances its exp
        assert (t_scale[1][:6] > 0).all() and (t_scale[1][6] < 0).any()


def _losses_on_jax_outputs(s):
    """The port's loss dict on the JAX model's head outputs (leaf tensors)."""
    out = {k: s["j_out"][k] for k in ("valid", "occ_preds", "dpt_dist")}
    heads = [tuple(torch.tensor(x, requires_grad=True) for x in scale)
             for scale in s["j_out"]["head_outs"]]
    out = {k: torch.tensor(v) for k, v in out.items()}
    out["head_outs"] = heads
    boxes, labels, mask = s["gt"]
    losses, n_pos = compute_losses(s["cfg"].model, out, torch.from_numpy(s["scene"]["origin"]),
                                   torch.from_numpy(boxes), torch.from_numpy(labels),
                                   torch.from_numpy(mask))
    return losses, n_pos, heads


def test_losses_and_their_gradients_match_jax(arkit_setup):
    s = arkit_setup
    boxes, labels, mask = (jnp.asarray(x) for x in s["gt"])
    origin = jnp.asarray(s["scene"]["origin"])

    def loss_fn(head_outs):
        out = dict(s["j_out"], head_outs=head_outs)
        losses, n_pos = jax_compute_losses(s["j_mcfg"], out, origin, boxes, labels, mask)
        return sum(losses.values()), (losses, n_pos)

    heads = jax.tree_util.tree_map(jnp.asarray, s["j_out"]["head_outs"])
    (_, (want, j_n_pos)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(heads)
    losses, n_pos, t_heads = _losses_on_jax_outputs(s)
    assert float(n_pos) == float(j_n_pos) > 0
    assert set(losses) == set(want)
    assert float(losses["loss_bbox"].detach()) > 0
    for name, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(want[name]), rtol=1e-5,
                                   err_msg=name)
    sum(losses.values()).backward()
    for lvl, (t_scale, j_scale) in enumerate(zip(t_heads, j_grads)):
        for name, t, g in zip(("centerness", "bbox", "cls"), t_scale, j_scale):
            assert_close_scaled(t.grad.numpy(), np.asarray(g), 1e-5,
                                f"d loss / d {name} level {lvl}")


def test_decode_with_rotated_nms_matches_jax(arkit_setup):
    s = arkit_setup
    mcfg = s["cfg"].model
    args = (s["j_out"]["head_outs"], s["j_out"]["valid"], s["scene"]["origin"],
            mcfg.voxel_size, mcfg)
    boxes, scores, labels = decode_bboxes(*args)
    j_boxes, j_scores, j_labels = jax_decode(*args[:-1], s["j_mcfg"])
    assert boxes.shape[1] == 7 and len(boxes) > 1
    assert boxes.shape == j_boxes.shape
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(scores, j_scores)
    np.testing.assert_allclose(boxes, j_boxes, rtol=0, atol=1e-5)


def test_detect_serves_yawed_boxes(arkit_setup):
    s = arkit_setup
    boxes, scores, labels = detect(s["model"], s["scene"])
    assert boxes.ndim == 2 and boxes.shape[1] == 7 and len(boxes) > 0
    assert len(boxes) == len(scores) == len(labels) <= s["cfg"].model.test_cfg.nms_pre
    assert np.isfinite(boxes).all() and (boxes[:, 3:6] > 0).all()


def test_yawed_train_scene_trains_the_rotated_loss():
    """``example_train_scene(yawed=True)`` keeps the ScanNet scene's labels
    and depth draws and swaps in 12 real yawed boxes of 16; one f32 step of
    the tiny ARKit model on it (the indoor rig, as chip_smoke.py trains)
    has FCOS positives and a nonzero rotated IoU loss."""
    plain = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, 3, 4)
    scene = example_train_scene(IMG_SHAPE, PAD, N_VIEWS, 3, 4, yawed=True)
    for k in ("imgs", "proj_img", "gt_labels", "gt_depth"):
        np.testing.assert_array_equal(scene[k], plain[k])
    assert scene["gt_mask"].sum() == 12 and plain["gt_mask"].sum() == 8
    assert (scene["gt_boxes"][:, 6] != 0).all() and (plain["gt_boxes"][:, 6] == 0).all()
    cfg = _port_config("arkit")
    model, optimizer = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    metrics = make_train_step(model, cfg, optimizer)(scene, torch.Generator())
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["n_pos"]) > 0 and float(metrics["loss_bbox"]) > 0
