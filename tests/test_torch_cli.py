"""The CLI of the PyTorch port, its checkpoints and warm starts, its config
overrides and its show mode, on the CPU.

* The CLI end to end (``python -m sgcdet_tpu_torch.cli`` as a user runs it,
  ``--device cpu``) on an on-disk synthetic ScanNet set with the tiny
  overrides of tests/test_cli_end_to_end.py: train 2 steps with an eval at
  the epoch's end, eval and show with ``--ckpt_path``, resume to 4 steps;
  the artefacts the JAX package's test asserts; jax, flax and the JAX
  package never imported; and 2 steps then ``--resume`` to 4 bit-equal to 4
  steps in one run (parameters, BN buffers, optimizer state, ``last``).
  ``--sweep_band 16`` and ``auto`` (eval runs through the banded sweep,
  the auto band the JAX CLI's rule picks); the default device refuses
  without a card.
* ``apply_overrides`` and the ``config.json`` dump byte-equal to the JAX
  package's, with its errors.
* ``--load_from`` of a random Lightning-style .ckpt and the torchvision
  resnet50 / resnet18 warm start against the JAX package's converters
  (then ``convert.state_dict_from_flax``): every tensor equal.
* ``utils/visualize.py`` against the JAX package's bytes, with and without
  cv2.
* The checkpoint files: the ``last`` pointer, the fall-back to the largest
  step, the overwrite at one step, absolute paths; the optimizer's state
  dict through ``torch.save``, 3 steps after a round trip equal to 3
  without.
* The eval mode's ``run_eval`` against the JAX package's on the same
  (converted) weights and on-disk val set: equal mAP dicts and show dumps.
"""
import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu import configs as jconfigs
from sgcdet_tpu import cli as jcli
from sgcdet_tpu.geometry.boxes import DepthBoxes3D as JDepthBoxes3D
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.train import checkpoint as jcheckpoint
from sgcdet_tpu.utils import visualize as jvisualize

from sgcdet_tpu_torch import cli, configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.geometry import DepthBoxes3D
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.scene import example_scene
from sgcdet_tpu_torch.train import checkpoint, make_optimizer
from sgcdet_tpu_torch.utils import visualize

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    CLI_OVERRIDES,
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    PORT_ONLY,
    keep_global_torch_rng,
    tiny_model_cfg,
    write_scannet_set,
)

HELPER = str(Path(__file__).with_name("torch_port_tiny.py"))
REPO = str(Path(__file__).resolve().parents[1])


def _cli(cwd, *flags, data):
    """Start the port's CLI in a subprocess (2 threads, --device cpu)."""
    argv = [sys.executable, HELPER, "--cli", "--config", "scannet", "--data_root",
            str(data), "--num_workers", "1", "--device", "cpu", *flags]
    for ov in CLI_OVERRIDES:
        argv += ["--override", ov]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(*procs):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        assert PORT_ONLY in out, out[-3000:]
        outs.append(out)
    return outs


def _cli_chain(root):
    """Train 4 steps in ``b``, and at the same time 2 steps (one epoch and
    its eval) in ``a``, then eval and show of a's step 2, a's resume to 4
    and evals with ``--sweep_band 16`` and ``auto``."""
    data = write_scannet_set(root / "data")
    whole = _cli(root, "--mode", "train", "--log_folder", "b", "--max_steps", "4",
                 "--eval_every_epochs", "0", data=data)
    _wait(_cli(root, "--mode", "train", "--log_folder", "a", "--max_steps", "2", data=data))
    ckpt = root / "logs/a/ckpt/step_2"
    out_eval, out_show, _, _, band16, band_auto = _wait(
        _cli(root, "--mode", "eval", "--log_folder", "a_eval", "--ckpt_path", str(ckpt),
             data=data),
        _cli(root, "--mode", "show", "--log_folder", "a_show", "--ckpt_path", str(ckpt),
             data=data),
        _cli(root, "--mode", "train", "--log_folder", "a", "--max_steps", "4", "--resume",
             "--eval_every_epochs", "0", data=data),
        whole,
        _cli(root, "--mode", "eval", "--log_folder", "band16", "--ckpt_path", str(ckpt),
             "--sweep_band", "16", data=data),
        _cli(root, "--mode", "eval", "--log_folder", "band_auto", "--ckpt_path", str(ckpt),
             "--sweep_band", "auto", data=data))
    return root, out_eval, out_show, dict(band16=band16, band_auto=band_auto)


@pytest.fixture(scope="module", autouse=True)
def _cli_started(tmp_path_factory):
    """The CLI's subprocesses run while this module's other tests do (the
    CLI tests come last and wait for them)."""
    pool = ThreadPoolExecutor(max_workers=1)
    root = tmp_path_factory.mktemp("cli")
    future = pool.submit(_cli_chain, root)
    yield future
    pool.shutdown(wait=True)
    shutil.rmtree(root, ignore_errors=True)  # checkpoints of 0.45 GB each


@pytest.fixture(scope="module")
def cli_runs(_cli_started):
    return _cli_started.result(timeout=600)


# ---------------------------------------------------------------------------
# overrides and the config dump
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scannet", "arkit", "scannet200_large", "arkit_large"])
def test_overrides_and_config_json_match_jax(name):
    overrides = CLI_OVERRIDES + ["data.data_root=/data/x", "model.visibility_budget=0.5",
                                 "train.lr=1e-3", "model.head_type=sunrgbd"]
    ours = configs.apply_overrides(configs.get_config(name), overrides)
    ref = jconfigs.apply_overrides(jconfigs.get_config(name), overrides)
    want = json.dumps(dataclasses.asdict(ref), indent=2, default=str)
    assert configs.config_json(ours) == want
    assert ours.model.test_cfg.nms_pre == 64 and ours.data.data_root == "/data/x"
    for bad, err in (("model.no_such_field=1", KeyError), ("model.embed_dims", ValueError),
                     ("nothing.at_all=1", KeyError)):
        with pytest.raises(err):
            configs.apply_overrides(configs.get_config(name), [bad])
        with pytest.raises(err):
            jconfigs.apply_overrides(jconfigs.get_config(name), [bad])


# ---------------------------------------------------------------------------
# warm starts against the JAX converters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny SGCDet of the port and zero flax templates of the JAX one."""
    model = SGCDet(tiny_model_cfg(configs=configs), IMG_SHAPE, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    jm = JSGCDet(cfg=tiny_model_cfg(), img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.zeros((N_VIEWS, 3) + PAD), jnp.zeros((N_VIEWS, 3, 4)),
            jnp.zeros((N_VIEWS, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return model, zeros["params"], zeros["batch_stats"]


def _random_like(sd, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point()
                else v.clone()) for k, v in sd.items()}


def _fresh(model):
    """A copy of the tiny model, which no test changes."""
    return copy.deepcopy(model)


def _assert_state_equal(model, want):
    got = model.state_dict()
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, torch.as_tensor(want[k])), k


def test_load_from_lightning_ckpt_matches_jax(tiny, tmp_path):
    """A random Lightning checkpoint ('model.' keys, a loss buffer and an
    optimizer entry beside them, bn3 and downsample.1 of the matching
    extractor given different values): the port's load_torch_checkpoint
    equals the JAX package's load_torch_checkpoint + state_dict_from_flax,
    tensor for tensor."""
    model, params0, stats0 = tiny
    sd = _random_like(model.state_dict(), 1)
    ds1 = [k for k in sd if k.startswith("depth_head.fnet_mvs.") and ".downsample.1." in k]
    assert ds1
    for k in ds1:  # the pinned double registration: the converter reads bn3
        sd[k] = sd[k] + 5.0
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k] = sd[k].abs() + 0.5
    ckpt = {"state_dict": {**{f"model.{k}": v for k, v in sd.items()},
                           "loss_fn.weight": torch.ones(3)},
            "optimizer_states": [], "epoch": 3}
    path = tmp_path / "released.ckpt"
    torch.save(ckpt, path)

    port = _fresh(model)
    checkpoint.load_torch_checkpoint(str(path), port)
    params, stats = jcheckpoint.load_torch_checkpoint(str(path), params0, stats0)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, stats))
    _assert_state_equal(port, want)
    bn3 = [k.replace(".downsample.1.", ".bn3.") for k in ds1]
    assert all(torch.equal(port.state_dict()[k], sd[k]) for k in bn3)
    # a bare .pth in the reference's naming loads the same
    torch.save(sd, tmp_path / "bare.pth")
    bare = _fresh(model)
    checkpoint.load_torch_checkpoint(str(tmp_path / "bare.pth"), bare)
    _assert_state_equal(bare, port.state_dict())
    # a state dict that lacks an entry of the model is refused
    torch.save({k: v for k, v in sd.items() if not k.startswith("neck.")},
               tmp_path / "short.pth")
    with pytest.raises(KeyError, match="lacks"):
        checkpoint.load_torch_checkpoint(str(tmp_path / "short.pth"), bare)


def test_strip_lightning_prefix_matches_jax():
    sd = {"model.a.weight": 1, "model.b.model.c": 2, "loss.x": 3, "other_model.y": 4}
    assert checkpoint.strip_lightning_prefix(sd) == jcheckpoint.strip_lightning_prefix(sd)


def test_torchvision_warm_start_matches_jax(tiny, tmp_path):
    """Random torchvision resnet50 and resnet18 files: the backbone under
    ``backbone.`` without fc, the matching extractor's conv1/bn1/layer1/
    layer2 with downsample.1 aliased to bn3, everything else kept."""
    model, params0, stats0 = tiny
    own = model.state_dict()
    r50 = {k[len("backbone."):]: v for k, v in own.items() if k.startswith("backbone.")}
    r50 = _random_like(r50, 2)
    r50.update({"fc.weight": torch.randn(1000, 2048), "fc.bias": torch.zeros(1000)})
    pre = "depth_head.fnet_mvs."
    r18 = {k[len(pre):]: v for k, v in own.items() if k.startswith(pre)
           and not k.startswith(pre + "final_conv_3ddet") and ".bn3." not in k}
    r18 = _random_like(r18, 3)
    r18.update({"layer3.0.conv1.weight": torch.randn(256, 128, 3, 3),
                "fc.weight": torch.randn(1000, 512)})
    for name, sd in (("r50.pth", r50), ("r18.pth", r18)):
        torch.save(sd, tmp_path / name)

    port = _fresh(model)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    checkpoint.load_torchvision_pretrained(port, str(tmp_path / "r50.pth"),
                                           str(tmp_path / "r18.pth"))
    base = {k: v.numpy() for k, v in before.items()}
    p, s = jcheckpoint.convert_torch_state_dict(base, params0, stats0)
    params, stats = jcheckpoint.load_torchvision_pretrained(
        p, s, backbone_path=str(tmp_path / "r50.pth"),
        matching_path=str(tmp_path / "r18.pth"))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, stats))
    _assert_state_equal(port, want)
    after = port.state_dict()
    assert torch.equal(after["backbone.layer4.2.conv3.weight"], r50["layer4.2.conv3.weight"])
    assert torch.equal(after[pre + "layer2.0.bn3.weight"], r18["layer2.0.downsample.1.weight"])
    kept = [k for k in after if k.startswith(pre + "final_conv_3ddet") or k.startswith("neck.")]
    assert kept and all(torch.equal(after[k], before[k]) for k in kept)


# ---------------------------------------------------------------------------
# show mode
# ---------------------------------------------------------------------------

def _show_inputs():
    rng = np.random.RandomState(5)
    scene = example_scene(IMG_SHAPE, PAD, 3, rng=rng, trajectory="ring")
    centres = rng.uniform(-0.6, 0.6, (5, 3)).astype(np.float32)
    centres[:, 2] += 0.8
    boxes = np.concatenate([centres, rng.uniform(0.3, 0.9, (5, 3)),
                            rng.uniform(-1, 1, (5, 1))], 1).astype(np.float32)
    return scene, boxes, rng.rand(5).astype(np.float32), rng.randint(0, 4, 5)


@pytest.mark.parametrize("with_cv2", [True, False], ids=["cv2", "no_cv2"])
def test_visualize_matches_jax_bytes(tmp_path, monkeypatch, with_cv2):
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    scene, boxes, scores, labels = _show_inputs()
    mean, std = configs.scannet().data.mean, configs.scannet().data.std
    imgs = visualize.denormalize_images(scene["imgs"] * 40.0, mean, std)
    np.testing.assert_array_equal(
        imgs, jvisualize.denormalize_images(scene["imgs"] * 40.0, mean, std))
    proj = scene["proj_img"]
    for tag, width in (("aligned", 6), ("yawed", 7)):
        mk = [lambda b: DepthBoxes3D(b, box_dim=width, with_yaw=width == 7,
                                     origin=(0.5, 0.5, 0.5)),
              lambda b: JDepthBoxes3D(b, box_dim=width, with_yaw=width == 7,
                                      origin=(0.5, 0.5, 0.5))]
        for pkg, make, root in ((visualize, mk[0], tmp_path / f"port_{tag}"),
                                (jvisualize, mk[1], tmp_path / f"jax_{tag}")):
            det, gt = make(boxes[:, :width]), make(boxes[:2, :width] * 1.1)
            pkg.dump_show_results(str(root), "00007", det, scores, labels, gt)
            pkg.draw_scene_2d(str(root), "00007", imgs, proj, det, labels, gt)
        files = sorted(p.relative_to(tmp_path / f"port_{tag}")
                       for p in (tmp_path / f"port_{tag}").rglob("*") if p.is_file())
        suffix = ".png" if with_cv2 else ".png.npy"
        assert sum(str(f).endswith(suffix) for f in files) == 3
        assert len(files) == 4 + 3
        for f in files:
            assert (tmp_path / f"port_{tag}" / f).read_bytes() == \
                (tmp_path / f"jax_{tag}" / f).read_bytes(), f
        drawn = np.load(tmp_path / f"port_{tag}" / "00007/view_000.png.npy") \
            if not with_cv2 else None
        if drawn is not None:  # the endpoint fallback drew something
            assert not np.array_equal(drawn, imgs[0])


# ---------------------------------------------------------------------------
# checkpoint files and the optimizer's state
# ---------------------------------------------------------------------------

def _small_model(seed=0):
    """A few parameters under SGCDet's names of each optimizer group
    (frozen stem, backbone stage 2, the rest) and a BN's buffers."""
    model = torch.nn.Module()
    model.backbone = torch.nn.Module()
    model.backbone.conv1 = torch.nn.Conv2d(3, 4, 3)
    model.backbone.layer2 = torch.nn.Sequential(torch.nn.Conv2d(4, 8, 3),
                                                torch.nn.BatchNorm2d(8))
    model.neck = torch.nn.Linear(8, 5)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return model


def test_checkpoint_files(tmp_path, monkeypatch):
    model = _small_model()
    opt = make_optimizer(model, configs.TrainConfig())
    monkeypatch.chdir(tmp_path)
    assert checkpoint.latest_checkpoint("ck") is None
    for step in (9, 10):
        checkpoint.save_checkpoint("ck", model, opt, step)  # relative: made absolute
    assert (tmp_path / "ck/last").read_text() == "step_10"
    assert checkpoint.latest_checkpoint("ck") == "ck/step_10"
    # the pointer wins over the largest step
    (tmp_path / "ck/last").write_text("step_9")
    assert checkpoint.latest_checkpoint("ck") == "ck/step_9"
    # no pointer, or one to a missing file: the largest step (10 > 9)
    (tmp_path / "ck/last").write_text("step_99")
    assert checkpoint.latest_checkpoint("ck") == "ck/step_10"
    os.remove(tmp_path / "ck/last")
    assert checkpoint.latest_checkpoint("ck") == "ck/step_10"
    # a save at a step that has a file overwrites it
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.neck.weight.add_(1.0)
    checkpoint.save_checkpoint(str(tmp_path / "ck"), model, opt, 10)
    assert sorted(os.listdir(tmp_path / "ck")) == ["last", "step_10", "step_9"]
    fresh = _small_model(1)
    assert checkpoint.restore_checkpoint(str(tmp_path / "ck/step_10"), fresh) == 10
    _assert_state_equal(fresh, model.state_dict())
    assert checkpoint.restore_checkpoint("ck/step_9", fresh) == 9
    _assert_state_equal(fresh, saved)


def test_optimizer_state_dict_round_trip(tmp_path):
    """torch.save of the optimizer's state dict works, and 3 steps after a
    save and load equal 3 steps without one."""
    model = _small_model()
    assert {make_optimizer(model, configs.TrainConfig()).labels[n]
            for n, _ in model.named_parameters()} == {"frozen", "backbone", "other"}
    tcfg = configs.TrainConfig(lr=1e-3, training_steps=40)
    grads = []
    gen = torch.Generator().manual_seed(4)
    named = list(model.named_parameters())
    for _ in range(6):
        grads.append([torch.randn(p.shape, generator=gen) * 1e-2 for _, p in named])

    def run(steps, opt, m):
        params = dict(m.named_parameters())
        for g in steps:
            for (name, _), t in zip(named, g):
                params[name].grad = t.clone()
            opt.step()

    a, b = _small_model(), _small_model()
    opt_a, opt_b = make_optimizer(a, tcfg), make_optimizer(b, tcfg)
    run(grads[:3], opt_a, a)
    run(grads[:3], opt_b, b)
    torch.save({"model": b.state_dict(), "optimizer": opt_b.state_dict()}, tmp_path / "o.pt")
    c = _small_model(2)
    opt_c = make_optimizer(c, tcfg)
    state = torch.load(tmp_path / "o.pt", weights_only=True)
    c.load_state_dict(state["model"])
    opt_c.load_state_dict(state["optimizer"])
    assert opt_c.count == 3
    run(grads[3:], opt_a, a)
    run(grads[3:], opt_c, c)
    _assert_state_equal(c, a.state_dict())
    assert opt_c.count == opt_a.count == 6
    for g_a, g_c in zip(opt_a.adamw.param_groups, opt_c.adamw.param_groups):
        assert g_a["lr"] == g_c["lr"] and g_a["label"] == g_c["label"]
        for pa, pc in zip(g_a["params"], g_c["params"]):
            for k, v in opt_a.adamw.state[pa].items():
                assert torch.equal(v, opt_c.adamw.state[pc][k]), k
    with pytest.raises(ValueError, match="groups"):
        bad = opt_c.state_dict()
        bad["adamw"]["param_groups"] = bad["adamw"]["param_groups"][::-1]
        opt_c.load_state_dict(bad)


# ---------------------------------------------------------------------------
# the eval mode against the JAX package's run_eval
# ---------------------------------------------------------------------------

def test_run_eval_matches_jax(tmp_path):
    """The same weights (the port's seeded init, converted) on the same
    on-disk val set at f32: equal mAP dicts, and the show dumps (corners,
    scores, labels of every scene) equal within f32 rounding."""
    data = write_scannet_set(tmp_path / "data", n_train=1)
    overrides = CLI_OVERRIDES + [f"data.data_root={data}", "model.compute_dtype=float32"]
    cfg = configs.apply_overrides(configs.get_config("scannet"), overrides)
    jcfg = jconfigs.apply_overrides(jconfigs.get_config("scannet"), overrides)
    model = SGCDet(cfg.model, cfg.data.img_shape, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    val_ds, _ = cli.build_dataset_and_loader(cfg, False, 1, 0, 0)
    jval_ds, _ = jcli.build_dataset_and_loader(jcfg, False, 1, 0, 0)

    jm = JSGCDet(cfg=jcfg.model, img_shape=jcfg.data.img_shape, query_chunk=None)
    ex = val_ds[0]
    args = [jnp.asarray(ex[k]) for k in ("imgs", "proj_img", "proj_feat4", "origin")]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = jcheckpoint.convert_torch_state_dict(sd, zeros["params"],
                                                         zeros["batch_stats"])

    ret = cli.run_eval(cfg, model, val_ds, show_dir=tmp_path / "port", num_workers=1)
    jret = jcli.run_eval(jcfg, jm, params, stats, jval_ds, show_dir=tmp_path / "jax",
                         num_workers=1)
    assert ret.keys() == jret.keys() and len(ret) > 4
    for k in ret:
        assert ret[k] == pytest.approx(jret[k], abs=1e-6), k
    n_dets = 0
    for scene in ("00000", "00001"):
        for kind in ("pred_corners", "gt_corners", "scores", "labels"):
            got = np.load(tmp_path / "port" / f"{scene}_{kind}.npy")
            want = np.load(tmp_path / "jax" / f"{scene}_{kind}.npy")
            assert got.shape == want.shape, (scene, kind)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=kind)
        n_dets += len(np.load(tmp_path / "port" / f"{scene}_labels.npy"))
    assert n_dets > 0


# ---------------------------------------------------------------------------
# the CLI end to end (its subprocesses started with the module)
# ---------------------------------------------------------------------------

def test_cli_train_artefacts(cli_runs):
    root, _, _, _ = cli_runs
    log_dir = root / "logs/a"
    cfg_dump = json.loads((log_dir / "config.json").read_text())
    assert cfg_dump["model"]["embed_dims"] == 16  # overrides reached the dump
    lines = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    train = [line for line in lines if "train/loss" in line]
    assert train and train[0]["step"] == 2 and np.isfinite(train[0]["train/loss"])
    val = [line for line in lines if "val/mAP_0.25" in line]
    assert len(val) == 1 and val[0]["step"] == 2  # the eval at the epoch's end
    assert (log_dir / "ckpt/step_2").is_file() and (log_dir / "ckpt/step_4").is_file()
    assert (log_dir / "ckpt/last").read_text() == "step_4"


def test_cli_eval_and_show(cli_runs):
    root, out_eval, out_show, _ = cli_runs
    for out in (out_eval, out_show):
        ret = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
        assert set(ret) == {"mAP_0.25", "mAR_0.25", "mAP_0.50", "mAR_0.50"}
        assert all(np.isfinite(v) for v in ret.values())
    show = root / "logs/a_show/show"
    for scene in ("00000", "00001"):
        for kind in ("pred_corners", "gt_corners", "scores", "labels"):
            assert (show / f"{scene}_{kind}.npy").is_file(), (scene, kind)
        renders = sorted((show / scene).glob("view_*.png"))
        assert len(renders) == 4  # one per test view (cv2 on this host)


def test_cli_resume_is_bit_equal(cli_runs):
    """2 steps, then --resume to 4 == 4 steps in one run."""
    root, _, _, _ = cli_runs
    a = torch.load(root / "logs/a/ckpt/step_4", weights_only=True)
    b = torch.load(root / "logs/b/ckpt/step_4", weights_only=True)
    assert a["step"] == b["step"] == 4
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"] == 4
    assert oa["adamw"]["state"].keys() == ob["adamw"]["state"].keys()
    for i, sa in oa["adamw"]["state"].items():
        for k, v in sa.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k]), (i, k)
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]
    assert (root / "logs/b/ckpt/last").read_text() == "step_4"
    # and the run did train: step 4's weights are not step 2's
    s2 = torch.load(root / "logs/a/ckpt/step_2", weights_only=True)["model"]
    assert any(not torch.equal(s2[k], a["model"][k]) for k in s2)


def test_cli_refusals(tmp_path, monkeypatch, cli_runs):
    """``--sweep_band`` (refused until the port had the banded sweep): an
    int is the model's band, ``auto`` the band the JAX CLI picks on the same
    val set (the JAX package's ``required_sweep_band`` over its
    ``scene_poses``, kept up to 20 rows), and both evals score; the
    default device still refuses without a card."""
    root, _, _, bands = cli_runs
    for out in bands.values():
        ret = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
        assert all(np.isfinite(v) for v in ret.values())
    assert "model sweep_band: 16" in bands["band16"]
    jcfg = jconfigs.apply_overrides(jconfigs.get_config("scannet"), CLI_OVERRIDES + [
        f"data.data_root={root / 'data'}"])
    from sgcdet_tpu.data import MultiViewDataset as JMultiViewDataset
    from sgcdet_tpu.utils.visibility import required_sweep_band as j_required_sweep_band

    ds = JMultiViewDataset(jcfg.data, train=False, load_depth=False, seed=0)
    h4, w4 = jcfg.data.img_shape[0] // 4, jcfg.data.img_shape[1] // 4
    band = max(j_required_sweep_band(ds.scene_poses(i)[2], ds.scene_poses(i)[2].shape[0],
                                     jcfg.model, (h4, w4)) for i in range(len(ds)))
    want = band if band <= 20 else None
    assert f"auto sweep band (exact over {len(ds)} scenes): {band}" in bands["band_auto"]
    assert f"model sweep_band: {want}" in bands["band_auto"]
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config", "scannet"])
    assert not (tmp_path / "logs").exists()  # refused before writing anything
