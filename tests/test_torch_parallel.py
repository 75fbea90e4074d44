"""Data parallelism of the PyTorch port against the JAX package's mesh step,
on the CPU: two gloo processes of the port (``parallel.from_env`` from
torchrun's environment) against the JAX package on 2 of conftest's 8
virtual CPU devices.

* The synced BatchNorm at module level against the JAX ``BatchNorm`` under
  ``shard_map``: outputs, input and parameter gradients, running
  statistics; eval mode and frozen BNs do not communicate.
* One data-parallel train step (``make_train_step(..., group=...)``) of
  the tiny config of tests/test_torch_train.py on two different ring-rig
  scenes, from the port's seeded init converted to flax, against the JAX
  mesh step's body (``_scene_loss`` under ``shard_map`` with its pmeans):
  loss terms, n_pos, grad_norm, the averaged gradients after the clip and
  the BN running statistics, at that file's tolerances; the all-reduces it
  makes, counted; with ``depth_remat`` the same step, with one more
  all-reduce for each synced BN of the depth net.
* The per-rank scene order over 2 epochs of 5 scenes against the JAX
  package's single-host batch split, with equal step counts.
* The CLI under a 2-process gloo group (``--device cpu``): identical
  parameters on both ranks after training, the sharded eval's mAP (rank 0,
  through ``eval/gather.py``) equal to a 1-process eval's, and its shards
  read by the JAX package's ``load_shard`` (and a JAX shard by the
  port's) with the 1-process run's detections.
"""
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sgcdet_tpu.configs import config as jconfig
from sgcdet_tpu.data import loader as jloader
from sgcdet_tpu.eval import gather as jgather
from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.models import layers as jlayers
from sgcdet_tpu.train import loop as jloop
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.data import SceneLoader
from sgcdet_tpu_torch.eval import gather
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.parallel import COUNTS

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    CLI_OVERRIDES,
    IMG_SHAPE,
    N_VIEWS,
    PAD,
    PORT_ONLY,
    assert_close_scaled,
    bn_sync_case,
    keep_global_torch_rng,
    randomize_batch_stats,
    ring_scene_pairs,
    tiny_model_cfg,
    write_scannet_set,
)

HELPER = str(Path(__file__).with_name("torch_port_tiny.py"))
REPO = str(Path(__file__).resolve().parents[1])
INPUTS = ("imgs", "proj_img", "proj_feat4", "origin")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world, args, cwd, extra_env=None):
    """``world`` ranks of ``torch_port_tiny.py <args>``, as torchrun would
    start them (gloo on the CPU), a thread each: they run while this
    process compiles the JAX side."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=port, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), **(extra_env or {}))
        procs.append(subprocess.Popen([sys.executable, HELPER, *args], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        assert PORT_ONLY in out, out[-3000:]
        outs.append(out)
    return outs


def _cli_args(data, *flags):
    args = ["--cli", "--config", "scannet", "--data_root", str(data), "--num_workers", "1",
            "--device", "cpu", *flags]
    for ov in CLI_OVERRIDES:
        args += ["--override", ov]
    return args


def _cli_chain(root):
    """2 ranks train 2 steps (4 scenes: one epoch) with the sharded eval at
    its end; then one process shows step 2 over the 3 val scenes."""
    data = write_scannet_set(root / "data", n_train=4, n_val=3)
    (root / "dump").mkdir()
    _launch(2, _cli_args(data, "--mode", "train", "--log_folder", "dp", "--max_steps", "2"),
            root, {"SGCDET_TEST_DUMP": str(root / "dump")})
    out, = _launch(1, _cli_args(data, "--mode", "show", "--log_folder", "one",
                                "--ckpt_path", str(root / "logs/dp/ckpt/step_2")), root)
    return root, json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def _port_config():
    base = configs.scannet()
    mcfg = dataclasses.replace(tiny_model_cfg(configs=configs), ffn_dropout=0.0)
    return dataclasses.replace(base, model=mcfg, data=dataclasses.replace(
        base.data, img_shape=IMG_SHAPE, pad_size=PAD))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's seeded init with random BN statistics, as flax trees and
    as the port's state dict (written for the worker processes)."""
    jm = JSGCDet(cfg=tiny_model_cfg(), img_shape=IMG_SHAPE, query_chunk=None)
    args = [jnp.zeros((N_VIEWS, 3) + PAD), jnp.zeros((N_VIEWS, 3, 4)),
            jnp.zeros((N_VIEWS, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = SGCDet(_port_config().model, IMG_SHAPE, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_torch_state_dict(sd, zeros["params"], zeros["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = randomize_batch_stats(jax.tree_util.tree_map(np.asarray, stats), seed=3)
    path = tmp_path_factory.mktemp("weights") / "tiny.pt"
    torch.save(state_dict_from_flax(params, stats), path)
    return params, stats, path


@pytest.fixture(scope="module", autouse=True)
def _started(weights, tmp_path_factory):
    """The port's processes run while the JAX side compiles: the 2 DP
    workers, and the CLI's 2-process train and 1-process show."""
    pool = ThreadPoolExecutor(max_workers=2)
    roots = [tmp_path_factory.mktemp("dp"), tmp_path_factory.mktemp("cli")]
    futures = dict(
        dp=pool.submit(lambda: _launch(2, ["--dp", str(roots[0]), str(weights[2])], roots[0])
                       and [torch.load(roots[0] / f"rank{r}.pt", weights_only=True)
                            for r in range(2)]),
        cli=pool.submit(_cli_chain, roots[1]))
    yield futures
    pool.shutdown(wait=True)
    # the workers' results and the CLI's checkpoints take gigabytes
    for root in roots:
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


@pytest.fixture(scope="module")
def jax_mesh_step(weights, mesh):
    """The JAX package's mesh step up to its optimizer (loop.py:96-115:
    ``_scene_loss`` under shard_map, then the pmeans of the gradients,
    losses, total, BN statistics and n_pos), on a batch of two scenes."""
    params, stats, _ = weights
    jcfg = dataclasses.replace(
        jconfig.scannet(), model=dataclasses.replace(tiny_model_cfg(), ffn_dropout=0.0))
    jm = JSGCDet(cfg=jcfg.model, img_shape=IMG_SHAPE, query_chunk=None)

    def body(prm, st, b):
        scene = jax.tree_util.tree_map(lambda x: x[0], b)
        rng = jax.random.fold_in(jax.random.PRNGKey(1), jax.lax.axis_index("data"))
        loss_fn = jloop._scene_loss(jm, jcfg, prm, st, scene, rng, "data")
        (total, (losses, new_stats, n_pos)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(prm)
        mean = lambda t: jax.lax.pmean(t, "data")  # noqa: E731
        return mean(grads), mean(losses), mean(total), mean(new_stats), mean(n_pos)

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(), P("data")),
                             out_specs=P(), check_vma=False))

    def run(scenes):
        batch = {k: jnp.asarray(np.stack([s[k] for s in scenes])) for k in scenes[0]}
        # the JAX BatchNorm reads its sync axis at trace time
        jlayers.set_bn_sync_axis("data")
        try:
            return step(params, stats, batch)
        finally:
            jlayers.set_bn_sync_axis(None)

    return run


@pytest.mark.parametrize("pair", ["targets", "images"])
def test_dp_train_step_matches_jax_mesh_step(_started, weights, jax_mesh_step, pair):
    """Loss terms, n_pos, grad_norm, the gradients after the clip and the BN
    statistics at the tolerances of tests/test_torch_train.py.  The
    ``images`` pair, whose ranks sync different batch statistics, compares
    everything but the gradients: rounding decides them in this state (a
    1e-7 relative nudge of the images moves the JAX package's own by up to
    2 %, and the port's move under a change of thread count;
    ``ring_scene_pairs``); the ``targets`` pair compares every gradient."""
    params, stats, _ = weights
    scenes = ring_scene_pairs(_port_config().model)[pair]
    grads, losses, total, new_stats, n_pos = jax_mesh_step(scenes)
    ranks = [r[pair] for r in _started["dp"].result(timeout=600)]
    m0 = ranks[0]["metrics"]
    assert set(m0) == set(losses) | {"loss", "n_pos", "grad_norm"}
    assert float(m0["n_pos"]) == pytest.approx(float(n_pos)) and float(n_pos) > 0
    for name in list(losses) + ["loss"]:
        want = float(total if name == "loss" else losses[name])
        np.testing.assert_allclose(float(m0[name]), want, rtol=1e-4, err_msg=name)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    # optax.global_norm's value, summed on the host (no jit compile)
    norm = float(np.sqrt(sum(np.square(g, dtype=np.float64).sum()
                             for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(float(m0["grad_norm"]), norm, rtol=1e-3)
    scale = 1.0 if norm < 35.0 else 35.0 / norm
    g_sd = state_dict_from_flax(jax.tree_util.tree_map(lambda g: g * scale, grads), stats)
    for name, g in ranks[0]["grads"].items():
        assert torch.isfinite(g).all(), name
        if pair == "targets":
            assert_close_scaled(g.numpy(), g_sd[name].numpy(), 1e-3, f"grad {name}")
    s_sd = state_dict_from_flax(params, jax.tree_util.tree_map(np.asarray, new_stats))
    for name, buf in ranks[0]["stats"].items():
        assert_close_scaled(buf.numpy(), s_sd[name].numpy(), 1e-4, name)
    # both ranks hold the same metrics and, after the update, the same state
    for k in m0:
        assert torch.equal(m0[k], ranks[1]["metrics"][k]), k
    assert ranks[0]["digest"] == ranks[1]["digest"]
    # the all-reduces of the step: a forward and a backward one for each
    # train-mode BN that is not frozen, one each for n_pos, the gradients,
    # the metrics and the BN statistics; no collective of the view sharding
    counts, n_bn = ranks[0]["counts"], ranks[0]["n_bn"]
    assert n_bn > 20
    assert counts == dict(dict.fromkeys(COUNTS, 0), bn_sync=n_bn, bn_sync_backward=n_bn,
                          n_pos=1, gradients=1, metrics=1, bn_stats=1)


def test_dp_remat_step_equals_the_dp_step(_started):
    """The targets pair's DP step with ``depth_remat``: the same metrics and,
    on both ranks, the same state after the update as without it; its
    all-reduces are the step's plus one for each synced BN of the depth net
    when the backward recomputes it (the recomputation all-reduces the
    same statistics again and moves no running statistic)."""
    ranks = _started["dp"].result(timeout=600)
    for rank in ranks:
        remat, plain = rank["targets_remat"], rank["targets"]
        for k, v in plain["metrics"].items():
            assert torch.equal(remat["metrics"][k], v), k
        assert remat["digest"] == plain["digest"]
        n_bn, n_depth = plain["n_bn"], remat["n_depth_bn"]
        assert 10 < n_depth < n_bn
        assert remat["counts"] == dict(dict.fromkeys(COUNTS, 0), bn_sync=n_bn,
                                       bn_sync_backward=n_bn, bn_sync_recompute=n_depth,
                                       n_pos=1, gradients=1, metrics=1, bn_stats=1)


def test_synced_batchnorm_matches_jax(_started, mesh):
    xs, gs, p = bn_sync_case()
    jbn = jlayers.BatchNorm(axis_name="data")
    params = {"scale": p["scale"], "bias": p["bias"]}
    stats = {"mean": p["mean"], "var": p["var"]}

    def body(x, g):
        def loss(prm, xl):
            y, mut = jbn.apply({"params": prm, "batch_stats": stats}, xl, train=True,
                               mutable=["batch_stats"])
            return (y * g[0]).sum(), (y, mut["batch_stats"])

        (_, (y, new)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, x[0])
        return y[None], g_x[None], jax.lax.pmean(g_p, "data"), new

    y, g_x, g_p, new = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P(), P()), check_vma=False))(
            jnp.asarray(np.stack(xs)), jnp.asarray(np.stack(gs)))
    ranks = _started["dp"].result(timeout=600)
    for r, rank in enumerate(ranks):
        got = rank["bn"]
        assert rank["bn_quiet"], "an eval-mode or frozen BN communicated"
        assert_close_scaled(got["y"].numpy(), y[r], 1e-5, f"y rank {r}")
        assert_close_scaled(got["x_grad"].numpy(), g_x[r], 1e-5, f"x grad rank {r}")
        assert_close_scaled(got["weight_grad"].numpy(), g_p["scale"], 1e-5, "scale grad")
        assert_close_scaled(got["bias_grad"].numpy(), g_p["bias"], 1e-5, "bias grad")
        assert_close_scaled(got["running_mean"].numpy(), new["mean"], 1e-5, "running mean")
        assert_close_scaled(got["running_var"].numpy(), new["var"], 1e-5, "running var")
    # the sync moved the result: each rank's batch statistics alone differ
    alone = (xs[0] - xs[0].mean((0, 2, 3, 4), keepdims=True)) / np.sqrt(
        xs[0].var((0, 2, 3, 4), keepdims=True) + 1e-5)
    alone = alone * p["scale"].reshape(1, 6, 1, 1, 1) + p["bias"].reshape(1, 6, 1, 1, 1)
    assert np.abs(alone - ranks[0]["bn"]["y"].numpy()).max() > 0.1


class _Indices:
    """A dataset of 5 scenes whose items are their index."""

    def __len__(self):
        return 5

    def __getitem__(self, i):
        z = np.zeros(1, np.float32)
        return dict(imgs=z, proj_img=z, proj_feat4=z, origin=z, index=i)


def test_rank_scene_order_matches_jax_batch_split():
    """Rank r of 2 with one scene a step trains, at each step, the scene
    the JAX package's single-host loader with batch 2 puts at index r; both
    ranks take the same number of steps (5 scenes: 2 a rank, one dropped)."""
    kw = dict(shuffle=True, repeat_times=1, num_workers=0, seed=3, drop_last=True)
    jl = jloader.SceneLoader(_Indices(), batch_size=2, **kw)
    ranks = [SceneLoader(_Indices(), batch_size=1, host_id=r, num_hosts=2, **kw)
             for r in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(jl) == 2
    for epoch in range(2):
        want = [b["index"].tolist() for b in jl]
        got = [[int(b["index"][0]) for b in loader] for loader in ranks]
        assert len(got[0]) == len(got[1]) == len(want) == 2
        assert [list(pair) for pair in zip(*got)] == want, epoch
    assert want != [[0, 1], [2, 3]]  # shuffled


def test_two_process_cli_train_and_sharded_eval(_started):
    root, one = _started["cli"].result(timeout=600)
    # identical parameters and statistics on both ranks, and in the checkpoint
    r0, r1 = (torch.load(root / f"dump/rank{r}.pt", weights_only=True) for r in range(2))
    saved = torch.load(root / "logs/dp/ckpt/step_2", weights_only=True)
    assert saved["step"] == 2
    for k, v in r0.items():
        assert torch.equal(v, r1[k]) and torch.equal(v, saved["model"][k]), k
    # rank 0 logged the gathered eval; it equals the 1-process eval's
    lines = [json.loads(x) for x in (root / "logs/dp/metrics.jsonl").read_text().splitlines()]
    val = [x for x in lines if "val/mAP_0.25" in x]
    assert len(val) == 1 and val[0]["step"] == 2
    assert {k[4:]: v for k, v in val[0].items() if k.startswith("val/")} == one
    # the shards (rank 0: scenes 0 and 2, rank 1: scene 1) read by both
    # packages hold the 1-process run's detections
    gdir = root / "logs/dp/eval_gather/step_2"
    show = root / "logs/one/show"
    n_dets = 0
    for host, scenes in ((0, [0, 2]), (1, [1])):
        idx, dets = jgather.load_shard(str(gdir), host)
        pidx, pdets = gather.load_shard(str(gdir), host)
        assert idx == pidx == scenes
        for i, det, pdet in zip(idx, dets, pdets):
            corners = np.load(show / f"{i:05d}_pred_corners.npy")
            np.testing.assert_array_equal(det["boxes_3d"].corners, corners)
            np.testing.assert_array_equal(pdet["boxes_3d"].corners, corners)
            for key, kind in (("scores_3d", "scores"), ("labels_3d", "labels")):
                want = np.load(show / f"{i:05d}_{kind}.npy")
                np.testing.assert_array_equal(det[key], want)
                np.testing.assert_array_equal(pdet[key], want)
            n_dets += len(corners)
    assert n_dets > 0
    # a shard the JAX package writes loads in the port
    jgather.save_shard(str(root / "jax_gather"), 0, idx, dets)
    back_idx, back = gather.load_shard(str(root / "jax_gather"), 0)
    assert back_idx == idx
    np.testing.assert_array_equal(back[0]["boxes_3d"].tensor, dets[0]["boxes_3d"].tensor)
