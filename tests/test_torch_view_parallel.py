"""View sharding of the PyTorch port against the JAX package, on the CPU:
one scene's views split over two gloo processes of the port
(``train/loop.py::make_view_sharded_train_step`` and
``make_view_sharded_eval_step``, ``parallel.py``'s view collectives)
against the JAX package's view-sharded steps on 2 of conftest's 8 virtual
CPU devices, and against the port's single-process step and eval.  The
config and 4-view ring scene are tests/test_multichip.py's, with depth
maps and the depth loss on (``torch_port_tiny.view_config``,
``view_scene``).  Its boxes give no FCOS positive in this state, so the
head's positive branch is tests/test_torch_train.py's to hold.

* The train step (ffn_dropout 0) from the port's seeded init converted to
  flax, against JAX's: loss terms, n_pos, the norm of the trained
  parameters' clipped gradients (AdamW's first moment after JAX's step,
  mu / (1 - b1)), the parameters after the step and the BN running
  statistics.
* The eval forward against JAX's: head outputs, ``valid``, the depth
  distributions.
* Port against port: the 2-rank step (ffn_dropout 0 and 0.1, the latter's
  dropout masks recorded call by call) and eval against the single-process
  ones, and the step against the view-sharded step in a group of one
  process; the ranks' metrics, parameters, statistics and outputs
  bit-identical to each other; the collectives counted by kind; with
  ``depth_remat`` the same step, which gathers and syncs the depth net's
  BNs again in the backward.
* Module level: a BatchNorm2d over 4 views split 2 + 2 (its running
  variance takes the global count's unbiased factor), the depth net,
  whose end views take their sweep neighbours from the other rank, and the
  collectives themselves with their transposes.

The port's processes start when the module starts and run while the JAX
steps compile; each has its own timeout.
"""
import dataclasses
import os
import shutil
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sgcdet_tpu.models import SGCDet as JSGCDet
from sgcdet_tpu.train import loop as jloop
from sgcdet_tpu.train import optim as joptim
from sgcdet_tpu.train.checkpoint import convert_torch_state_dict

from sgcdet_tpu_torch import configs
from sgcdet_tpu_torch.convert import state_dict_from_flax
from sgcdet_tpu_torch.models import SGCDet
from sgcdet_tpu_torch.models.depth_net import get_closest_frame_ids
from sgcdet_tpu_torch.parallel import view_slice
from sgcdet_tpu_torch.train import param_label

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    PORT_ONLY,
    VIEW_IMG,
    VIEW_N,
    VIEW_PAD,
    assert_close_scaled,
    keep_global_torch_rng,
    launch_view_collectives,
    randomize_batch_stats,
    view_config,
    view_module_case,
    view_scene,
)

HELPER = str(Path(__file__).with_name("torch_port_tiny.py"))
REPO = str(Path(__file__).resolve().parents[1])
INPUTS = ("imgs", "proj_img", "proj_feat4", "origin")
# each process's own limit: a collective that one rank never joins fails
# the test instead of hanging it
PROCESS_TIMEOUT = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(out_dir, weights):
    """The 2 ranks of ``torch_port_tiny.py --view`` (gloo, as torchrun would
    start them) and the single process beside them; returns their records
    (rank 0, rank 1, single)."""
    port = str(_free_port())
    procs = []
    for rank, world in ((0, 2), (1, 2), (0, 1)):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=port, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world))
        procs.append(subprocess.Popen([sys.executable, HELPER, "--view", str(out_dir),
                                       str(weights)], cwd=out_dir, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROCESS_TIMEOUT)
            assert p.returncode == 0, out[-3000:]
            assert PORT_ONLY in out, out[-3000:]
    finally:
        for p in procs:
            p.kill()
    return [torch.load(out_dir / f"view_{name}.pt", weights_only=False)
            for name in ("rank0", "rank1", "single")]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's seeded init of ``view_config`` with random BN statistics,
    as flax trees and as the port's state dict (written for the
    processes)."""
    jm = JSGCDet(cfg=view_config().model, img_shape=VIEW_IMG, query_chunk=None)
    args = [jnp.zeros((VIEW_N, 3) + VIEW_PAD), jnp.zeros((VIEW_N, 3, 4)),
            jnp.zeros((VIEW_N, 4, 4)), jnp.zeros(3)]
    shapes = jax.eval_shape(lambda key: jm.init({"params": key}, *args, train=False),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = SGCDet(view_config(configs).model, VIEW_IMG, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_torch_state_dict(sd, zeros["params"], zeros["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = randomize_batch_stats(jax.tree_util.tree_map(np.asarray, stats), seed=3)
    path = tmp_path_factory.mktemp("view_weights") / "tiny.pt"
    torch.save(state_dict_from_flax(params, stats), path)
    return params, stats, path


@pytest.fixture(scope="module", autouse=True)
def _started(weights, tmp_path_factory):
    """The port's three processes, running while the JAX side compiles."""
    pool = ThreadPoolExecutor(max_workers=1)
    root = tmp_path_factory.mktemp("view")
    future = pool.submit(_launch, root, weights[2])
    yield future
    pool.shutdown(wait=True)
    shutil.rmtree(root, ignore_errors=True)  # the records hold two models' worth


@pytest.fixture(scope="module")
def runs(_started):
    return _started.result(timeout=2 * PROCESS_TIMEOUT)


@pytest.fixture(scope="module")
def jax_view(weights):
    """The JAX package's view-sharded train step (ffn_dropout 0) and eval
    on a 2-device ``view`` mesh, from the same weights and scene."""
    params, stats, _ = weights
    jcfg = view_config(ffn_dropout=0.0)
    jm = JSGCDet(cfg=jcfg.model, img_shape=VIEW_IMG, query_chunk=None)
    tx, _ = joptim.make_optimizer(params, jcfg.train)
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=stats, opt_state=tx.init(params))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("view",))
    scene = {k: jnp.asarray(v) for k, v in view_scene(jcfg.model.downsample_factor).items()}
    new_state, metrics = jloop.make_view_sharded_train_step(jm, jcfg, tx, mesh)(
        state, scene, jax.random.PRNGKey(5))
    out = jloop.make_view_sharded_eval_step(jm, jcfg, mesh)(
        params, stats, *(scene[k] for k in INPUTS))
    return jax.tree_util.tree_map(np.asarray, (new_state, metrics, out))


def _clipped_grads(opt_state, params):
    """The clipped gradients of the trained parameters after one JAX step:
    AdamW's first moment from zero is (1 - b1) g, b1 = 0.9; zeros for the
    frozen ones."""
    total = jax.tree_util.tree_map(np.zeros_like, params)
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    for label in ("backbone", "other"):
        mu = opt_state[1].inner_states[label].inner_state[0].mu
        total = jax.tree_util.tree_map(
            lambda m, t: t if masked(m) else t + np.asarray(m) / np.float32(0.1),
            mu, total, is_leaf=masked)
    return total


def test_view_train_step_matches_jax(runs, weights, jax_view):
    """tests/test_multichip.py's tolerances: loss terms within 1e-5,
    parameters after the step within 1e-4 (AdamW's first step moves each
    by about lr times the sign of its gradient); the BN running statistics
    within 1e-5 of their scale; the norm of the trained parameters' clipped
    gradients (AdamW's first moment after JAX's step, mu / (1 - b1); JAX's
    step returns no gradient norm) within 1e-3, tests/test_torch_parallel.py's
    bound on grad_norm.  Gradient by gradient the two packages are not held
    to each other here: rounding decides this config's depth-net gradients,
    where the JAX package's own view-sharded and single-device steps differ
    by more than 1e-3 of their scale.  The port's view step is held to its
    single-process step gradient by gradient (below)."""
    _, stats, _ = weights
    new_state, metrics, _ = jax_view
    got = runs[0]["step"]
    m = got["metrics"]
    assert set(m) == set(metrics) | {"grad_norm"}
    assert float(m["n_pos"]) == float(metrics["n_pos"])
    for name in metrics:
        assert abs(float(m[name]) - float(metrics[name])) < 1e-5, name
    want = state_dict_from_flax(new_state.params, new_state.batch_stats)
    state = got["state"]
    for name, value in want.items():
        if name.endswith(("running_mean", "running_var")):
            assert_close_scaled(state[name].numpy(), value.numpy(), 1e-5, name)
        elif name in state and not name.endswith("num_batches_tracked"):
            err = float((state[name] - value).abs().max())
            assert err < 1e-4, (name, err)
    g_sd = state_dict_from_flax(_clipped_grads(new_state.opt_state, weights[0]), stats)
    trained = [n for n in got["grads"] if param_label(n) != "frozen"]
    assert len(trained) > 100

    def norm(grads):
        return float(np.sqrt(sum(np.square(grads[n].numpy(), dtype=np.float64).sum()
                                 for n in trained)))

    np.testing.assert_allclose(norm(got["grads"]), norm(g_sd), rtol=1e-3)


def test_view_eval_matches_jax(runs, jax_view):
    """Head outputs within 5e-4 of their scale (tests/test_torch_slice.py's
    bound), the depth distributions within 1e-5, ``valid`` identical."""
    out = jax_view[2]
    for rank in runs[:2]:
        got = rank["eval"]
        np.testing.assert_array_equal(got["valid"].numpy(), out["valid"])
        assert_close_scaled(got["dpt_dist"].numpy(), out["dpt_dist"], 1e-5, "dpt_dist")
        for lvl, (a, b) in enumerate(zip(got["head_outs"], out["head_outs"])):
            for name, x, y in zip(("centerness", "bbox", "cls"), a, b):
                assert_close_scaled(x.numpy(), y, 5e-4, f"{name} level {lvl}")


@pytest.mark.parametrize("name", ["step", "dropout_step"])
def test_view_step_equals_single_process(runs, name):
    """The 2-rank step against the single-process step from the same
    weights and generator: every metric within 1e-5 of its scale; with
    dropout the same masks in every call on both ranks and in the single
    process; the ranks' metrics and states bit-identical.  For the
    dropout-free step also every parameter and statistic after the step
    within 1e-4 absolute (AdamW's first step moves each by lr times the
    sign of its gradient) and the clipped gradients:

    * every one within 1e-4 of its tensor's scale of the view-sharded step
      in a group of one process, which normalises the depth net's BNs by
      the same formula (E[x^2] - E[x]^2, the JAX package's, that the ranks
      sum moment by moment): the collectives and their transposes;
    * outside the depth net, within 1e-5 of the single-process step's.
      The depth net's BNs there take F.batch_norm's statistics, which
      round otherwise, and at this config's 4 x 5 U-Net bottoms rounding
      decides their gradients (tests/torch_port_tiny.py::ring_scene_pairs)."""
    r0, r1, single = (r[name] for r in runs)
    for k, v in single["metrics"].items():
        assert abs(float(r0["metrics"][k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1.0), k
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    assert r0["digest"] == r1["digest"]
    assert r0["masks"] == r1["masks"] == single["masks"]
    assert len(r0["masks"]) == (0 if name == "step" else 6)  # 2 FFN dropouts a level
    if name == "step":
        one = runs[2]["view1_step"]
        for k, v in single["metrics"].items():
            assert abs(float(one["metrics"][k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1.0), k
        for k, v in single["state"].items():
            if v.is_floating_point():
                assert float((r0["state"][k] - v).abs().max()) < 1e-4, k
        for k, want in single["grads"].items():
            got = r0["grads"][k].numpy()
            assert_close_scaled(got, one["grads"][k].numpy(), 1e-4, f"grad {k}, view step")
            if not k.startswith("depth_head."):
                assert_close_scaled(got, want.numpy(), 1e-5, f"grad {k}, single process")


def test_view_eval_equals_single_process(runs):
    """The 2-rank eval against ``infer.forward_scene``: ``valid`` and every
    output within 1e-5 of its scale; both ranks' outputs bit-identical."""
    r0, r1, single = (r["eval"] for r in runs)
    assert torch.equal(r0["valid"], single["valid"])
    for key in ("valid", "dpt_dist", "occ_preds"):
        assert torch.equal(r0[key], r1[key]), key
    assert_close_scaled(r0["dpt_dist"].numpy(), single["dpt_dist"].numpy(), 1e-5, "dpt")
    assert_close_scaled(r0["occ_preds"].numpy(), single["occ_preds"].numpy(), 1e-5, "occ")
    for a, b, c in zip(r0["head_outs"], r1["head_outs"], single["head_outs"]):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)
            assert_close_scaled(x.numpy(), z.numpy(), 1e-5, "head")


def test_view_collectives_counted(runs):
    """Each rank's collectives by kind: the depth net gathers its matching
    features and projections, the fusion each level's queries and mask, a
    gradient goes back through a reduce-scatter for each gathered tensor
    that has one (the features, 3 levels' queries), each train-mode BN of
    the depth net syncs once each way, the depth loss sums once each way
    and the gradients once; the eval gathers the depth distributions too
    and syncs no BN.  The single process makes none."""
    r0, r1, single = runs
    n_bn = r0["step"]["n_depth_bn"]
    assert n_bn > 20
    step = dict(view_gather=2, view_fusion=6, view_scatter=4, view_bn=n_bn,
                view_bn_backward=n_bn, view_depth_loss=1, view_depth_loss_backward=1,
                view_gradients=1)
    for rank in (r0, r1):
        assert rank["step"]["counts"] == step
        assert rank["dropout_step"]["counts"] == step
        assert rank["eval"]["counts"] == dict(view_gather=3, view_fusion=6)
        assert rank["bn"]["counts"] == dict(view_bn=1, view_bn_backward=1)
        assert rank["depth_net"]["counts"] == dict(view_gather=2, view_scatter=1,
                                                   view_bn=n_bn, view_bn_backward=n_bn)
    for name in ("bn", "depth_net", "step", "dropout_step", "remat_step", "eval"):
        assert single[name]["counts"] == {}, name
    assert single["view1_step"]["counts"] == step  # a group of one process


def test_view_remat_step_equals_view_step(runs):
    """The dropout step with ``depth_remat``: bit-equal metrics and state
    to the view step without it on both ranks; the backward's
    recomputation gathers the depth net's features and projections again
    and syncs each of its BNs again without moving their statistics."""
    for rank in runs[:2]:
        remat, plain = rank["remat_step"], rank["dropout_step"]
        for k, v in plain["metrics"].items():
            assert torch.equal(remat["metrics"][k], v), k
        assert remat["digest"] == plain["digest"]
        assert remat["masks"] == plain["masks"]
        n_bn = plain["n_depth_bn"]
        want = dict(plain["counts"], view_bn_recompute=n_bn)
        want["view_gather"] += 2
        assert remat["counts"] == want


def test_view_batchnorm_uses_the_global_count(runs):
    """A train-mode BatchNorm2d over 4 views, 2 a rank, against one BN over
    all 4: outputs, input and parameter gradients and running statistics
    within 1e-6 of their scale.  The running variance moves by the
    unbiased factor of the global count (80 a channel); the local count's
    (40) would move it by more than the tolerance."""
    bn, _ = view_module_case()
    r0, r1, single = (r["bn"] for r in runs)
    got = {k: torch.cat([r0[k], r1[k]]) for k in ("y", "x_grad")}
    for k in ("y", "x_grad"):
        assert_close_scaled(got[k].numpy(), single[k].numpy(), 1e-6, k)
    for k in ("param_grads", "running_mean", "running_var"):
        assert_close_scaled(r0[k].numpy(), single[k].numpy(), 1e-6, k)
        assert torch.equal(r0[k], r1[k]), k
    n = bn["x"][:2].size // 6 * 2
    var = bn["x"].transpose(1, 0, 2, 3).reshape(6, -1).var(1)
    local = 0.9 * bn["var"] + 0.1 * var * (n // 2) / (n // 2 - 1)
    assert np.allclose(r0["running_var"].numpy(), 0.9 * bn["var"] + 0.1 * var * n / (n - 1),
                       rtol=1e-5)
    assert np.abs(local - r0["running_var"].numpy()).max() > 1e-6 * np.abs(local).max() * 100


def test_view_depth_net_takes_neighbours_across_ranks(runs):
    """The depth net at module level in train mode, 2 views a rank: rank
    0's views sweep against views 1 and 3, 2 and 0 of the scene's 4 (so
    both of rank 0's reach rank 1), and the distributions, the feature and
    parameter gradients (the sweep's source gradient goes back to its
    owner through the reduce-scatter) and the BN statistics equal the
    single process's within 1e-5 of their scale."""
    table = get_closest_frame_ids(VIEW_N, 2)
    np.testing.assert_array_equal(table, [[1, 3], [0, 2], [1, 3], [0, 2]])
    assert (table[:2] >= 2).any(1).all() and (table[2:] < 2).any(1).all()
    r0, r1, single = (r["depth_net"] for r in runs)
    for k in ("dpt", "feats_grad"):
        assert_close_scaled(torch.cat([r0[k], r1[k]]).numpy(), single[k].numpy(), 1e-5, k)
    assert_close_scaled(r0["param_grads"].numpy(), single["param_grads"].numpy(), 1e-5,
                        "parameter gradients")
    for k, v in single["stats"].items():
        assert_close_scaled(r0["stats"][k].numpy(), v.numpy(), 1e-5, k)
        assert torch.equal(r0["stats"][k], r1["stats"][k]), k


def test_view_slice_cuts_view_keys_and_refuses_uneven_splits():
    scene = view_scene(configs.scannet().model.downsample_factor)
    part = view_slice(scene, 1, 2)
    for k, v in scene.items():
        if k in ("imgs", "proj_img", "proj_feat4", "gt_depth"):
            np.testing.assert_array_equal(part[k], v[2:])
        else:
            assert part[k] is v, k
    with pytest.raises(ValueError, match="4 views does not split into 3"):
        view_slice(scene, 0, 3)


def test_view_collectives_and_their_transposes():
    """``parallel.gather_views`` and ``sum_over_ranks`` in 2 gloo processes:
    the gather of f32, bf16 and bool slices equals their concatenation, its
    gradient is the sum of every rank's gradient of the slice, and the sum's
    gradient the sum of every rank's (tests/torch_port_tiny.py::
    _view_collectives_worker; tests/test_torch_cuda.py runs it on CUDA
    tensors)."""
    launch_view_collectives("cpu")
