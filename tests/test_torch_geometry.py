"""The port's own copies of the JAX package's NumPy helpers, held against
the originals, so the port (and chip_smoke.py) runs without the JAX package:

* ``configs.scannet()`` field by field, the train path's fields (dropout,
  FCOS assignment, losses, GT padding, ``TrainConfig``) included;
* ``voxel_grid`` and ``visibility.derive_visibility_budgets``, bit for bit;
* ``view_transformer.compact_queries`` against ``jax.lax.top_k`` on the 0/1
  visibility scores, as the JAX DeformCrossAttention selects.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgcdet_tpu import configs as jconfigs
from sgcdet_tpu.geometry import voxel_grid as jgrid
from sgcdet_tpu.utils.visibility import derive_visibility_budgets as jax_budgets

from sgcdet_tpu_torch import configs, voxel_grid
from sgcdet_tpu_torch.models.view_transformer import compact_queries, point_sampling
from sgcdet_tpu_torch.scene import example_scene
from sgcdet_tpu_torch.visibility import derive_visibility_budgets

from torch_port_tiny import (  # noqa: F401 (keep_global_torch_rng is autouse)
    IMG_SHAPE,
    PAD,
    keep_global_torch_rng,
    tiny_model_cfg,
)


@pytest.mark.parametrize("section", ["model", "model.test_cfg", "data", "train"])
def test_scannet_config_matches_jax(section):
    ours, ref = configs.scannet(), jconfigs.scannet()
    for name in section.split("."):
        ours, ref = getattr(ours, name), getattr(ref, name)
    for f in dataclasses.fields(ours):
        if dataclasses.is_dataclass(getattr(ours, f.name)):
            continue
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    if section == "model":
        for prop in ("depth_channels", "n_voxels", "voxel_size"):
            assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("n_voxels,voxel_size", [
    ((10, 10, 4), (0.64, 0.64, 0.8)),
    ((20, 20, 8), (0.32, 0.32, 0.4)),
    ((40, 40, 16), (0.16, 0.16, 0.2)),
    ((80, 80, 32), (0.08, 0.08, 0.1)),
])
def test_voxel_centers_match_jax(n_voxels, voxel_size):
    ours = voxel_grid.voxel_centers_zero_origin(n_voxels, voxel_size)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, jgrid.voxel_centers_zero_origin(n_voxels, voxel_size))


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("intr_size", [3, 4])
def test_compute_projection_matches_jax(stride, intr_size):
    rng = np.random.RandomState(stride + intr_size)
    intr = rng.uniform(100, 1000, (intr_size, intr_size)).astype(np.float32)
    exts = rng.randn(5, 4, 4).astype(np.float32)
    ours = voxel_grid.compute_projection(intr, exts, 968, 239, stride)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(
        ours, jgrid.compute_projection(intr, exts, 968, 239, stride))


@pytest.mark.parametrize("trajectory", ["ring", "indoor"])
@pytest.mark.parametrize("tiny", [False, True], ids=["scannet", "tiny"])
def test_visibility_budgets_match_jax(trajectory, tiny):
    if tiny:
        ours_cfg = tiny_model_cfg(configs=configs)
        ref_cfg = tiny_model_cfg()
        img_shape, pad, n_views = IMG_SHAPE, PAD, 4
    else:
        ours_cfg, ref_cfg = configs.scannet().model, jconfigs.scannet().model
        img_shape, pad, n_views = (239, 320), (240, 320), 40
    scenes = [example_scene(img_shape, pad, n_views, rng=np.random.RandomState(i),
                            trajectory=trajectory) for i in range(2)]
    pairs = [(s["origin"], s["proj_img"]) for s in scenes]
    ours = derive_visibility_budgets(pairs, img_shape, ours_cfg)
    assert ours == jax_budgets(pairs, img_shape, ref_cfg)
    assert all(0.0 < b <= 1.0 for b in ours)


@pytest.mark.parametrize("budget", [None, 0.05, 0.3, 0.5, 0.99])
def test_compact_queries_matches_jax_top_k(budget):
    """The indoor rig's visibility at a 2048-voxel level: selected indices,
    their order (visible first, index order among ties) and the counts."""
    scene = example_scene(IMG_SHAPE, PAD, 4, trajectory="indoor")
    ref = torch.from_numpy(voxel_grid.voxel_centers_zero_origin(
        (16, 16, 8), (0.16, 0.16, 0.2)))
    _, mask = point_sampling(ref, torch.from_numpy(scene["origin"]),
                             torch.from_numpy(scene["proj_img"]), IMG_SHAPE,
                             (0.2, 3.4, 0.4))
    k = mask.shape[1]
    assert 0 < int(mask.sum()) < mask.numel()
    got = compact_queries(mask, budget)
    kept = None if budget is None else min(k, max(128, -(-int(k * budget) // 128) * 128))
    if kept is None or kept == k:
        assert got is None
        return
    sel_idx, counts = got
    _, j_idx = jax.lax.top_k(jnp.asarray(mask.numpy().astype(np.float32)), kept)
    np.testing.assert_array_equal(sel_idx.numpy(), np.asarray(j_idx))
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(),
                                  np.minimum(mask.sum(1).numpy(), kept))
