"""JAX-package parameters -> the port's ``state_dict``.

``state_dict_from_flax`` is the inverse of
sgcdet_tpu/train/checkpoint.py::convert_torch_state_dict: it takes the flax
``params`` and ``batch_stats`` trees (nested dicts of arrays; anything
``np.asarray`` accepts) and returns a ``state_dict`` in the reference's
naming, which ``SGCDet.load_state_dict`` loads.  Both packages then compute
the same function, which is how the tests hold the port against the JAX
reference.
"""
from __future__ import annotations

import numpy as np
import torch


def _conv(sd, key, node, ndim=2):
    """Conv kernel (*k, in, out) or ConvTranspose kernel (*k, out, in) ->
    torch (out, in, *k) / (in, out, *k): the same axis permutation."""
    w = np.asarray(node["kernel"])
    sd[f"{key}.weight"] = np.transpose(w, (ndim + 1, ndim) + tuple(range(ndim)))
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _bn(sd, key, pnode, snode):
    sd[f"{key}.weight"] = np.asarray(pnode["scale"])
    sd[f"{key}.bias"] = np.asarray(pnode["bias"])
    sd[f"{key}.running_mean"] = np.asarray(snode["mean"])
    sd[f"{key}.running_var"] = np.asarray(snode["var"])
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _linear(sd, key, node):
    sd[f"{key}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _backbone(sd, p, s):
    _conv(sd, "backbone.conv1", p["conv1"])
    _bn(sd, "backbone.bn1", p["bn1"], s["bn1"])
    for name in p:
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        tp = f"backbone.layer{stage}.{block}"
        for i in (1, 2, 3):
            _conv(sd, f"{tp}.conv{i}", p[name][f"conv{i}"])
            _bn(sd, f"{tp}.bn{i}", p[name][f"bn{i}"], s[name][f"bn{i}"])
        if "downsample_conv" in p[name]:
            _conv(sd, f"{tp}.downsample.0", p[name]["downsample_conv"])
            _bn(sd, f"{tp}.downsample.1", p[name]["downsample_bn"],
                s[name]["downsample_bn"])


def _fpn(sd, p):
    for name in p:
        kind, i = name.split("_")
        kind = {"lateral": "lateral_convs", "fpn": "fpn_convs"}[kind]
        _conv(sd, f"neck.{kind}.{i}.conv", p[name])


def _unet(sd, tp, p, s):
    for i in (1, 2, 3, 4):
        _conv(sd, f"{tp}.conv{i}.conv", p[f"conv{i}"]["conv"])
        _bn(sd, f"{tp}.conv{i}.bn", p[f"conv{i}"]["bn"], s[f"conv{i}"]["bn"])
    for i in (9, 11):
        _conv(sd, f"{tp}.conv{i}.0", p[f"deconv{i}"])
        _bn(sd, f"{tp}.conv{i}.1", p[f"debn{i}"], s[f"debn{i}"])


def _depth_head(sd, p, s):
    mp, ms = p["fnet_mvs"], s["fnet_mvs"]
    tp = "depth_head.fnet_mvs"
    _conv(sd, f"{tp}.conv1", mp["conv1"])
    _bn(sd, f"{tp}.bn1", mp["bn1"], ms["bn1"])
    for name in mp:
        if not name.startswith("layer"):
            continue
        layer, block = name.split("_")
        bp = f"{tp}.{layer}.{block}"
        for i in (1, 2):
            _conv(sd, f"{bp}.conv{i}", mp[name][f"conv{i}"])
            _bn(sd, f"{bp}.bn{i}", mp[name][f"bn{i}"], ms[name][f"bn{i}"])
        if "downsample_conv" in mp[name]:
            _conv(sd, f"{bp}.downsample.0", mp[name]["downsample_conv"])
            # one BN registered twice in the reference: as bn3 and downsample.1
            for alias in ("bn3", "downsample.1"):
                _bn(sd, f"{bp}.{alias}", mp[name]["bn3"], ms[name]["bn3"])
    _conv(sd, f"{tp}.final_conv_3ddet", mp["final_conv"])
    for unet in ("correlation_regulation", "mono_regulation", "fusion_regulation"):
        _unet(sd, f"depth_head.{unet}", p[unet], s[unet])
    _conv(sd, "depth_head.fnet_mono.conv", p["fnet_mono"]["conv"])
    _bn(sd, "depth_head.fnet_mono.bn", p["fnet_mono"]["bn"], s["fnet_mono"]["bn"])
    _conv(sd, "depth_head.depth_reg", p["depth_reg"])


def _view_transformer(sd, prefix, p):
    """One ViewTransformer tree (``layer{j}`` subtrees), DFA3D or 2D path:
    the 2D path's deformable attention has no ``sampling_offsets_depth``."""
    for layer_name, lp in p.items():
        j = layer_name[len("layer"):]
        tp = f"{prefix}cross_transformer.encoder.layers.{j}"
        at, af = f"{tp}.attentions.0", lp["cross_attn"]
        _linear(sd, f"{at}.output_proj", af["output_proj"])
        for lin, node in af["deformable_attention"].items():
            _linear(sd, f"{at}.deformable_attention.{lin}", node)
        mp = af["attention_pooling"]
        sd[f"{at}.attention_pooling.in_proj_weight"] = np.asarray(mp["in_proj_kernel"]).T
        sd[f"{at}.attention_pooling.in_proj_bias"] = np.asarray(mp["in_proj_bias"])
        _linear(sd, f"{at}.attention_pooling.out_proj", mp["out_proj"])
        _linear(sd, f"{tp}.ffns.0.layers.0.0", lp["ffn"]["fc1"])
        _linear(sd, f"{tp}.ffns.0.layers.1", lp["ffn"]["fc2"])
        for k in (0, 1):
            sd[f"{tp}.norms.{k}.weight"] = np.asarray(lp[f"norm{k + 1}"]["scale"])
            sd[f"{tp}.norms.{k}.bias"] = np.asarray(lp[f"norm{k + 1}"]["bias"])


def _voxel_head(sd, p):
    for name in p:
        if name.startswith("occ_pred_head"):
            i = name[len("occ_pred_head"):]
            _linear(sd, f"voxel_head.occ_pred_heads.{i}.0", p[name])
            continue
        i = name[len("base_head"):]
        _view_transformer(sd, f"voxel_head.base_heads.{i}.", p[name])


def _neck3d(sd, p, s):
    for name in p:
        kind, *idx = name.split("_")
        if kind == "down":
            tp = f"neck_3d.down_layer_{idx[0]}.{idx[1]}"
            for i in (1, 2):
                _conv(sd, f"{tp}.conv{i}", p[name][f"conv{i}"], ndim=3)
                _bn(sd, f"{tp}.norm{i}", p[name][f"norm{i}"], s[name][f"norm{i}"])
            if "down_conv" in p[name]:
                _conv(sd, f"{tp}.downsample.0", p[name]["down_conv"], ndim=3)
                _bn(sd, f"{tp}.downsample.1", p[name]["down_norm"],
                    s[name]["down_norm"])
        elif kind == "up":
            tp = f"neck_3d.up_block_{idx[0]}"
            _conv(sd, f"{tp}.0", p[name]["deconv"], ndim=3)
            _bn(sd, f"{tp}.1", p[name]["norm1"], s[name]["norm1"])
            _conv(sd, f"{tp}.3", p[name]["conv"], ndim=3)
            _bn(sd, f"{tp}.4", p[name]["norm2"], s[name]["norm2"])
        else:
            tp = f"neck_3d.out_block_{idx[0]}"
            _conv(sd, f"{tp}.0", p[name]["conv"], ndim=3)
            _bn(sd, f"{tp}.1", p[name]["norm"], s[name]["norm"])


def _bbox_head(sd, p):
    for conv in ("centerness_conv", "reg_conv", "cls_conv"):
        _conv(sd, f"bbox_head.{conv}", p[conv], ndim=3)
    for name in p:
        if name.startswith("scale"):
            sd[f"bbox_head.scales.{name[len('scale'):]}.scale"] = \
                np.asarray(p[name]).reshape(())


def state_dict_from_flax(params, batch_stats) -> dict:
    """Flax (params, batch_stats) of ``sgcdet_tpu.models.SGCDet`` (or any
    of its top-level submodule trees) -> the port's ``state_dict``."""
    stats = batch_stats or {}
    sd = {}
    if "backbone" in params:
        _backbone(sd, params["backbone"], stats["backbone"])
    if "neck" in params:
        _fpn(sd, params["neck"])
    if "depth_head" in params:
        _depth_head(sd, params["depth_head"], stats["depth_head"])
    if "voxel_head" in params:
        _voxel_head(sd, params["voxel_head"])
    if "neck_3d" in params:
        _neck3d(sd, params["neck_3d"], stats["neck_3d"])
    if "bbox_head" in params:
        _bbox_head(sd, params["bbox_head"])
    return _tensors(sd)


def view_transformer_state_dict_from_flax(params) -> dict:
    """Flax params of a standalone ``sgcdet_tpu.models.view_transformer
    .ViewTransformer`` (DFA3D or 2D path) -> the port's ``ViewTransformer``
    ``state_dict``."""
    sd = {}
    _view_transformer(sd, "", params)
    return _tensors(sd)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if k.endswith(
        "num_batches_tracked") else np.float32)) for k, v in sd.items()}
