"""ResNet-50's frozen BN epilogue (``ops/frozen_bn.py``) on the CPU, where it
is the plain version:

* ``BatchNorm2d.fused`` (frozen BN, + identity, ReLU as one op) equals the
  sequence the model ran before it, conv -> ``_F32BatchNorm`` (f32 batch
  norm, cast back) -> add -> ReLU, bit for bit in the output and in the
  gradients of x, the identity, the BN's weight and bias and the conv's
  weight, at f32 and bf16, with and without the identity and the ReLU, on
  contiguous and channels-last inputs;
* the backward kernel's plain version (given the forward's y) against
  autograd of that sequence;
* ``ResNet50`` equals the earlier module-by-module forward bit for bit on
  NCHW input, and on channels-last input (the card's layout) gives the same
  outputs within oneDNN's rounding, channels-last; the ``FPN`` levels leave
  contiguous (N, C, H, W); the ``state_dict`` keys are the torchvision
  names;
* the nearest resize keeps a channels-last input's layout and values;
* a trainable BN refuses ``fused``, and the tracing counters count running-
  statistics BNs (``bn.running``) and no kernel call (``bn.fused``) here.
"""
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from sgcdet_tpu_torch import tracing
from sgcdet_tpu_torch.models.fpn import FPN
from sgcdet_tpu_torch.models.layers import (BatchNorm2d, Conv2d, init_weights,
                                            interpolate_nearest_size, set_compute_dtype)
from sgcdet_tpu_torch.models.resnet import ResNet50
from sgcdet_tpu_torch.ops.frozen_bn import frozen_bn_bwd_plain, frozen_bn_plain

from torch_port_tiny import keep_global_torch_rng  # noqa: F401 (autouse)

CL = torch.channels_last


def _bn(c, gen):
    """A frozen BN with seeded statistics and affine away from 1 and 0."""
    bn = BatchNorm2d(c, frozen=True)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=gen) * 0.2)
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=gen) * 2 + 0.25)
    return bn


def _todays_bn(bn, x):
    """The frozen BN's forward before the fused op (layers.py)."""
    y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, bn.momentum, bn.eps)
    return y.to(x.dtype)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_is_todays_sequence(dtype, identity, relu, layout):
    gen = torch.Generator().manual_seed(0)
    conv = Conv2d(8, 16, 3, padding=1, bias=False)
    init_weights(conv, gen)
    set_compute_dtype(conv, dtype)
    bn = _bn(16, gen)
    fmt = CL if layout == "channels_last" else torch.contiguous_format
    x = torch.randn(2, 8, 5, 7, generator=gen).contiguous(memory_format=fmt).requires_grad_()
    ident = (torch.randn(2, 16, 5, 7, generator=gen).to(dtype).contiguous(memory_format=fmt)
             .requires_grad_() if identity else None)
    g = torch.randn(2, 16, 5, 7, generator=gen).to(dtype)

    def today():
        y = _todays_bn(bn, conv(x))
        if identity:
            y = y + ident
        return F.relu(y) if relu else y

    names, leaves = zip(*[(n, t) for n, t in (("x", x), ("identity", ident),
                                               ("weight", bn.weight), ("bias", bn.bias),
                                               ("conv", conv.weight)) if t is not None])
    outs = []
    for run in (today, lambda: bn.fused(conv(x), ident, relu=relu)):
        y = run()
        outs.append((y, torch.autograd.grad(y, leaves, g)))
    (y0, g0), (y1, g1) = outs
    assert y1.dtype == dtype and torch.equal(y1, y0)
    for name, a, b in zip(names, g1, g0):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_version_is_autograds(dtype, relu, identity):
    gen = torch.Generator().manual_seed(1)
    bn = _bn(16, gen)
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    x = torch.randn(3, 16, 4, 6, generator=gen).mul(2).to(dtype).requires_grad_()
    ident = torch.randn(3, 16, 4, 6, generator=gen).to(dtype).requires_grad_()
    g = torch.randn(3, 16, 4, 6, generator=gen).to(dtype)
    y = frozen_bn_plain(x, ident if identity else None, *params, relu)
    leaves = [x, ident, bn.weight, bn.bias] if identity else [x, bn.weight, bn.bias]
    want = dict(zip(["x", "identity", "weight", "bias"] if identity else ["x", "weight", "bias"],
                    torch.autograd.grad(y, leaves, g)))
    dx, d_id, d_w, d_b = frozen_bn_bwd_plain(g, x.detach(), y.detach(), bn.weight,
                                             bn.running_mean, bn.running_var, bn.eps,
                                             relu, identity)
    # dx rounds once from f32 in both; the affine's sums differ in order only
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert ((dx.float() - want["x"].float()).abs()
            <= ulp * want["x"].float().abs() + 1e-7).all()
    assert (d_id is None) == (not identity)
    if identity:
        assert torch.equal(d_id, want["identity"])
    torch.testing.assert_close(d_b, want["bias"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_w, want["weight"], rtol=1e-5, atol=1e-5)


def _todays_resnet(m, x):
    """ResNet50.forward before the fused op, module by module."""
    def block(b, x):
        identity = x if b.downsample is None else _todays_bn(b.downsample[1],
                                                             b.downsample[0](x))
        out = F.relu(_todays_bn(b.bn1, b.conv1(x)))
        out = F.relu(_todays_bn(b.bn2, b.conv2(out)))
        return F.relu(_todays_bn(b.bn3, b.conv3(out)) + identity)

    x = F.max_pool2d(F.relu(_todays_bn(m.bn1, m.conv1(x))), 3, 2, 1)
    outs = []
    for s in range(1, 5):
        for b in getattr(m, f"layer{s}"):
            x = block(b, x)
        outs.append(x)
    return outs


@pytest.fixture(scope="module")
def trunk():
    gen = torch.Generator().manual_seed(2)
    backbone, fpn = ResNet50(), FPN(out_channels=32)
    init_weights(backbone, gen)
    init_weights(fpn, gen)
    with torch.no_grad():  # running statistics away from the identity
        for m in backbone.modules():
            if isinstance(m, BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    return backbone.eval(), fpn.eval(), torch.randn(2, 3, 48, 64, generator=gen)


def test_resnet_and_fpn_give_todays_outputs_in_both_layouts(trunk):
    backbone, fpn, imgs = trunk
    with torch.no_grad():
        want = _todays_resnet(backbone, imgs)
        got = backbone(imgs)
        last = backbone(imgs.contiguous(memory_format=CL))
        levels, levels_cl = fpn(got), fpn(last)
    for lvl, (a, b, c) in enumerate(zip(got, want, last)):
        assert torch.equal(a, b), f"stage {lvl + 1}"
        assert c.is_contiguous(memory_format=CL) and not c.is_contiguous()
        # oneDNN's channels-last convs sum in another order
        torch.testing.assert_close(c, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    for a, c in zip(levels, levels_cl):
        assert a.is_contiguous() and c.is_contiguous()
        torch.testing.assert_close(c, a, rtol=1e-4, atol=1e-5 * float(a.abs().max()))


def test_state_dict_keys_are_torchvisions():
    want = {f"{p}.weight" for p in ("conv1",)}
    bn = lambda p: {f"{p}.{k}" for k in ("weight", "bias", "running_mean", "running_var",  # noqa: E731
                                          "num_batches_tracked")}
    want |= bn("bn1")
    for s, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            p = f"layer{s}.{b}"
            for i in (1, 2, 3):
                want |= {f"{p}.conv{i}.weight"} | bn(f"{p}.bn{i}")
            if b == 0:
                want |= {f"{p}.downsample.0.weight"} | bn(f"{p}.downsample.1")
    assert set(ResNet50().state_dict()) == want


@pytest.mark.parametrize("size", [(8, 10), (15, 20), (6, 5)])
def test_nearest_resize_keeps_channels_last(size):
    x = torch.randn(2, 4, 4, 5, generator=torch.Generator().manual_seed(3))
    want = interpolate_nearest_size(x, size)
    got = interpolate_nearest_size(x.contiguous(memory_format=CL), size)
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)


def test_trainable_bn_refuses_fused_and_counters():
    with pytest.raises(ValueError, match="frozen"):
        BatchNorm2d(8).fused(torch.zeros(1, 8, 2, 2))
    bn, trainable = _bn(8, torch.Generator().manual_seed(4)), BatchNorm2d(8)
    x = torch.randn(2, 8, 3, 3)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bn(x)
        bn.fused(x, x, relu=True)
        trainable.train()(x)  # batch statistics: not counted
        trainable.eval()(x)
    counters = tracing.summary()["counters"]
    tracing.reset()
    assert counters == {"bn.running": 3}  # no kernel call on the CPU
