"""The FLOP counter against hand counts, and the frozen bound helpers
against chip_smoke.py's at the geometries of PERF.md's kernel table."""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from bounds import attention as B
from flops.model import attention_flops, conv_linear_flops, forward_flops, train_flops
from reference import aadensenet, wideresnet

BENCH = Path(__file__).resolve().parent.parent


def cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


class OneConv:
    """A reference-like module: one 3x3 conv (stride 2) then a linear."""

    @staticmethod
    def shapes(c):
        return {"w": ((8, 3, 3, 3), "conv"), "fc.weight": ((5, 8), "linear"),
                "fc.bias": ((5,), "zeros")}

    @staticmethod
    def forward(P, x, c, train, precision="f32"):
        y = torch.nn.functional.conv2d(x, P["w"], stride=2, padding=1)
        return y.mean(dim=(2, 3)) @ P["fc.weight"].t() + P["fc.bias"]

    @staticmethod
    def aa_layers(c):
        return []


def test_conv_and_linear_by_hand():
    c = {"image_size": 16}
    # 8 outputs x 8x8 positions x 27 multiply-adds, and 8 x 5
    assert conv_linear_flops(OneConv, c) == 2 * 8 * 64 * 27 + 2 * 8 * 5
    assert conv_linear_flops(OneConv, c, batch=3) == 3 * (2 * 8 * 64 * 27 + 2 * 8 * 5)
    assert train_flops(OneConv, c) == 3 * forward_flops(OneConv, c)


def test_attention_by_hand():
    layer = {"map": (4, 2), "nh": 2, "dk": 6, "dv": 4, "relative": True}
    hw = 8
    per_head = hw * (2 * hw * 3 + 2 * hw * 2 + 2 * 3 * (2 + 4))
    assert attention_flops(layer) == 2 * per_head
    assert attention_flops(dict(layer, relative=False)) == 2 * hw * (2 * hw * 3 + 2 * hw * 2)


def test_wrn28_10_matches_its_published_count():
    # WideResNet-28-10 on CIFAR: 5.25 G multiply-adds (36.5 M parameters);
    # the AA convs here replace 8 of its 3x3 convs, within a few percent
    c = cfg("wrn28-10-aa-hil")
    f = forward_flops(wideresnet, c)
    assert 0.9 * 10.5e9 < f < 1.1 * 10.5e9
    n = sum(math.prod(s) for k, (s, kind) in wideresnet.shapes(c).items()
            if kind not in ("count",) and not k.endswith(("running_mean", "running_var")))
    assert 0.9 * 36.5e6 < n < 1.1 * 36.5e6


def test_aadensenet121_layers():
    c = cfg("aadensenet121")
    layers = [layer for _, layer in aadensenet.aa_layers(c)]
    assert [(l["map"], l["dk"] // l["nh"], l["dv"] // l["nh"]) for l in layers] == [
        ((40, 40), 20, 1), ((20, 20), 20, 3), ((10, 10), 20, 6)]
    # DenseNet-121 at 224x224 is 2.87 G multiply-adds; at 320x320 twice that
    f = conv_linear_flops(aadensenet, c)
    assert 0.85 * 2 * 2.87e9 * (320 / 224) ** 2 < f < 1.15 * 2 * 2.87e9 * (320 / 224) ** 2


def test_wrn_heads():
    layers = [layer for _, layer in wideresnet.aa_layers(cfg("wrn28-10-aa-hil"))]
    assert len(layers) == 8
    assert {(l["map"], l["dk"] // l["nh"], l["dv"] // l["nh"]) for l in layers} == {
        ((16, 16), 20, 4), ((8, 8), 20, 8)}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds",
                                                  BENCH.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.sm_clock_mhz = lambda: 1980.0
    return mod


# (batch, heads, H, W, dvh, dkh): aadensenet121 served / trained, aaresnet152
# at batch 16, the CIFAR bench at batch 256, a wide head
GEOS = [(4, 8, 40, 40, 1, 20), (16, 8, 20, 20, 3, 20), (16, 8, 10, 10, 6, 20),
        (256, 8, 16, 16, 4, 20), (256, 8, 8, 8, 8, 20), (256, 2, 16, 16, 64, 160)]


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("geo", GEOS)
def test_bounds_equal_chip_smoke(smoke, geo):
    bsz, nh, H, W, dvh, dkh = geo
    slot = 2 * dkh + dvh
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        _same(B.b1_bound(bsz * nh, H, W, dvh, name, dkh),
              smoke.b1_bound(bsz * nh, H, W, dvh, dt, dkh))
        _same(B.b2_bounds(bsz * nh, H, W, dvh, name, dkh),
              smoke.b2_bounds(bsz * nh, H, W, dvh, dt, dkh))
        _same(B.b5_bound(bsz, nh, H, W, dvh, slot, name, dkh),
              smoke.b5_bound(bsz, nh, H, W, dvh, slot, dt, dkh))
        _same(B.b6_bounds(bsz, nh, H, W, dvh, slot, name, dkh),
              smoke.b6_bounds(bsz, nh, H, W, dvh, slot, dt, dkh))


def test_exp_rate_is_fixed():
    # one exp per pair at 16 per SM and clock, 132 SMs, 1980 MHz
    b = B.bound(0, 0, "bf16", 16 * 132 * 1980e6)
    assert b["exp_ms"] == pytest.approx(1000.0) and b["bound_by"] == "exp"


def test_step_bound_sums_each_call():
    layer = {"map": (16, 16), "nh": 8, "dk": 160, "dv": 32, "relative": True}
    f, b = B.layer_bounds_ms(layer, 256, "hil")
    assert B.step_bound_ms([(4, layer)], 256, "hil") == pytest.approx(4 * (f + b))
