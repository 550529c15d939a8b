"""The plain reference models, attention, loss, optimizer and input path
against the program at tiny sizes on the CPU, in float32: the reference
computes what the program computes."""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import weights
from reference import aadensenet, aaresnet, wideresnet
from reference.data import center_crop, cifar_augmented, radiograph_input
from reference.layers import rel_attention
from reference.train import bce_sum_mean, cross_entropy, lr_at, make

BENCH = Path(__file__).resolve().parent.parent
TINY_DN = {"image_size": 32, "stem": "cifar", "growth_rate": 8, "block_config": [2, 2],
           "num_init_features": 16, "bn_size": 4, "num_classes": 5,
           "attn": {"k": 0.25, "v": 0.25, "nh": 2, "relative": True, "min_dk_per_head": 20}}
TINY_RN = {"image_size": 64, "layers": [1, 1, 1, 1], "num_classes": 5,
           "init": {"branch_scale": 0.1},
           "attn": {"k": 0.2, "v": 0.1, "nh": 8, "relative": True, "min_dk_per_head": 20,
                    "stages": [2, 3, 4]}}
TINY_WRN = {"image_size": 32, "depth": 10, "width": 2, "num_classes": 10,
            "attn": {"k": 0.2, "v": 0.2, "nh": 2, "relative": True, "min_dk_per_head": 20}}


def _grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def _compare(ref, cfg, model, x, loss_ref, loss_prog):
    W = weights.make(ref.shapes(cfg), 3, "cpu")
    model.load_state_dict(W, strict=True)
    params = {k: v.clone().requires_grad_(True) for k, v in W.items()
              if k in dict(model.named_parameters())}
    P = dict(W, **params)
    model.train()
    out_p = model(x)
    out_r = ref.forward(P, x, cfg, train=True)
    torch.testing.assert_close(out_r, out_p, rtol=1e-4, atol=1e-5)
    gp = _grads(model, loss_prog(out_p))
    gr = dict(zip(params, torch.autograd.grad(loss_ref(out_r), list(params.values()))))
    # two float32 routes part in the early layers' gradients by up to a few
    # percent: at these sizes a 1e-7 change of the input moves the
    # reference's own early gradients by 2 %, so those are held loosely and
    # the last leaves, before any such point, tightly
    names = list(gp)
    for i, k in enumerate(names):
        gap = float((gr[k] - gp[k]).norm() / gp[k].norm().clamp(min=1e-30))
        assert gap < (1e-4 if i >= len(names) - 8 else 0.1), (k, gap)
    model.load_state_dict(W, strict=True)  # the train forward moved the running statistics
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(ref.forward(W, x, cfg, train=False), model(x),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["bn", "hil"])
def test_aadensenet_matches_the_program(layout):
    from chexpert_tpu_torch.models import build_model

    model = build_model("aadensenet-tiny", image_size=32, attn_layout=layout)
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    y = (torch.rand(3, 5, generator=torch.Generator().manual_seed(2)) < 0.5).float()
    mask = torch.ones(3)
    from chexpert_tpu_torch.train.loss import train_loss

    _compare(aadensenet, TINY_DN, model, x, lambda o: bce_sum_mean(o, y, mask),
             lambda o: train_loss(o, y, mask))


@pytest.mark.parametrize("layout", ["bn", "hil"])
def test_wideresnet_matches_the_program(layout):
    from chexpert_tpu_torch.models import AttnParams, WideResNet

    a = TINY_WRN["attn"]
    model = WideResNet(10, 2, num_classes=10, attn=AttnParams(a["k"], a["v"], a["nh"], True,
                                                              (32, 32)), attn_layout=layout)
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 7, 3])
    _compare(wideresnet, TINY_WRN, model, x, lambda o: cross_entropy(o, y),
             lambda o: torch.nn.functional.cross_entropy(o, y))


@pytest.mark.parametrize("layout", ["bn", "hil"])
def test_aaresnet_matches_the_program(layout):
    from chexpert_tpu_torch.models import AttnParams
    from chexpert_tpu_torch.models.resnet import ResNet
    from chexpert_tpu_torch.train.loss import train_loss

    a = TINY_RN["attn"]
    model = ResNet("bottleneck", (1, 1, 1, 1), num_classes=5,
                   attn=AttnParams(a["k"], a["v"], a["nh"], True, (64, 64)), attn_layout=layout)
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    y = (torch.rand(3, 5, generator=torch.Generator().manual_seed(2)) < 0.5).float()
    mask = torch.ones(3)
    _compare(aaresnet, TINY_RN, model, x, lambda o: bce_sum_mean(o, y, mask),
             lambda o: train_loss(o, y, mask))


def test_relative_attention_matches_the_program():
    from chexpert_tpu_torch.ops.attention import aa_attention_einsum

    g = torch.Generator().manual_seed(0)
    B, nh, H, W, dkh, dvh = 2, 3, 5, 4, 6, 2
    q, k = (torch.randn(B, nh, H * W, dkh, generator=g) for _ in range(2))
    v = torch.randn(B, nh, H * W, dvh, generator=g)
    rw, rh = torch.randn(dkh, 2 * W - 1, generator=g), torch.randn(dkh, 2 * H - 1, generator=g)
    want, _ = aa_attention_einsum(q, k, v, rw, rh, H, W)
    torch.testing.assert_close(rel_attention(q, k, v, rw, rh, H, W), want, rtol=1e-5, atol=1e-6)


OPTIMIZER_CASES = {
    "sgd_cosine": ({"kind": "sgd_nesterov", "momentum": 0.9, "weight_decay": 1e-2,
                    "warmup": "linear", "warmup_steps": 2, "schedule": "cosine", "cosine_steps": 5},
                   dict(kind="sgd_nesterov", schedule="cosine", weight_decay=1e-2),
                   dict(warmup_steps=2, warmup_style="linear", cosine_decay_steps=5)),
    "sgd_multistep": ({"kind": "sgd_nesterov", "momentum": 0.9, "weight_decay": 1e-2,
                       "warmup": "hold", "warmup_steps": 1, "schedule": "multistep",
                       "milestones": [2, 4]},
                      dict(kind="sgd_nesterov", schedule="multistep", milestones=(2, 4),
                           weight_decay=1e-2), dict(warmup_steps=1)),
    "adam_constant": ({"kind": "adam", "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 1e-2,
                       "warmup": "hold", "warmup_steps": 0, "schedule": "constant"},
                      dict(kind="adam", weight_decay=1e-2), {}),
    "adam_multistep": ({"kind": "adam", "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.0,
                        "warmup": "linear", "warmup_steps": 2, "schedule": "multistep",
                        "milestones": [1]},
                       dict(kind="adam", schedule="multistep", milestones=(1,)),
                       dict(warmup_steps=2, warmup_style="linear")),
    "rmsprop_exponential": ({"kind": "rmsprop", "decay": 0.99, "eps": 1e-3, "momentum": 0.9,
                             "weight_decay": 1e-2, "warmup": "hold", "warmup_steps": 0,
                             "schedule": "exponential", "decay_factor": 0.5, "decay_steps": 2},
                            dict(kind="rmsprop", schedule="exponential", decay_factor=0.5,
                                 decay_steps=2, weight_decay=1e-2), {}),
    "rmsprop_constant": ({"kind": "rmsprop", "decay": 0.99, "eps": 1e-3, "momentum": 0.9,
                          "weight_decay": 0.0, "warmup": "hold", "warmup_steps": 0,
                          "schedule": "constant"}, dict(kind="rmsprop"), {}),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_the_program(case):
    """The reference's optimizers (``make``) against torch.optim.SGD and
    torch.optim.Adam and the program's RMSpropLRInTrace, as the program's
    make_optimizer builds them, with weight decay and each schedule."""
    from chexpert_tpu_torch.models.registry import OptimizerSpec
    from chexpert_tpu_torch.train import make_optimizer

    ref_cfg, spec, kw = OPTIMIZER_CASES[case]
    opt_cfg = dict(ref_cfg, lr=0.1)
    p = torch.nn.Parameter(torch.randn(4, 3, generator=torch.Generator().manual_seed(0)))
    opt, sched, schedule = make_optimizer(OptimizerSpec(**spec), [p], 0.1, **kw)
    mine = {"p": p.detach().clone()}
    ref = make(mine, opt_cfg)
    for t in range(6):
        g = torch.randn(4, 3, generator=torch.Generator().manual_seed(t + 1))
        assert lr_at(opt_cfg, t) == pytest.approx(schedule(t))
        p.grad = g.clone()
        opt.step()
        sched.step()
        ref.step({"p": g})
        torch.testing.assert_close(mine["p"], p.detach(), rtol=1e-6, atol=1e-7)


def test_radiograph_input_matches_the_program(tmp_path):
    from PIL import Image

    from chexpert_tpu_torch.data.chexpert import PIXEL_MEAN, PIXEL_STD
    from chexpert_tpu_torch.data.transforms import decode_transform
    import inputs

    for i, data in enumerate(inputs.jpeg_pool(5, 3, 64)):
        path = tmp_path / f"{i}.jpg"
        path.write_bytes(data)
        want = decode_transform(str(path), image_size=64)
        got = radiograph_input(data, 64, PIXEL_MEAN, PIXEL_STD)
        np.testing.assert_allclose(got[0], want[..., 0], rtol=1e-5, atol=1e-4)
        assert got.shape == (3, 64, 64)
        assert Image.open(io.BytesIO(data)).size[0] >= 64
    assert center_crop(np.zeros((70, 64)), 64).shape == (64, 64)


def test_cifar_augment_matches_the_program():
    from chexpert_tpu_torch.cli import bench

    x = np.random.RandomState(0).randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    cfg = json.loads((BENCH / "configs" / "wrn28-10-aa-hil.json").read_text())
    want = bench.to_device(bench.augment(x, np.random.RandomState(9)), "cpu").numpy()
    norm = cfg["normalization"]
    got = cifar_augmented(x, np.random.RandomState(9), norm["mean"], norm["std"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
