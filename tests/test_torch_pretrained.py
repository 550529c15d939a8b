"""The port's --pretrained path (models/pretrained.py::load_pretrained, the
CLI's Runner and reread_pretrained_flag) against the JAX package's, on the
CPU. The weight file is written by the JAX package's
``export_torch_state_dict`` from a seeded JAX init (no ImageNet file exists
here and none can be fetched); both packages then load it into a fresh
model, the head excepted. Logits within 5e-4, the forward-parity bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chexpert_tpu.cli.chexpert import reread_pretrained_flag as jax_reread
from chexpert_tpu.configs import Config as JaxConfig
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.models.pretrained import export_torch_state_dict
from chexpert_tpu.models.pretrained import load_pretrained as jax_load_pretrained
from chexpert_tpu.train import init_model
from chexpert_tpu_torch.cli.chexpert import Runner, reread_pretrained_flag
from chexpert_tpu_torch.configs import Config
from chexpert_tpu_torch.data import make_synthetic_dataset
from chexpert_tpu_torch.models import build_model, state_dict_from_jax
from chexpert_tpu_torch.models.pretrained import PRETRAINED_DIR_ENV, load_pretrained

SIZE = 32


@pytest.mark.parametrize("arch", ["densenet-tiny", "aadensenet-tiny"])
def test_load_pretrained_equals_jax(arch, tmp_path, monkeypatch):
    jmodel, _ = jax_build_model(arch, image_size=SIZE, dtype=jnp.float32, attn_impl="pallas")
    donor = jax.device_get(init_model(jmodel, jax.random.PRNGKey(1), (1, SIZE, SIZE, 3)))
    export_torch_state_dict(*donor, arch, str(tmp_path / f"{arch}.pth"))
    monkeypatch.setenv(PRETRAINED_DIR_ENV, str(tmp_path))
    fresh = jax.device_get(init_model(jmodel, jax.random.PRNGKey(0), (1, SIZE, SIZE, 3)))
    params, stats = jax_load_pretrained(arch, *fresh)
    x = np.random.RandomState(0).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                   train=False))

    model = build_model(arch, image_size=SIZE)
    model.load_state_dict(state_dict_from_jax(*fresh, arch=arch), strict=True)
    head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("classifier.")}
    assert load_pretrained(model, arch) > 0
    for k, v in head.items():  # the head stays the fresh model's
        assert torch.equal(model.state_dict()[k], v)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)
    # and the loaded body is the donor's
    donor_sd = state_dict_from_jax(*donor, arch=arch)
    for k, v in model.state_dict().items():
        if not k.startswith("classifier.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, donor_sd[k]), k


@pytest.mark.parametrize("where", ["unset", "missing_file"])
def test_missing_file_raises_the_jax_error(where, tmp_path, monkeypatch):
    if where == "unset":
        monkeypatch.delenv(PRETRAINED_DIR_ENV, raising=False)
    else:
        monkeypatch.setenv(PRETRAINED_DIR_ENV, str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jax_load_pretrained("densenet121", {}, {})
    with pytest.raises(FileNotFoundError) as got:
        load_pretrained(build_model("densenet-tiny", image_size=SIZE), "densenet121")
    assert str(got.value) == str(want.value)


def test_a_file_that_does_not_fit_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(PRETRAINED_DIR_ENV, str(tmp_path))
    sd = build_model("densenet-tiny", image_size=SIZE).state_dict()
    torch.save({k: v for k, v in sd.items() if "norm5" not in k},
               str(tmp_path / "densenet-tiny.pth"))
    with pytest.raises(KeyError, match="norm5"):
        load_pretrained(build_model("densenet-tiny", image_size=SIZE), "densenet-tiny")


def test_runner_starts_from_the_file_and_restore_skips_it(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_train=4, n_valid=4, image_size=SIZE)
    donor = build_model("densenet-tiny", image_size=SIZE,
                        generator=torch.Generator().manual_seed(5))
    torch.save(donor.state_dict(), str(tmp_path / "densenet-tiny.pth"))
    monkeypatch.setenv(PRETRAINED_DIR_ENV, str(tmp_path))
    cfg = Config(model="densenet-tiny", image_size=SIZE, data_path=data, pretrained=True,
                 output_dir=str(tmp_path / "run"), device="cpu")
    got = Runner(cfg).state.model.state_dict()
    for k, v in donor.state_dict().items():
        if not k.startswith("classifier.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    # a pending restore takes the weights from the checkpoint, not the file
    monkeypatch.setenv(PRETRAINED_DIR_ENV, str(tmp_path / "nowhere"))
    Runner(cfg.replace(restore=str(tmp_path / "no_checkpoint_yet.pt")))


@pytest.mark.parametrize("layout", ["file", "best_checkpoints", "directory", "output_dir",
                                    "none", "no_restore"])
def test_reread_pretrained_flag_equals_jax(layout, tmp_path):
    run, out = tmp_path / "run", tmp_path / "out"
    (run / "best_checkpoints").mkdir(parents=True)
    out.mkdir()
    saved = {"file": run, "best_checkpoints": run, "directory": run, "output_dir": out}
    if layout in saved:
        Config(pretrained=True).save(str(saved[layout] / "config.json"))
    restore = {"file": str(run / "checkpoint_latest.pt"),
               "best_checkpoints": str(run / "best_checkpoints"), "directory": str(run),
               "output_dir": str(run / "x.pt"), "none": str(run / "x.pt"),
               "no_restore": ""}[layout]
    got = reread_pretrained_flag(Config(restore=restore, output_dir=str(out))).pretrained
    want = jax_reread(JaxConfig(restore=restore, output_dir=str(out))).pretrained
    assert got == want == (layout in saved)
