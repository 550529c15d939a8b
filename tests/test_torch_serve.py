"""The port's inference server on the CPU (``--device cpu``): health,
predict, error paths, and the same probabilities as the JAX server for the
same JPEG and the same weights (aadensenet-tiny at 32x32, float32)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chexpert_tpu.checkpoint import save_model_checkpoint as jax_save
from chexpert_tpu.models import build_model as jax_build_model
from chexpert_tpu.train import init_model
from chexpert_tpu_torch.checkpoint import save_model_checkpoint
from chexpert_tpu_torch.data import ATTR_NAMES
from chexpert_tpu_torch.models import state_dict_from_jax

MODEL = "aadensenet-tiny"
ARGS = ["--model", MODEL, "--image_size", "32", "--port", "0", "--compute_dtype", "float32"]


def _start(serve_fn, args):
    httpd = serve_fn(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(port checkpoint, JAX checkpoint) of the same weights."""
    d = tmp_path_factory.mktemp("serve")
    model, _ = jax_build_model(MODEL, image_size=32, dtype=jnp.float32)
    params, stats = init_model(model, jax.random.PRNGKey(0), (1, 32, 32, 3))
    jax_ckpt = str(d / "checkpoint.msgpack")
    jax_save(jax_ckpt, params, stats, 0)
    port_ckpt = str(d / "checkpoint.pt")
    save_model_checkpoint(port_ckpt, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, stats)))
    return port_ckpt, jax_ckpt


@pytest.fixture(scope="module")
def servers(checkpoints):
    """(port server url, JAX server url) over the same weights."""
    port_ckpt, jax_ckpt = checkpoints

    from chexpert_tpu.cli.serve import build_parser as jax_parser
    from chexpert_tpu.cli.serve import serve as jax_serve
    from chexpert_tpu_torch.cli.serve import build_parser, serve

    port_httpd, port_url = _start(serve, build_parser().parse_args(
        ["--restore_path", port_ckpt, "--device", "cpu"] + ARGS))
    jax_httpd, jax_url = _start(jax_serve, jax_parser().parse_args(
        ["--restore_path", jax_ckpt] + ARGS))
    yield port_url, jax_url
    for httpd in (port_httpd, jax_httpd):
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture
def server(servers):
    return servers[0]


def _jpeg_bytes(hw=48, seed=0):
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (hw, hw), dtype=np.uint8), "L").save(
        buf, format="JPEG")
    return buf.getvalue()


def _predict(url, data):
    req = urllib.request.Request(url + "/predict", data=data, method="POST")
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())["probabilities"]


def test_healthz(servers):
    port_url, jax_url = servers
    with urllib.request.urlopen(port_url + "/healthz") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["model"] == MODEL
    with urllib.request.urlopen(jax_url + "/healthz") as r:
        assert body["params"] == json.loads(r.read())["params"] > 0


def test_predict(server):
    probs = _predict(server, _jpeg_bytes())
    assert list(probs) == ATTR_NAMES
    assert all(0.0 <= v <= 1.0 for v in probs.values())


def test_predict_deterministic(server):
    assert _predict(server, _jpeg_bytes()) == _predict(server, _jpeg_bytes())


def test_predict_bad_body(server):
    req = urllib.request.Request(server + "/predict", data=b"not a jpeg", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400


def test_unknown_route(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404


@pytest.mark.parametrize("seed,hw", [(0, 48), (1, 32), (2, 27)])
def test_probabilities_match_jax_server(servers, seed, hw):
    port_url, jax_url = servers
    data = _jpeg_bytes(hw, seed)
    got, want = _predict(port_url, data), _predict(jax_url, data)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=1e-4)


def test_cuda_device_absent_raises(tmp_path):
    """--device cuda never continues on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from chexpert_tpu_torch.cli.serve import Engine, build_parser

    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(build_parser().parse_args(["--restore_path", str(tmp_path / "x.pt"),
                                          "--device", "cuda"] + ARGS))


def test_ready_event_is_set_once_the_server_is_bound(checkpoints):
    """serve(args, ready_event) sets the event after binding, as the JAX
    chexpert_tpu/cli/serve.py::serve does; without one it binds all the same."""
    from chexpert_tpu.cli.serve import build_parser as jax_parser
    from chexpert_tpu.cli.serve import serve as jax_serve
    from chexpert_tpu_torch.cli.serve import build_parser, serve

    port_ckpt, jax_ckpt = checkpoints
    for serve_fn, argv in ((serve, ["--restore_path", port_ckpt, "--device", "cpu"] + ARGS),
                           (jax_serve, ["--restore_path", jax_ckpt] + ARGS)):
        parser = build_parser if serve_fn is serve else jax_parser
        ready = threading.Event()
        httpd = serve_fn(parser().parse_args(argv), ready_event=ready)
        try:
            assert ready.is_set() and httpd.server_address[1] > 0
        finally:
            httpd.server_close()
    httpd = serve(build_parser().parse_args(["--restore_path", port_ckpt, "--device", "cpu"]
                                            + ARGS))
    httpd.server_close()
