"""Port parity for the serving app (``tools/serve.py``).

* the port's ``generate`` handler against the JAX app's
  ``tools/serve.py::generate`` on the tiny DiT and VAE of
  test_torch_port_pipeline.py (JAX's weights, converted) and the same
  stand-in text encoder, text-to-video and image-to-video (a base64 PNG),
  with JAX's draws replayed through the handler's ``noise`` (and, for the
  image's posterior, the sub key JAX splits off): uint8 frames within one
  level on at most 0.1% of values (PERF.md section 6), and the progress
  dict as tests/test_runner_serve.py holds the JAX app's;
* the endpoints through a real server on port 0 with the ``--debug_tiny``
  pipeline: the index, ``/progress``, ``/healthz``, a 404, the 500 of a
  variant without ``--model_path``, and one generation;
* the pipeline cache's eviction rule with ``torch.cuda.mem_get_info``
  stubbed (unknown free memory evicts);
* ``--sp 2`` on two gloo ranks: rank 0's bytes equal the sp=1 handler's;
* without a visible card a ``--model_path`` app and ``main`` raise by name
  instead of loading onto the CPU.

This machine's imageio has no ffmpeg plugin, so the bodies are npz frame
stacks here.
"""

import argparse
import base64
import importlib.util
import io
import json
import threading
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.models.vae import model as vae_model
from pyramid_flow_tpu_torch.tools import serve
from pyramid_flow_tpu_torch.utils.video_io import NPZ, frames_from_bytes

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_pipeline import JaxNoise, pipelines  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
T2V = {"prompt": "a bird", "temp": 1, "height": 64, "width": 64,
       "num_inference_steps": 2, "video_num_inference_steps": 1, "seed": 3}


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_serve", ROOT / "tools" / "serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _text_encoder(wrap):
    """Features drawn from a seed made of the prompt, as ``wrap``'s."""
    def encode(prompt):
        rng = np.random.default_rng(zlib.crc32(prompt.encode()))
        emb = rng.standard_normal((1, 8, 32)).astype(np.float32)
        mask = np.arange(8)[None] < 6
        pooled = rng.standard_normal((1, 24)).astype(np.float32)
        return tuple(map(wrap, (emb, mask, pooled)))
    return encode


def _png(seed, hw):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, hw + (3,), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _close_frames(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert len(np.unique(want)) > 10


@pytest.mark.parametrize("i2v", [False, True], ids=["t2v", "i2v"])
def test_generate_handler_matches_jax(pipelines, i2v,  # noqa: F811
                                      monkeypatch):
    jpipe, tpipe = pipelines
    req = dict(T2V, temp=2, image=_png(5, (80, 96))) if i2v else dict(T2V)
    jserve = _jax_serve()
    jserve.STATE.update(pipe=jpipe, te=_text_encoder(jnp.asarray))
    body, ctype = jserve.generate(req)
    assert ctype == NPZ
    want = frames_from_bytes(body, ctype)
    assert jserve.PROGRESS["unit"] == jserve.PROGRESS["units"]

    key = jax.random.PRNGKey(req["seed"])
    if i2v:
        # the JAX app splits the seed's key: the sub key draws the
        # image's posterior, the other drives the pipeline
        key, sub = jax.random.split(key)
        sample = vae_model.gaussian_sample

        def jax_draw(moments, generator):
            shape = moments.shape[:-1] + (moments.shape[-1] // 2,)
            return sample(moments, torch.from_numpy(
                np.array(jax.random.normal(sub, shape))))

        monkeypatch.setattr(vae_model, "gaussian_sample", jax_draw)
    app = serve.ServingApp(pipe=tpipe,
                           text_encoder=_text_encoder(torch.from_numpy))
    body, ctype = app.generate(req, noise=JaxNoise(key, first_unit=int(i2v)))
    assert ctype == NPZ
    got = frames_from_bytes(body, ctype)
    assert got.shape == (1 + 8 * (req["temp"] - 1), 64, 64, 3)
    _close_frames(got, want)
    # the progress of the generation, as the JAX app's test holds it
    p = app.progress
    assert p["status"] == "running" and p["phase"] == "decode"
    assert p["unit"] == p["units"] == 1 and "elapsed_s" in p
    assert p["prompt"] == req["prompt"]


@pytest.fixture
def tiny_server():
    app = serve.ServingApp(argparse.Namespace(
        model_path=None, variant="diffusion_transformer_384p",
        model_name="pyramid_flux"))
    app.pipe, app.text_encoder = serve.build_debug_tiny()
    server = serve.make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield app, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(url, req):
    data = json.dumps(req).encode()
    r = urllib.request.Request(url, data=data, method="POST",
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def test_endpoints_through_a_server(tiny_server):
    app, url = tiny_server
    status, ctype, body = _get(url + "/")
    assert status == 200 and ctype.startswith("text/html")
    html = body.decode()
    assert "<html" in html and "/progress" in html and "/generate" in html
    assert json.loads(_get(url + "/progress")[2]) == {"status": "idle"}
    assert json.loads(_get(url + "/healthz")[2]) == {
        "status": "ok", "devices": 1, "variants_loaded": []}
    for do in (lambda: _get(url + "/nowhere"),
               lambda: _post(url + "/elsewhere", {})):
        with pytest.raises(urllib.error.HTTPError) as e:
            do()
        assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/generate", {"prompt": "x", "variant": "v"})
    assert e.value.code == 500
    assert "no --model_path" in json.loads(e.value.read())["error"]
    assert json.loads(_get(url + "/progress")[2])["status"] == "error"

    status, ctype, body = _post(url + "/generate", dict(T2V, temp=2))
    assert status == 200 and ctype == NPZ
    frames = frames_from_bytes(body, ctype)
    assert frames.shape == (9, 64, 64, 3) and frames.dtype == np.uint8
    p = json.loads(_get(url + "/progress")[2])
    assert p["status"] == p["phase"] == "done"
    assert p["unit"] == p["units"] == 2


def test_pipeline_cache_evicts_without_free_memory(monkeypatch):
    app = serve.ServingApp(argparse.Namespace(
        model_path="ckpt", variant="a", model_name="pyramid_flux"))
    loaded = []
    monkeypatch.setattr(app, "_load", lambda v: loaded.append(v) or v)
    free = {"bytes": 0.0}

    def mem_get_info(device=None):
        if free["bytes"] is None:
            raise RuntimeError("no CUDA")
        return free["bytes"], 80e9

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert app.build_pipeline() == "a" and app.build_pipeline("a") == "a"
    free["bytes"] = 50e9  # room: both stay
    app.build_pipeline("b")
    assert sorted(app.pipelines) == ["a", "b"]
    free["bytes"] = 7e9  # below 8 GB: the cached ones go first
    app.build_pipeline("c")
    assert sorted(app.pipelines) == ["c"]
    free["bytes"] = None  # unknown: evict
    app.build_pipeline("a")
    assert sorted(app.pipelines) == ["a"]
    assert loaded == ["a", "b", "c", "a"]


def test_sequence_parallel_serving_on_two_ranks(tmp_path):
    req = dict(T2V, seed=4)
    out = run_ranks(ranks.serve_sp, 2, tmp_path, req)
    assert out[1] is None
    pipe, te = serve.build_debug_tiny()
    want = serve.ServingApp(pipe=pipe, text_encoder=te).generate(req)
    assert out[0][1] == want[1] == NPZ
    assert out[0][0] == want[0]


def test_main_needs_a_model_or_debug_tiny():
    with pytest.raises(SystemExit, match="--model_path is required"):
        serve.main([])
    with pytest.raises(SystemExit, match="torchrun"):
        serve.main(["--debug_tiny", "--sp", "2"])


def test_app_without_a_card_refuses_to_load(monkeypatch):
    """A ``--model_path`` app on a machine with no visible card raises by
    name before it reads a file, where it once loaded the release models
    onto the CPU; ``main`` exits the same way, before ``--sp``'s torchrun
    check. ``--debug_tiny`` is the CPU app."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read = []
    from pyramid_flow_tpu_torch.utils import checkpoint
    monkeypatch.setattr(checkpoint, "load_pretrained_components",
                        lambda *a, **kw: read.append(a))
    app = serve.ServingApp(argparse.Namespace(
        model_path="ckpt", variant="v", model_name="pyramid_flux"))
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        app.build_pipeline()
    assert read == [] and app.pipelines == {}
    for argv in (["--model_path", "ckpt"],
                 ["--model_path", "ckpt", "--sp", "2"]):
        with pytest.raises(SystemExit, match="none is visible"):
            serve.main(argv)
    assert read == []
