"""HTTP serving app of the port: text- and image-to-video over HTTP.

The counterpart of the JAX package's ``tools/serve.py`` (the reference's
Gradio apps), with its endpoints, request fields and defaults (JSON in,
binary out)::

  POST /generate    {"prompt": ..., "temp": 16, "height": 384, "width": 640,
                     "guidance_scale": 7.0, "video_guidance_scale": 5.0,
                     "num_inference_steps": 20,
                     "video_num_inference_steps": 10, "seed": 0, "fps": 24,
                     "negative_prompt": ..., "variant": ...,
                     "image": <base64 PNG/JPEG for image-to-video>}
                    -> video/mp4 (or application/x-npz, ``frames``:
                       uint8 [F, H, W, 3], without imageio's ffmpeg plugin)
  GET  /progress    -> the in-flight generation's per-unit progress
  GET  /            -> a small browser UI (prompt, progress bar, video)
  GET  /healthz     -> {"status": "ok", "devices": N, "variants_loaded": [...]}

Pipelines load once (``PyramidFlowPipeline.from_pretrained``; the text
encoders once, ``build_text_encoder``) and are cached per variant; before a
new variant loads, the cached ones are dropped unless the card has 8 GB
free (``torch.cuda.mem_get_info``; unknown free memory evicts). One
generation runs at a time. Errors answer as JSON 500s.

    python -m pyramid_flow_tpu_torch.tools.serve --model_path CKPT \
        --variant diffusion_transformer_384p --port 7860

The models serve on the CUDA card in bf16; without a visible card the app
refuses to start (and ``ServingApp`` to load a ``--model_path``) rather than
load the release models onto the CPU. ``--debug_tiny`` serves a tiny
random-weight pipeline with a word-hash tokenizer, on the CPU in fp32 (its
head dim of 8 is one the flash kernel does not take), to drive the serving
surface without checkpoints; its output is noise. ``--classic_softmax``
serves with every DiT attention on the classic online softmax instead of
the bounded one (JAX's app under ``PF_BOUNDED_SOFTMAX=0``).

``--sp N`` serves sequence-parallel under ``torchrun`` (one process per
rank, N ranks; NCCL on CUDA, gloo with ``--debug_tiny``)::

    torchrun --nproc_per_node 2 -m pyramid_flow_tpu_torch.tools.serve \
        --model_path CKPT --variant diffusion_transformer_384p --sp 2

Rank 0 runs the HTTP server and broadcasts each request to the other
ranks, which run the same generation on the same draws (the DiT's tokens
sharded over the sp ranks) and drop its bytes. This differs from the JAX
app, where one process drives the whole mesh.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..pipeline.runner import PROMPT_SUFFIX

__all__ = ["ServingApp", "make_server", "build_debug_tiny", "main",
           "parse_args", "INDEX_HTML", "PROMPT_SUFFIX", "NEGATIVE_PROMPT",
           "EVICT_BELOW_BYTES"]

# the JAX app's default negative prompt (shorter than the runner's)
NEGATIVE_PROMPT = "cartoon style, worst quality, low quality, blurry"
# the cached variants are dropped before a new one loads unless this much
# device memory is free
EVICT_BELOW_BYTES = 8e9


def free_device_memory() -> float:
    """Free bytes on the current card; 0 where that is unknown (no CUDA), so
    that the cache evicts rather than loads a second copy into a full
    card."""
    try:
        return float(torch.cuda.mem_get_info()[0])
    except (AssertionError, RuntimeError, ValueError):
        return 0.0


class HashTokenizer:
    """The debug pipeline's tokenizer: word ids from a CRC32 of each word
    (the same on every rank, unlike Python's salted ``hash``), then the end
    token 2; at most 16 tokens."""

    model_max_length = 16

    def __call__(self, prompts, padding=None, max_length=16,
                 truncation=True, return_tensors="np"):
        max_length = min(max_length, 16)
        ids = np.zeros((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            toks = ([3 + zlib.crc32(w.encode()) % 100 for w in p.split()]
                    [: max_length - 1] + [2])
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def build_debug_tiny(mesh=None, seed: int = 0):
    """The JAX app's ``--debug_tiny`` pipeline at its sizes (a one-dual,
    one-single-block miniFLUX of 4 x 8 heads, a 4-channel VAE, a one-layer
    CLIP and T5 with the hash tokenizer), random weights from ``seed``, fp32
    on the CPU; ``mesh`` makes the DiT sequence-parallel. Returns
    (pipeline, text encoder)."""
    from ..models.flux.model import FluxConfig, PyramidFluxTransformer
    from ..models.text.clip import CLIPTextConfig, CLIPTextEncoder
    from ..models.text.encoder import FluxTextEncoder
    from ..models.text.t5 import T5Config, T5Encoder
    from ..models.vae.model import CausalVideoVAE, VAEConfig
    from ..pipeline.pyramid_pipeline import PyramidFlowPipeline

    torch.manual_seed(seed)
    kw = dict(device="cpu")
    dit = PyramidFluxTransformer(FluxConfig(
        in_channels=16, num_layers=1, num_single_layers=1,
        attention_head_dim=8, num_attention_heads=4, joint_attention_dim=32,
        pooled_projection_dim=24, axes_dims_rope=(4, 2, 2)), mesh=mesh, **kw)
    vae = CausalVideoVAE(VAEConfig(
        latent_channels=4, block_out_channels=(8, 8, 16, 16),
        encoder_layers_per_block=(1, 1, 1, 1),
        decoder_layers_per_block=(1, 1, 1, 1), num_groups=4), **kw)
    pipe = PyramidFlowPipeline(dit.eval(), vae.eval(), latent_channels=4,
                               dtype=torch.float32, device="cpu")
    clip = CLIPTextEncoder(CLIPTextConfig(
        vocab_size=128, hidden_size=24, intermediate_size=48, num_layers=1,
        num_heads=4, eos_token_id=2), **kw)
    t5 = T5Encoder(T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                            num_layers=1, num_heads=4), **kw)
    te = FluxTextEncoder(clip.eval(), t5.eval(),
                         tokenizers=(HashTokenizer(), HashTokenizer()),
                         max_sequence_length=8)
    return pipe, te


class ServingApp:
    """The serving state: the pipeline cache, the text encoder, the
    progress dict and the one-generation-at-a-time lock.

    ``args`` carries ``model_path``, ``variant``, ``model_name`` and
    ``classic_softmax`` (the command line's); ``pipe`` and ``text_encoder``
    inject a pipeline that requests without a ``variant`` take
    (``--debug_tiny``). ``mesh``: the (1, 1, sp) mesh of a sequence-parallel
    app (one per rank). Without an injected pipeline the models load onto
    the current CUDA card, and without a visible card :attr:`device`
    raises."""

    def __init__(self, args=None, pipe=None, text_encoder=None, mesh=None):
        self.args = args
        self.pipe = pipe
        self.text_encoder = text_encoder
        self.mesh = mesh
        self.pipelines = {}  # variant -> PyramidFlowPipeline
        self.lock = threading.Lock()
        self.progress = {"status": "idle"}
        self.progress_lock = threading.Lock()

    # ---------------------------------------------------------- progress
    def set_progress(self, **kw):
        with self.progress_lock:
            self.progress.clear()
            self.progress.update(kw)

    def update_progress(self, info: dict):
        with self.progress_lock:
            self.progress.update(info)
            started = self.progress.get("started")
            if started:
                self.progress["elapsed_s"] = round(time.time() - started, 1)

    def progress_json(self) -> bytes:
        with self.progress_lock:
            return json.dumps(self.progress).encode()

    # --------------------------------------------------------- pipelines
    @property
    def device(self) -> torch.device:
        if self.pipe is not None:
            return self.pipe.device
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the serving app loads --model_path onto a CUDA card and no "
                "CUDA device is visible (--debug_tiny serves on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())

    def devices(self) -> int:
        """The devices one request runs on: the ranks of the mesh."""
        return self.mesh.size() if self.mesh is not None else 1

    def build_pipeline(self, variant: Optional[str] = None):
        """The pipeline of ``variant`` (default: the command line's), loaded
        on first use. Before a new variant loads, the cached ones are
        dropped unless ``EVICT_BELOW_BYTES`` are free on the card."""
        variant = variant or self.args.variant
        if variant in self.pipelines:
            return self.pipelines[variant]
        if self.pipelines:
            free = free_device_memory()
            if free < EVICT_BELOW_BYTES:
                evicted = sorted(self.pipelines)
                self.pipelines.clear()  # freed once in-flight requests end
                print(f"serve: evicted variants {evicted} to fit "
                      f"'{variant}' (free device memory {free / 1e9:.1f} "
                      "GB)", file=sys.stderr)
        self.pipelines[variant] = self._load(variant)
        return self.pipelines[variant]

    def _load(self, variant: str):
        """``variant``'s pipeline from ``--model_path`` in bf16 on the
        card; the text encoders too on the first load."""
        from ..models.text.encoder import build_text_encoder
        from ..pipeline.pyramid_pipeline import PyramidFlowPipeline
        from ..utils.checkpoint import load_pretrained_components

        a = self.args
        kw = dict(dtype=torch.bfloat16, device=self.device)
        comps = load_pretrained_components(
            a.model_path, variant, a.model_name,
            load_text_encoders=self.text_encoder is None)
        pipe = PyramidFlowPipeline.from_pretrained(
            a.model_path, variant, a.model_name, components=comps,
            mesh=self.mesh,
            bounded_softmax=not getattr(a, "classic_softmax", False), **kw)
        if self.text_encoder is None:
            self.text_encoder = build_text_encoder(comps, a.model_path,
                                                   a.model_name, **kw)
        return pipe

    # -------------------------------------------------------- generation
    def generate(self, req: dict, noise=None):
        """One request -> (body bytes, content type). ``noise`` replaces
        the seed's generator as the pipeline's noise source (the tests
        replay the JAX app's draws with it)."""
        from ..models.vae import model as vae_model
        from ..utils.video_io import video_bytes

        temp = int(req.get("temp", 16))
        self.set_progress(status="running", phase="load_model", unit=0,
                          units=1 + max(temp - 1, 0), started=time.time(),
                          prompt=req.get("prompt", "")[:80])
        if req.get("variant") is None and self.pipe is not None:
            pipe = self.pipe
        elif req.get("variant") and getattr(self.args, "model_path",
                                            None) is None:
            raise ValueError(
                "request specifies a model variant but the server has no "
                "--model_path (running --debug_tiny?)")
        else:
            pipe = self.build_pipeline(req.get("variant"))
        te = self.text_encoder
        prompt = req.get("prompt", "") + PROMPT_SUFFIX
        neg = req.get("negative_prompt", NEGATIVE_PROMPT)
        self.update_progress({"phase": "text_encode"})
        features = (*te(prompt), *te(neg))
        kwargs = dict(
            height=int(req.get("height", 384)),
            width=int(req.get("width", 640)), temp=temp,
            num_inference_steps=int(req.get("num_inference_steps", 20)),
            video_num_inference_steps=int(
                req.get("video_num_inference_steps", 10)),
            guidance_scale=float(req.get("guidance_scale", 7.0)),
            video_guidance_scale=float(req.get("video_guidance_scale", 5.0)),
            output_type="pixels", progress_callback=self.update_progress,
            noise=noise)
        generator = torch.Generator(pipe.device).manual_seed(
            int(req.get("seed", 0)))
        if req.get("image"):
            # image-to-video: the image resized to (height, width), encoded,
            # its posterior sampled from the seed's generator, which then
            # draws the pipeline's noise (the reference app's I2V tab)
            from PIL import Image

            img = Image.open(io.BytesIO(base64.b64decode(req["image"])))
            img = img.convert("RGB").resize((kwargs["width"],
                                             kwargs["height"]))
            px = torch.from_numpy(
                np.asarray(img, np.float32) / 127.5 - 1.0)[None, None]
            moments = vae_model.chunk_encode(pipe.vae, px.to(pipe.device))
            latent = vae_model.gaussian_sample(moments, generator)
            frames = pipe.generate_i2v(generator, latent, *features,
                                       **kwargs)
        else:
            frames = pipe.generate(generator, *features, **kwargs)
        return video_bytes(frames[0].cpu().numpy(),
                           fps=int(req.get("fps", 24)))

    def handle(self, req: dict):
        """A request of the HTTP server, one at a time; under ``--sp`` it
        goes to the other ranks first."""
        with self.lock:
            if self.mesh is not None:
                torch.distributed.broadcast_object_list([req], src=0)
            return self.generate(req)

    def follow(self):
        """The loop of a rank other than 0 under ``--sp``: the requests
        rank 0 broadcasts, generated and dropped, until it sends None."""
        while True:
            box = [None]
            torch.distributed.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            try:
                self.generate(box[0])
            except Exception as e:  # rank 0 answers the error
                print(f"[serve] request failed on this rank: {e!r}",
                      file=sys.stderr)

    def release_followers(self):
        """Rank 0 under ``--sp``: end the other ranks' :meth:`follow`."""
        with self.lock:
            torch.distributed.broadcast_object_list([None], src=0)


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Pyramid Flow</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:2rem auto;padding:0 1rem}
 textarea,input,select{width:100%;box-sizing:border-box;margin:.25rem 0;padding:.4rem}
 button{padding:.5rem 1.5rem;margin-top:.5rem}
 #bar{height:10px;background:#e0e0e0;border-radius:5px;overflow:hidden;margin:.75rem 0}
 #fill{height:100%;width:0;background:#4a7;transition:width .3s}
 #status{color:#555;font-size:.9rem}
 video,img{max-width:100%;margin-top:1rem}
 .row{display:flex;gap:.5rem}.row>*{flex:1}
</style></head><body>
<h2>Pyramid Flow &mdash; serving</h2>
<textarea id="prompt" rows="2"
 placeholder="A movie trailer featuring the adventures of...">A movie trailer featuring the adventures of the 30 year old space man</textarea>
<div class="row">
 <label>temp <input id="temp" type="number" value="16" min="1" max="31"></label>
 <label>height <input id="h" type="number" value="384" step="64"></label>
 <label>width <input id="w" type="number" value="640" step="64"></label>
 <label>seed <input id="seed" type="number" value="0"></label>
</div>
<button id="go">Generate</button>
<div id="bar"><div id="fill"></div></div>
<div id="status">idle</div>
<div id="out"></div>
<script>
let poll = null;
document.getElementById('go').onclick = async () => {
  const req = {prompt: prompt.value, temp: +temp.value, height: +h.value,
               width: +w.value, seed: +seed.value};
  document.getElementById('go').disabled = true;
  poll = setInterval(async () => {
    const p = await (await fetch('/progress')).json();
    const frac = p.units ? (p.unit || 0) / p.units : 0;
    document.getElementById('fill').style.width = (100 * frac) + '%';
    document.getElementById('status').textContent =
      `${p.status || 'idle'} | ${p.phase || ''} | unit ${p.unit || 0}/` +
      `${p.units || '?'} | ${p.elapsed_s || 0}s`;
  }, 1000);
  try {
    const r = await fetch('/generate', {method: 'POST',
      headers: {'Content-Type': 'application/json'}, body: JSON.stringify(req)});
    if (!r.ok) throw new Error((await r.json()).error || r.status);
    const blob = await r.blob();
    const url = URL.createObjectURL(blob);
    document.getElementById('out').innerHTML = blob.type.includes('mp4')
      ? `<video controls autoplay loop src="${url}"></video>`
      : `<a href="${url}" download="frames.npz">download frames.npz</a>`;
    document.getElementById('fill').style.width = '100%';
  } catch (e) {
    document.getElementById('status').textContent = 'error: ' + e.message;
  } finally {
    clearInterval(poll);
    document.getElementById('go').disabled = false;
  }
};
</script></body></html>
"""


def make_handler(app: ServingApp):
    """The request handler class of ``app``'s HTTP server."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}", file=sys.stderr)

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps(
                    {"status": "ok", "devices": app.devices(),
                     "variants_loaded": sorted(app.pipelines)}).encode())
            elif self.path == "/progress":
                self._send(200, app.progress_json())
            elif self.path in ("/", "/index.html"):
                self._send(200, INDEX_HTML.encode(),
                           "text/html; charset=utf-8")
            else:
                self._send(404, b"{}")

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, b"{}")
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                t0 = time.time()
                body, ctype = app.handle(req)
                app.update_progress({"status": "done", "phase": "done"})
                print(f"[serve] generated in {time.time() - t0:.1f}s",
                      file=sys.stderr)
                self._send(200, body, ctype)
            except Exception as e:  # answered as JSON
                app.update_progress({"status": "error", "error": str(e)})
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def make_server(app: ServingApp, host: str = "0.0.0.0",
                port: int = 7860) -> ThreadingHTTPServer:
    """``app``'s HTTP server on (host, port); port 0 takes a free one
    (``server.server_address``)."""
    return ThreadingHTTPServer((host, port), make_handler(app))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--debug_tiny", action="store_true",
                   help="tiny random-weight pipeline on the CPU (no "
                        "checkpoints needed; output is noise)")
    p.add_argument("--variant", default="diffusion_transformer_384p")
    p.add_argument("--model_name", default="pyramid_flux",
                   choices=["pyramid_flux", "pyramid_mmdit"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (under torchrun)")
    p.add_argument("--classic_softmax", action="store_true",
                   help="every DiT attention on the classic online softmax "
                        "(exact at any qk-norm gain) instead of the bounded "
                        "one")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (args.debug_tiny or args.model_path):
        sys.exit("--model_path is required (or use --debug_tiny)")
    device_type = "cpu" if args.debug_tiny else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        sys.exit("the models serve on a CUDA card; none is visible (use "
                 "--debug_tiny on the CPU)")
    mesh, rank = None, 0
    if args.sp > 1:
        import torch.distributed as dist

        from ..parallel.mesh import (MeshConfig, make_mesh,
                                     maybe_initialize_distributed)
        if not maybe_initialize_distributed(device_type):
            sys.exit("--sp > 1 runs one process per rank: launch it with "
                     "torchrun --nproc_per_node N")
        if dist.get_world_size() != args.sp:
            sys.exit(f"--sp {args.sp} needs {args.sp} ranks, torchrun "
                     f"started {dist.get_world_size()}")
        mesh = make_mesh(MeshConfig(sp=args.sp), device_type)
        rank = dist.get_rank()
    app = ServingApp(args, mesh=mesh)
    print("loading models ...", file=sys.stderr)
    if args.debug_tiny:
        app.pipe, app.text_encoder = build_debug_tiny(mesh)
        app.pipe.dit.bounded_softmax = not args.classic_softmax
    else:
        app.build_pipeline()
    try:
        if rank:
            app.follow()
            return 0
        server = make_server(app, args.host, args.port)
        print(f"serving on {args.host}:{server.server_address[1]}",
              file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            if mesh is not None:
                app.release_followers()
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
