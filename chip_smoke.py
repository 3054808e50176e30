#!/usr/bin/env python3
"""Run the PyTorch port's text-to-video, image-to-video and DiT-training paths
for both DiT families, the string-prompt path from a release-layout
checkpoint, GAN-VAE training and the heads-per-block attention experiment,
once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: its name and power limit as nvidia-smi reports them, the
   torch and CUDA versions, and whether ``transformers``, ``safetensors``
   and ``PIL`` import;
2. build: the four kernel libraries from ``pyramid_flow_tpu_torch/csrc``
   (the flash-attention forward, the heads-per-block forward, the backward
   and the causal conv), one nvcc each, started together; ptxas's register,
   spill and wgmma-serialisation (C7518) lines, and per library the count
   of kernels and of C7518 warnings;
3. kernel vs plain: the forward kernel against the plain PyTorch version on the
   DiT's packed attention layouts (384x640 unit 0 stage 0, 384x640 unit 15
   stage 2, 768x1280 unit 15 stage 2) at B=2, H=24, D=64 in bf16, bounded
   and classic softmax, causal and not; valid rows must agree within
   max|do| <= 1e-2 and max|dlse| <= 2e-3 of the fp32 plain version; both
   are timed with CUDA events around wrapper calls back to back, as the
   paths make them, and at the 384x640 unit 15 stage 2 layout so is
   ``scaled_dot_product_attention`` with the time-id mask, and the kernel's
   own device time is read from a profiler trace of the same calls; the
   heads-per-block forward (K6) against the same plain version with the same
   tolerances at every hs whose block fits the card (the others are
   reported), hs=2 timed at that layout, then on the inputs the experiment
   of phase 5 times (its 768p final-unit stage-2 layout, L=11008, q = k = v,
   causal), and on rows with no visible key (o = 0, lse = 3e38). Beside
   each forward check, the SKIP/FULL/MASKED split of its (64-row, 128-key)
   tiles (``tile_types``). Then K1/K2 where those layouts do not reach: the
   short 384x640 unit 15 stage 0 layout, Lq = 1000 against Lk = 3072, an
   all-FULL layout and head dim 128; and what a K1 launch costs the host
   (the whole wrapper call, bounded and classic). These checks draw from a
   generator of their own, apart from the models';
4. backward kernels vs plain: the backward library (delta, dK/dV and dQ)
   against the plain fp32 backward on the layouts of phase 3 (B=2, H=24,
   D=64, causal and not) and on the 384x640 unit 15 stage 2 layout at H=12,
   D=128; o and lse from the forward kernel, the upstream gradient random
   on valid rows and zero on padded ones; max|err| <= 2e-2 * max|ref| for
   each of dq, dk, dv, and a second run equal bit for bit; the backward
   timed as the training path calls it (``torch.autograd.grad`` through
   ``flash_attention`` less its forward), each of its three kernels' own
   device time from a profiler trace, and SDPA's backward timed the same
   way (its forward plus backward less its forward);
5. the experiment: ``pyramid_flow_tpu_torch.tools.exp_flash_h2.main`` in
   this process (its checks, and K1 and K6 at each hs timed at the 768p
   stage-2 layout, L=11008), its launches held to exactly its count;
6. full-width DiT: the release-architecture miniFLUX (19 dual + 38 single
   blocks, 24 x 64 heads) in bf16 with random weights, one forward at the
   384x640 unit 15 stage 2 layout through the kernel and through the plain
   version; relative L2 <= 2e-2 on the valid tokens;
7. full-width encode: the release VAE (bf16, random weights)
   ``chunk_encode``s a seeded smooth 17-frame 384x640 clip through the conv
   kernel, through the plain version and in fp32; relative L2 of the
   kernel's moments to the plain version's <= 2e-2, their distance to fp32
   within 1.1x of the plain version's, each conv's output within relative
   L2 2e-3 of the plain conv on the same input, and exactly one conv
   launch per admitted conv and window; then the decode gradient: a
   backward through ``vae.decode`` of a 2-frame 12x20 latent (9 frames of
   96x160 out) through the conv kernel's gradient route, the plain version
   and fp32; every kernel-routed decoder conv's weight gets a finite,
   nonzero gradient, the kernel route's decoder gradient is within 1.1x of
   the plain route's distance to fp32, and each of the 34 admitted convs
   launches the kernel once;
8. serve: two text-to-video requests through ``PyramidFlowPipeline.generate``
   (384x640, temp 1 and temp 4, steps [20,20,20]/[10,10,10], guidance 7/5,
   uint8 frames out) and one image-to-video request through
   ``PyramidFlowRunner.generate_i2v`` (a seeded smooth 384x640 image, a
   seeded stand-in text encoder, temp 4, the same steps and guidance). The
   latents must be finite, the frames not constant, the flash forward
   launched exactly 57 times per DiT forward and the conv kernel exactly
   once per admitted conv and VAE window;
8b. a string prompt from a checkpoint: a full-width CLIP-L (12 x 768) and
   T5-XXL (24 x 4096, 64 x 64 heads, d_ff 10240) in bf16 with seeded random
   weights (a generator of their own), written with the serving miniFLUX
   and VAE as a release-layout checkpoint under ``build/smoke_checkpoint``
   (safetensors by this script's own writer, the T5 in two shards, a
   ``config.json`` each; the free disk space checked first; removed at the
   end, whatever happens), then
   ``PyramidFlowRunner.from_pretrained(..., "pyramid_flux")`` with
   ``encoder._load_tokenizer`` patched to a word-hash tokenizer (the
   checkpoint has no tokenizer files). Every loaded tensor must equal the
   written one bit for bit, the VAE's conv weights stay channels-last, the
   bf16 text features (valid tokens' embeddings, pooled) must be within
   relative L2 2e-2 of an fp32 copy of the same encoders, and
   ``runner.generate("a cat walks on grass")`` (384x640, temp 1, the steps
   and guidance of phase 8) must give frames as phase 8 checks them, with
   57 flash launches per DiT forward and one conv launch per admitted conv
   and window. Prints the bytes, write, load and text-encode seconds, the
   request's wall seconds and the peak memory;
9. full-width DiT gradient: the release DiT with fp32 parameters, bf16
   autocast and remat, one training-loss backward of a batch row at the
   384x640 unit-16 stage-2 training layout (L = 3068), through the kernels
   and through the plain version; relative L2 of the concatenated parameter
   gradient <= 5e-2, every parameter with a nonzero gradient, and exactly
   2 forward launches (forward and recompute) and one of each backward
   kernel per attention;
10. train: the serving DiT freed, ``create_train_state`` on that DiT (its
   output projection zeroed, as the JAX model initialises it) and three
   ``make_train_step`` steps at the JAX CLI's default shape (batch 4, 16
   latent frames of 48x80, units from ``sample_stage_length``, the CLI's lr
   schedule), then two raw-pixel steps (``vae=``, batch 4 of 121 frames of
   384x640, the same 16 latent frames); finite losses and grad norms,
   updates applied, exact kernel launch counts; step seconds and the peak
   memory printed;
11. the MMDiT, after the flux training state is freed: the release SD3
   MMDiT (24 joint blocks, 24 x 64 heads, 1536 wide) in bf16, its forward
   kernel vs plain (relative L2 <= 2e-2, with the table's crop origin); one
   T2V request through ``PyramidFlowPipeline(model_name="pyramid_mmdit")``
   with the release VAE (384x640, temp 4, 128 text tokens of width 4096,
   100 valid, pooled 2048; 24 flash launches per DiT forward), and one
   string-prompt request (temp 1) through ``PyramidFlowRunner`` with the
   SD3 text encoders at full width (CLIP-L projected, CLIP-G 32 x 1280
   projected to 1280, T5-XXL; seeded random weights from a generator of
   their own, the word-hash tokenizers; pooled 2048 wide); then with
   fp32 parameters and remat the gradient check of phase 9 (every
   parameter nonzero but the last block's text-query projection, which it
   discards) and two latent train steps at the shape of phase 10;
11b. GAN-VAE training: the release VAE (335.4 M parameters) in fp32 under
   bf16 autocast, a frozen random LPIPS (VGG16, 14.7 M) and
   ``PatchDiscriminator2D()`` (7.0 M), each from a generator of its own
   (SEED + 5 to SEED + 7; the clips from SEED + 8). First the generator's
   gradient of the GAN loss (``make_vae_train_step(grads_only=True)``, the
   discriminator on) on a smooth 9-frame 128x128 clip through the conv
   kernel, the plain version and fp32: every admitted encoder and decoder
   conv's weight gets a finite, nonzero gradient, the kernel route is
   within 1.1x of the plain route's distance to fp32, and it launches the
   conv kernel once per admitted conv (54). Then three steps at the
   reference's stage-1 recipe shape (batch 1, 17 frames of 256x256) with
   ``disc_start=1``: at step 0 the adaptive weight is 0 and the
   discriminator does not move, at steps 1-2 the weight is positive and it
   does; every metric finite; exactly 54 conv launches per step and no
   other kernel. Prints each step's seconds and the peak memory beside the
   card's name and power limit;
12. conv kernel vs plain, with the models freed: the causal 3x3x3 conv
   against the plain fp32 version at every (B, T, H, W, C, Co) the VAE ran
   it at in phases 7-11b (recorded by a patch of its conv call), each with
   zero front frames and with a carried front; max|err| <= 2e-2 *
   max|ref|, and a second launch equal bit for bit; the kernel and
   ``F.conv3d`` (cuDNN, bf16, channels-last) timed at each, the plain
   version at the decoder's 128->128 384x640
   conv over a 16-frame window; then, within the same limit, one and two
   frames without front frames (the skipped taps), H x W that the 16 x 16
   tile does not divide, and 512 -> 256 channels.

Each path (the experiment, the VAE decode gradient, text-to-video,
image-to-video, the string prompt from the checkpoint, latent training,
raw-pixel training, MMDiT text-to-video, the MMDiT string prompt, MMDiT
latent training, the GAN-VAE generator gradient, GAN-VAE training) runs
with every launch counter set to 0 just before it and read just after. Before the
last line the script prints one JSON object with each kernel's launches
summed over those paths, its largest error against the plain version, its
time, the plain version's, the least time the card could take (bytes or
operations at the H100's published peaks) and one PyTorch call's time for
the same function, its rate (``tflops``) and ``bound_share`` (the least
time over its time), at the 384x640 unit 15 stage 2 attention layout and
at the 128->128 384x640 decode conv. Each time is that of the wrapper call
the paths make; the forwards also give ``kernel_ms``, the kernel's own
device time. K3 and K4 share one ``ms``, the whole backward as the path
calls it, with their own ``kernel_ms`` and the delta kernel's
(``delta_kernel_ms``) beside it; their rate and share are of their own
time. The classic forward (K2), which no path
runs, has an entry of its own with 0 launches. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.models.text import encoder as text_encoder
from pyramid_flow_tpu_torch.models.text.clip import (
    CLIPTextConfig, CLIPTextEncoder)
from pyramid_flow_tpu_torch.models.text.encoder import (
    FluxTextEncoder, SD3TextEncoder)
from pyramid_flow_tpu_torch.models.text.t5 import T5Config, T5Encoder
from pyramid_flow_tpu_torch.models.vae import layers as vae_layers
from pyramid_flow_tpu_torch.models.vae import model as vae_model
from pyramid_flow_tpu_torch.models.vae.discriminator import (
    PatchDiscriminator2D)
from pyramid_flow_tpu_torch.models.vae.lpips import LPIPS
from pyramid_flow_tpu_torch.models.vae.model import (
    CausalVideoVAE, VAEConfig, kernel_conv_count)
from pyramid_flow_tpu_torch.ops import causal_conv3d as cc
from pyramid_flow_tpu_torch.ops import flash_attention as fa
from pyramid_flow_tpu_torch.pipeline.noising import (
    GeneratorDraws, add_ar_noise_stage, latent_pyramid, sample_stage_length)
from pyramid_flow_tpu_torch.pipeline.packing import pack_clips, patchify
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.pipeline.runner import (
    DEFAULT_NEGATIVE_PROMPT, PROMPT_SUFFIX, PyramidFlowRunner)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.lr_schedules import cosine_schedule
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.tools import exp_flash_h2
from pyramid_flow_tpu_torch.training.trainer import (
    VIDEO_ENCODE_WINDOW, make_train_step)
from pyramid_flow_tpu_torch.training.vae_trainer import (
    VAETrainConfig, create_vae_train_state, make_vae_train_step)

SEED = 0
B, H, D = 2, 24, 64
TEXT_LEN, TEXT_VALID = 128, 100   # the prompt's last 28 tokens are masked
O_ATOL, LSE_ATOL, DIT_REL_L2 = 1e-2, 2e-3, 2e-2
GRAD_REL, DIT_GRAD_REL_L2 = 2e-2, 5e-2
BWD_D128 = ("384x640 u15 s2", 12, 128)  # (layout, heads, head dim)
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_STEPS = 4, 16, 3
LAYOUTS = (  # (name, height, width, unit, stage)
    ("384x640 u0 s0", 384, 640, 0, 0),
    ("384x640 u15 s2", 384, 640, 15, 2),
    ("768x1280 u15 s2", 768, 1280, 15, 2),
)
TIMED_LAYOUT = "384x640 u15 s2"
HEIGHT, WIDTH = 384, 640  # the requests', the encode's and the video's
REQUESTS = (("a", 1), ("b", 4))  # (name, temp)
I2V_TEMP = 4
STEPS, VIDEO_STEPS = [20, 20, 20], [10, 10, 10]
DECODE_WINDOW, ENCODE_WINDOW = 2, 16  # latent frames; pixel frames
# (B, T, H, W, C, Co, front): the decoder's 128->128 conv in its steady
# window (2 latent frames, after its temporal upsamplers)
TIMED_CONV = (1, 16, HEIGHT, WIDTH, 128, 128, True)
CONV_REL, ENCODE_REL_L2, IN_PLACE_REL_L2 = 2e-2, 2e-2, 2e-3
VAE_GRAD_LATENT = (12, 20)  # latent h, w of the decode gradient: 96x160
RAW_STEPS = 2
MMDIT_TEMP, MMDIT_TRAIN_STEPS = 4, 2
HN_TIMED_HS = 2  # the heads per block timed beside K1 (the JAX default)
TOOL_ITERS = 8   # the tool's timed launches per kernel
RAW_FRAMES = 1 + 8 * (TRAIN_FRAMES - 1)  # 121 pixel frames, 16 latent
# the release-layout checkpoint the string-prompt phase writes and deletes
CKPT_DIR = os.path.join("build", "smoke_checkpoint")
CKPT_VARIANT = "diffusion_transformer_384p"
CKPT_T5_SHARDS = 2
TEXT_PROMPT = "a cat walks on grass"
TEXT_REL_L2 = 2e-2  # bf16 text features against an fp32 copy
# GAN-VAE training: the reference's stage-1 recipe clip
# (scripts/train_causal_video_vae.sh: batch 1, 17 frames at 256p), and the
# generator-gradient check's smaller clip (frames, side)
VAE_TRAIN_CLIP, VAE_TRAIN_STEPS = (17, 256), 3
VAE_GRAD_CLIP = (9, 128)
# NVIDIA H100 SXM published dense peaks
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current stream: CUDA events
    around ``reps`` calls back to back, so that the host's time between
    calls is not counted while it enqueues faster than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps: int) -> dict:
    """{kernel name: device milliseconds per call} from a ``torch.profiler``
    trace of ``reps`` calls of ``fn``: every kernel a call puts on the card,
    its wrapper's own included."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] = (ms.get(e.name, 0.0)
                          + (e.time_range.end - e.time_range.start) / reps / 1e3)
    return ms


def kernel_device_ms(fn, reps: int, name: str):
    """Device milliseconds per call of the kernels whose name holds ``name``
    (the kernel's own time, without the work around it); None if the trace
    holds no such kernel."""
    ms = [t for k, t in device_ms_by_kernel(fn, reps).items() if name in k]
    return sum(ms) if ms else None


def bound(flops: float, nbytes: float):
    """(the least milliseconds the card could take, what bounds it): the
    operations at the bf16 dense peak against the bytes at the memory
    rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def visible_pairs(t: torch.Tensor, causal: bool) -> int:
    """(valid query, visible key) pairs of one row's time ids: the scores
    the attention kernels must compute for this layout."""
    tq, tk = t[:, None], t[None, :]
    vis = (tk != fa.INVALID_TIME) & (tq != fa.INVALID_TIME)
    if causal:
        vis &= tk <= tq
    return int(vis.sum().item())


def sdpa_mask(t: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, 1, L, L] bool mask of the time-id rule for
    ``scaled_dot_product_attention``."""
    tq, tk = t[:, None, :, None], t[:, None, None, :]
    mask = tk != fa.INVALID_TIME
    return mask & (tk <= tq) if causal else mask.expand(-1, -1, t.shape[1],
                                                       -1)


def text_time(dev) -> torch.Tensor:
    t = torch.zeros(TEXT_LEN, dtype=torch.int32, device=dev)
    t[TEXT_VALID:] = fa.INVALID_TIME
    return t


def layout_time_ids(meta_pipe, height, width, unit, stage, dev):
    """[B, L] attention time ids of the DiT at one (unit, stage): the
    prompt, then the pipeline's own packed latent layout."""
    h_lat, w_lat = height // 8, width // 8
    budget = meta_pipe._cond_token_budget(unit, h_lat, w_lat)[stage]
    positions, time_ids, _ = meta_pipe._stage_metadata(
        B, 1, h_lat, w_lat, unit, stage, budget)
    t = torch.cat([text_time(dev), torch.as_tensor(time_ids, device=dev)])
    return positions, t[None].expand(B, -1).contiguous()


def rms_normal(shape, gen, dev):
    """bf16 rows of RMS 1, as the DiT's qk-norm makes them."""
    x = torch.randn(shape, generator=gen, device=dev)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()


def plain_attention(q, k, v, t, causal, head_chunk=2):
    """The plain version, a few heads at a time so that the fp32 score
    matrix of the 12k-token layout fits."""
    outs = [fa.attention_reference(q[:, i:i + head_chunk],
                                   k[:, i:i + head_chunk],
                                   v[:, i:i + head_chunk], t, causal=causal,
                                   return_lse=True)
            for i in range(0, q.shape[1], head_chunk)]
    return (torch.cat([o for o, _ in outs], 1),
            torch.cat([lse for _, lse in outs], 1))


def kernel_vs_plain(meta_pipe, dev, gen):
    """K1/K2 and K6 (at every hs that fits) against the plain version on the
    DiT's layouts. Returns (K1/K2 results, K6 results)."""
    results, hn_results = [], []
    for name, height, width, unit, stage in LAYOUTS:
        _, t = layout_time_ids(meta_pipe, height, width, unit, stage, dev)
        L = t.shape[1]
        q = rms_normal((B, H, L, D), gen, dev)
        k = rms_normal((B, H, L, D), gen, dev)
        v = torch.randn((B, H, L, D), generator=gen, device=dev).bfloat16()
        valid = t[0] != fa.INVALID_TIME
        reps = 20 if L <= 4096 else 5
        for causal in (True, False):
            o_ref, lse_ref = plain_attention(q, k, v, t, causal)
            plain_ms = cuda_ms(lambda: plain_attention(q, k, v, t, causal),
                               reps=3, warmup=1)
            extra = {}
            if name == TIMED_LAYOUT:
                mask = sdpa_mask(t, causal)
                extra["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask), reps)
                pairs = B * H * visible_pairs(t[0], causal)
                extra["flops"] = 4 * D * pairs
                del mask
            split = tile_split(t, t, causal)
            for bounded in (True, False):
                def run():
                    return fa.flash_fwd_cuda(q, k, v, t, t, causal=causal,
                                             sm_scale=D ** -0.5,
                                             bounded=bounded)
                o, lse = run()
                torch.cuda.synchronize()
                do = (o.float() - o_ref.float())[:, :, valid].abs().max().item()
                dl = (lse - lse_ref)[:, :, valid].abs().max().item()
                r = dict(layout=name, L=L, causal=causal, bounded=bounded,
                         max_abs_err_o=do, max_abs_err_lse=dl,
                         ms=cuda_ms(run, reps), plain_ms=plain_ms,
                         tiles=split)
                if extra:
                    r["kernel_ms"] = kernel_device_ms(run, reps,
                                                      "flash_fwd_kernel")
                    # q, k, v read, o written, lse written, time ids read
                    nbytes = (4 * B * H * L * D * 2 + B * H * L * 4
                              + 2 * B * L * 4)
                    r["bound_ms"], r["bound_by"] = bound(extra["flops"],
                                                         nbytes)
                    r["library_ms"] = extra["library_ms"]
                    r["flops"] = extra["flops"]
                log("kernel vs plain " + json.dumps(r))
                if not (do <= O_ATOL and dl <= LSE_ATOL):
                    raise AssertionError(f"kernel disagrees with plain: {r}")
                results.append(r)
            hn_results += hn_vs_plain(q, k, v, t, causal, o_ref, lse_ref,
                                      name, reps, plain_ms, extra)
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    return results, hn_results


def tile_split(tq, tk, causal) -> dict:
    """How many (64-row, 128-key) tiles of one batch row the forward kernel
    skips, runs unmasked and masks: the SKIP/FULL/MASKED split of
    ``fa.tile_types``, per head."""
    types = fa.tile_types(tq[:1], tk[:1], fa.FWD_TILE_Q, fa.FWD_TILE_K,
                          causal)
    return {name: int((types == code).sum().item()) for name, code in (
        ("skip", fa.TILE_SKIP), ("full", fa.TILE_FULL),
        ("masked", fa.TILE_MASKED))}


def fwd_edge_checks(meta_pipe, dev, gen):
    """K1/K2 against the plain version where the main layouts do not reach:
    a short stage-0 layout of the last unit (few blocks: the one-consumer
    form), Lq != Lk (the first 1000 queries of the timed layout, which is
    not a multiple of the q-tile, against all its keys), an all-FULL layout
    (every key valid, non-causal) and head dim 128; K1's tolerances on the
    valid rows that see a key."""
    _, t_s0 = layout_time_ids(meta_pipe, HEIGHT, WIDTH, 15, 0, dev)
    _, t_s2 = layout_time_ids(meta_pipe, HEIGHT, WIDTH, 15, 2, dev)
    t_full = torch.zeros((B, 1024), dtype=torch.int32, device=dev)
    cases = (("384x640 u15 s0", t_s0, t_s0, D, (True, False)),
             ("384x640 u15 s2, Lq=1000", t_s2[:, :1000].contiguous(), t_s2,
              D, (True, False)),
             ("all FULL, L=1024", t_full, t_full, D, (False,)),
             ("384x640 u15 s2, D=128", t_s2, t_s2, 128, (True, False)))
    results = []
    for name, tq, tk, d, causals in cases:
        heads = H * D // d
        q = rms_normal((B, heads, tq.shape[1], d), gen, dev)
        k = rms_normal((B, heads, tk.shape[1], d), gen, dev)
        v = torch.randn((B, heads, tk.shape[1], d), generator=gen,
                        device=dev).bfloat16()
        for causal in causals:
            outs = [fa.attention_reference(
                q[:, i:i + 2], k[:, i:i + 2], v[:, i:i + 2], tq, tk,
                causal=causal, return_lse=True)
                for i in range(0, heads, 2)]
            o_ref = torch.cat([o for o, _ in outs], 1)
            lse_ref = torch.cat([lse for _, lse in outs], 1)
            seen = (lse_ref < 1e38) & (tq != fa.INVALID_TIME)[:, None, :]
            for bounded in (True, False):
                o, lse = fa.flash_fwd_cuda(q, k, v, tq, tk, causal=causal,
                                           sm_scale=d ** -0.5,
                                           bounded=bounded)
                torch.cuda.synchronize()
                r = dict(layout=name, Lq=tq.shape[1], Lk=tk.shape[1], d=d,
                         causal=causal, bounded=bounded,
                         tiles=tile_split(tq, tk, causal),
                         max_abs_err_o=(o.float() - o_ref.float())[seen]
                         .abs().max().item(),
                         max_abs_err_lse=(lse - lse_ref)[seen].abs().max()
                         .item())
                log("kernel vs plain, edge " + json.dumps(r))
                if not (r["max_abs_err_o"] <= O_ATOL
                        and r["max_abs_err_lse"] <= LSE_ATOL):
                    raise AssertionError(f"kernel disagrees with plain: {r}")
                results.append(r)
        del q, k, v, o_ref, lse_ref
        torch.cuda.empty_cache()
    return results


def host_us(fn, n=200) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def fwd_host_cost(meta_pipe, dev, gen):
    """What a K1 launch costs the host: the whole wrapper call (checks,
    allocations, tensor maps, the row-bounds and attention launches),
    bounded and classic; on one 256-row head, so that the host and not the
    card bounds the loop."""
    _, t = layout_time_ids(meta_pipe, HEIGHT, WIDTH, 15, 2, dev)
    q = rms_normal((1, 1, 256, D), gen, dev)
    t = t[:1, :256].contiguous()
    r = {f"wrapper_{'bounded' if bounded else 'classic'}_us": host_us(
        lambda: fa.flash_fwd_cuda(q, q, q, t, t, causal=True,
                                  sm_scale=D ** -0.5, bounded=bounded))
         for bounded in (True, False)}
    log("flash_fwd host cost per launch " + json.dumps(r))
    return r


def hn_vs_plain(q, k, v, t, causal, o_ref, lse_ref, name, reps, plain_ms,
                extra):
    """K6 at every hs whose block fits the card, against the plain version
    (K1's tolerances); hs = HN_TIMED_HS timed at the timed layout."""
    valid = t[0] != fa.INVALID_TIME
    L = t.shape[1]
    results = []
    for hs in fa.HN_HEADS_PER_BLOCK:
        res = fa.flash_fwd_hn_resources(hs, causal)
        if not res["fits"]:
            log(f"flash_fwd_hn hs={hs} does not fit: {json.dumps(res)}")
            continue

        def run(hs=hs):
            return fa.flash_fwd_hn_cuda(q, k, v, t, t, causal=causal,
                                        sm_scale=D ** -0.5, hs=hs)
        o, lse = run()
        torch.cuda.synchronize()
        r = dict(layout=name, L=L, causal=causal, hs=hs,
                 max_abs_err_o=(o.float() - o_ref.float())[:, :, valid]
                 .abs().max().item(),
                 max_abs_err_lse=(lse - lse_ref)[:, :, valid].abs().max()
                 .item())
        if extra and hs == HN_TIMED_HS:
            # the bounded forward's bytes and operations, as K1's
            nbytes = 4 * B * H * L * D * 2 + B * H * L * 4 + 2 * B * L * 4
            r.update(ms=cuda_ms(run, reps),
                     kernel_ms=kernel_device_ms(run, reps,
                                                "flash_fwd_hn_kernel"),
                     plain_ms=plain_ms, library_ms=extra["library_ms"])
            r["bound_ms"], r["bound_by"] = bound(extra["flops"], nbytes)
        log("heads-per-block kernel vs plain " + json.dumps(r))
        if not (r["max_abs_err_o"] <= O_ATOL
                and r["max_abs_err_lse"] <= LSE_ATOL):
            raise AssertionError(f"heads-per-block kernel disagrees: {r}")
        results.append(r)
        del o, lse
    return results


def hn_tool_layout(dev):
    """K6 at every hs that fits against the plain version on the inputs the
    experiment times: its 768p final-unit stage-2 layout (B=2, H=24, D=64,
    L=11008, q = k = v from its own seeded generator, causal), K1's
    tolerances."""
    q, t, _ = exp_flash_h2.layout_768p_stage2(dev)
    o_ref, lse_ref = plain_attention(q, q, q, t, True)
    results = hn_vs_plain(q, q, q, t, True, o_ref, lse_ref,
                          "768x1280 exp_flash_h2 sweep", 0, None, {})
    del q, t, o_ref, lse_ref
    torch.cuda.empty_cache()
    return results


def hn_empty_rows(dev, gen):
    """K6 at every hs that fits on rows with no visible key (all keys
    INVALID, and under causal all keys later): o = 0 and lse = 3e38."""
    q, k, v = (torch.randn((B, H, 256, D), generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    tq = torch.ones((B, 256), dtype=torch.int32, device=dev)
    for causal, tk in ((False, torch.full_like(tq, fa.INVALID_TIME)),
                       (True, torch.full_like(tq, 5))):
        for hs in fa.HN_HEADS_PER_BLOCK:
            if not fa.flash_fwd_hn_resources(hs, causal)["fits"]:
                continue
            o, lse = fa.flash_fwd_hn_cuda(q, k, v, tq, tk, causal=causal,
                                          sm_scale=D ** -0.5, hs=hs)
            torch.cuda.synchronize()
            if not (bool((o == 0).all()) and bool((lse == 3e38).all())):
                raise AssertionError(f"heads-per-block kernel, hs={hs} "
                                     f"causal={causal}: empty rows give "
                                     f"o != 0 or lse != 3e38")
    log("heads-per-block kernel: empty rows give o = 0 and lse = 3e38 at "
        "every hs that fits")


def tool_path():
    """The experiment's entry point, ``exp_flash_h2.main``, in this process:
    its checks (three K6 launches at hs=2) and its sweep at L=11008 (K1 and
    K6 at each hs that fits, each warmed up and timed); launches counted
    from 0 and held to exactly that."""
    reset_launch_counts()
    t0 = time.perf_counter()
    if exp_flash_h2.main(["--iters", str(TOOL_ITERS)]) != 0:
        raise AssertionError("exp_flash_h2.main failed")
    seconds = time.perf_counter() - t0
    launched = launch_counts()
    runs = exp_flash_h2.WARMUP + TOOL_ITERS
    fit = sum(fa.flash_fwd_hn_resources(hs, True)["fits"]
              for hs in fa.HN_HEADS_PER_BLOCK)
    want = expected(fwd=runs, hn=3 + fit * runs)
    log(f"exp_flash_h2 tool: {seconds:.3f} s, launches {launched}")
    if launched != want:
        raise AssertionError(f"tool launches {launched}, expected {want}")
    return launched


def plain_backward(q, k, v, t, o, lse, do, causal, head_chunk=2):
    """The plain backward in fp32, a few heads at a time."""
    outs = [fa.attention_backward_reference(
        q[:, i:i + head_chunk], k[:, i:i + head_chunk],
        v[:, i:i + head_chunk], t, t, o[:, i:i + head_chunk],
        lse[:, i:i + head_chunk], do[:, i:i + head_chunk], causal=causal)
        for i in range(0, q.shape[1], head_chunk)]
    return tuple(torch.cat([g[j] for g in outs], 1) for j in range(3))


BWD_KERNELS = {"dkv": "flash_bwd_dkv_kernel", "dq": "flash_bwd_dq_kernel",
               "delta": "bwd_delta_kernel"}


def bwd_path_ms(q, k, v, t, do, causal, reps):
    """The attention backward as the training path calls it:
    ``torch.autograd.grad`` through ``flash_attention`` less its forward,
    as :func:`sdpa_backward_ms` times SDPA (``ms``), and each backward
    kernel's own device time from a profiler trace of the same calls
    (``kernel_ms_dkv``, ``kernel_ms_dq``, ``kernel_ms_delta``; None where
    the trace holds no such kernel). Returns that dict and the trace's
    milliseconds per call of every kernel a forward plus backward
    launches."""
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def fwd():
        return fa.flash_attention(*qkv, t, causal=causal, bounded=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), qkv, do)

    r = {"ms": cuda_ms(fwd_bwd, reps) - cuda_ms(fwd, reps)}
    by_kernel = device_ms_by_kernel(fwd_bwd, reps)
    for key, name in BWD_KERNELS.items():
        ms = [kms for kname, kms in by_kernel.items() if name in kname]
        r[f"kernel_ms_{key}"] = sum(ms) if ms else None
    return r, by_kernel


def bwd_vs_plain(meta_pipe, dev, gen):
    """The backward kernels against the plain backward; upstream gradient
    zero on padded query rows (the backward's contract). A second run on
    the same inputs must give the same bits (two passes, no atomics)."""
    cases = [(name, H, D) for name, *_ in LAYOUTS] + [BWD_D128]
    results = []
    for name, heads, d in cases:
        _, height, width, unit, stage = next(x for x in LAYOUTS
                                             if x[0] == name)
        _, t = layout_time_ids(meta_pipe, height, width, unit, stage, dev)
        L = t.shape[1]
        q = rms_normal((B, heads, L, d), gen, dev)
        k = rms_normal((B, heads, L, d), gen, dev)
        v = torch.randn((B, heads, L, d), generator=gen, device=dev).bfloat16()
        valid = (t != fa.INVALID_TIME)[:, None, :, None]
        reps = 20 if L <= 4096 else 5
        for causal in (True, False):
            o, lse = fa.flash_fwd_cuda(q, k, v, t, t, causal=causal,
                                       sm_scale=d ** -0.5, bounded=True)
            do = (torch.randn(o.shape, generator=gen, device=dev)
                  * valid).bfloat16()
            got = fa.flash_bwd_cuda(q, k, v, t, t, o, lse, do,
                                    causal=causal, sm_scale=d ** -0.5)
            again = fa.flash_bwd_cuda(q, k, v, t, t, o, lse, do,
                                      causal=causal, sm_scale=d ** -0.5)
            torch.cuda.synchronize()
            ref = plain_backward(q, k, v, t, o, lse, do, causal)
            r = dict(layout=name, L=L, heads=heads, d=d, causal=causal,
                     repeat_equal=all(torch.equal(a, b)
                                      for a, b in zip(got, again)))
            if not r["repeat_equal"]:
                raise AssertionError(f"two backward runs differ at {r}")
            for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                scale = b.float().abs().max().item()
                if not (torch.isfinite(a).all() and err <= GRAD_REL * scale):
                    raise AssertionError(
                        f"backward kernel disagrees on {gname}: {err} vs "
                        f"max|ref| {scale} at {r}")
                r[f"max_abs_err_{gname}"], r[f"max_abs_{gname}"] = err, scale
            r.update(bwd_path_ms(q, k, v, t, do, causal, reps)[0])
            r["plain_ms"] = cuda_ms(
                lambda: plain_backward(q, k, v, t, o, lse, do, causal),
                reps=3, warmup=1)
            if name == TIMED_LAYOUT and d == D:
                r.update(sdpa_backward_ms(q, k, v, t, do, causal, reps))
                pairs = B * heads * visible_pairs(t[0], causal)
                io = B * heads * L * d * 2  # one [B, H, L, D] bf16 tensor
                # each reads q, k, v, do, lse, delta and the time ids;
                # writes dk and dv (K3) or dq (K4)
                reads = 4 * io + 2 * B * heads * L * 4 + 2 * B * L * 4
                r["flops_dkv"], r["flops_dq"] = 8 * d * pairs, 6 * d * pairs
                r["bound_ms_dkv"], r["bound_by_dkv"] = bound(
                    r["flops_dkv"], reads + 2 * io)
                r["bound_ms_dq"], r["bound_by_dq"] = bound(
                    r["flops_dq"], reads + io)
                if None in (r["kernel_ms_dkv"], r["kernel_ms_dq"],
                            r["kernel_ms_delta"]):
                    raise AssertionError(f"the profiler found no backward "
                                         f"kernel: {r}")
            log("backward kernels vs plain " + json.dumps(r))
            results.append(r)
            del o, lse, do, got, again, ref
        del q, k, v
        torch.cuda.empty_cache()
    return results


def sdpa_backward_ms(q, k, v, t, do, causal, reps):
    """``scaled_dot_product_attention``'s backward with the time-id mask:
    its forward plus backward less its forward."""
    mask = sdpa_mask(t, causal)
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*qkv, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), qkv, do)

    fwd_ms = cuda_ms(fwd, reps)
    return {"library_fwd_ms": fwd_ms,
            "library_ms": cuda_ms(fwd_bwd, reps) - fwd_ms}


def conv_bound(b, t, h, w, c, co, front):
    """Bound of one causal conv: 2 * 9 * C * Co flops per output pixel and
    temporal tap it reads (27 taps; without front frames, 9 at t = 0 and 18
    at t = 1, as the kernel skips the rest); x, the weights, the bias (fp32)
    and the front frames read, y written."""
    taps = 27 * t if front else 27 * t - 18 - 9 * (t > 1)
    flops = 2 * c * co * b * h * w * taps
    nbytes = (2 * b * t * h * w * (c + co) + 2 * 27 * c * co + 4 * co
              + front * 2 * b * 2 * h * w * c)
    return flops, bound(flops, nbytes)


def record_conv_shapes(shapes: set):
    """A patch of the VAE's conv call that adds (B, T, H, W, C, Co, front)
    of every admitted conv it runs to ``shapes``: the shapes the paths give
    the kernel, for ``conv_vs_plain``."""
    conv = vae_layers.causal_conv3d

    def recorder(x, weight, bias, front=None):
        shapes.add(tuple(x.shape) + (weight.shape[0], front is not None))
        return conv(x, weight, bias, front)

    return mock.patch.object(vae_layers, "causal_conv3d", recorder)


def conv_vs_plain(shapes, dev, gen):
    """The conv kernel against the fp32 plain version at every (B, T, H, W,
    C, Co) the paths launched it at, each with zero and with carried front
    frames; the kernel and cuDNN's bf16 channels-last ``F.conv3d`` on the
    same (front-padded) input timed at each, the plain version at
    ``TIMED_CONV``."""
    if TIMED_CONV not in shapes:
        raise AssertionError(f"no path ran the timed conv {TIMED_CONV}")
    results = []
    for b, t, h, w, c, co in sorted({s[:-1] for s in shapes}):
        weight = (torch.randn((co, c, 3, 3, 3), generator=gen, device=dev)
                  / math.sqrt(27 * c)).bfloat16()
        weight = weight.contiguous(memory_format=torch.channels_last_3d)
        bias = (0.1 * torch.randn((co,), generator=gen, device=dev)
                ).bfloat16()
        x = torch.randn((b, t, h, w, c), generator=gen, device=dev).bfloat16()
        carried = torch.randn((b, 2, h, w, c), generator=gen, device=dev
                              ).bfloat16()
        # above the 50 MB L2 every launch finds its input cold anyway
        reps = 10 if b * t * h * w * max(c, co) * 2 > 50e6 else 30
        for front in (False, True):
            fr = carried if front else None
            y = cc.causal_conv3d_cuda(x, weight, bias, fr)
            repeat_equal = torch.equal(
                y, cc.causal_conv3d_cuda(x, weight, bias, fr))
            torch.cuda.synchronize()
            ref = cc.causal_conv3d_reference(
                x.float(), weight.float(), bias.float(),
                carried.float() if front else None)
            err = (y.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            del ref
            ms = cuda_ms(lambda: cc.causal_conv3d_cuda(x, weight, bias, fr),
                         reps)
            xl = torch.cat([carried if front else torch.zeros_like(carried),
                            x], 1).permute(0, 4, 1, 2, 3)
            library_ms = cuda_ms(lambda: F.conv3d(
                xl, weight, bias, padding=(0, 1, 1)), reps)
            lib = F.conv3d(xl, weight, bias, padding=(0, 1, 1))
            lib_err = (lib.permute(0, 2, 3, 4, 1).float()
                       - y.float()).abs().max().item()
            flops, (bound_ms, bound_by) = conv_bound(b, t, h, w, c, co, front)
            r = dict(shape=f"{c}->{co} {h}x{w}", b=b, t=t, front=front,
                     on_path=(b, t, h, w, c, co, front) in shapes,
                     max_abs_err=err, max_abs_ref=scale,
                     repeat_equal=repeat_equal,
                     cudnn_vs_kernel_max_abs=lib_err, ms=ms,
                     library_ms=library_ms, bound_ms=bound_ms,
                     bound_by=bound_by, tflops=flops / ms / 1e9)
            if (b, t, h, w, c, co, front) == TIMED_CONV:
                r["plain_ms"] = cuda_ms(lambda: cc.causal_conv3d_reference(
                    x, weight, bias, fr), reps=3, warmup=1)
            log("conv kernel vs plain " + json.dumps(r))
            if not (torch.isfinite(y).all() and err <= CONV_REL * scale
                    and repeat_equal):
                raise AssertionError(f"conv kernel disagrees: {r}")
            results.append(r)
            del y, xl, lib
        del x, carried, weight, bias
        torch.cuda.empty_cache()
    return results


# (B, T, H, W, C, Co, fronts): what the paths' shapes do not reach: one
# and two frames without front frames (the skipped taps), an H x W that the
# 16 x 16 tile does not divide, and 512 -> 256 channels
CONV_EDGES = ((1, 1, 48, 80, 128, 128, (False,)),
              (1, 2, 96, 160, 256, 256, (False,)),
              (1, 3, 20, 36, 128, 128, (False, True)),
              (2, 2, 13, 17, 512, 256, (False, True)))


def conv_edge_checks(dev, gen):
    """K5 against the fp32 plain version at ``CONV_EDGES``, within the path
    shapes' limit."""
    results = []
    for b, t, h, w, c, co, fronts in CONV_EDGES:
        weight = (torch.randn((co, c, 3, 3, 3), generator=gen, device=dev)
                  / math.sqrt(27 * c)).bfloat16()
        weight = weight.contiguous(memory_format=torch.channels_last_3d)
        bias = (0.1 * torch.randn((co,), generator=gen, device=dev)
                ).bfloat16()
        x = torch.randn((b, t, h, w, c), generator=gen, device=dev).bfloat16()
        carried = torch.randn((b, 2, h, w, c), generator=gen, device=dev
                              ).bfloat16()
        for front in fronts:
            fr = carried if front else None
            y = cc.causal_conv3d_cuda(x, weight, bias, fr)
            torch.cuda.synchronize()
            ref = cc.causal_conv3d_reference(
                x.float(), weight.float(), bias.float(),
                carried.float() if front else None)
            r = dict(shape=f"{c}->{co} {h}x{w}", b=b, t=t, front=front,
                     max_abs_err=(y.float() - ref).abs().max().item(),
                     max_abs_ref=ref.abs().max().item())
            log("conv kernel vs plain, edge " + json.dumps(r))
            if not (torch.isfinite(y).all()
                    and r["max_abs_err"] <= CONV_REL * r["max_abs_ref"]):
                raise AssertionError(f"conv kernel disagrees: {r}")
            results.append(r)
    return results


def smooth_video(gen, dev, frames, height, width):
    """Seeded smooth pixels [1, T, H, W, 3] in [-1, 1]: coarse uniform noise,
    trilinearly upsampled."""
    coarse = torch.rand((1, 3, max(frames // 4, 2), height // 64, width // 64),
                        generator=gen, device=dev)
    x = F.interpolate(coarse, size=(frames, height, width), mode="trilinear",
                      align_corners=True)
    return (x * 2 - 1).permute(0, 2, 3, 4, 1).contiguous()


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@torch.no_grad()
def encode_check(vae, dev, gen):
    """``chunk_encode`` of a 17-frame 384x640 clip through the conv kernel,
    through the plain version, and in fp32 (a float copy of the VAE, every
    conv on fp32 ``F.conv3d``). Two bf16 routes that round at the same
    places still drift apart through 20 convs and their group norms, as far
    as each drifts from fp32; so the kernel route must also be no further
    from fp32 than the plain route (within 10%), and each conv's own error
    in place (against the plain version on the same input) must stay
    within ``IN_PLACE_REL_L2``."""
    clip = smooth_video(gen, dev, 17, HEIGHT, WIDTH)
    windows = len(vae_model._window_starts(17, ENCODE_WINDOW))
    expect = kernel_conv_count(vae.encoder) * windows
    in_place = []

    def per_conv(m, args, out):  # the first window's is_init=True: no front
        if m.uses_kernel:
            ref = cc.causal_conv3d_reference(args[0].permute(0, 2, 3, 4, 1),
                                             m.conv.weight, m.conv.bias)
            in_place.append(rel_l2(out.permute(0, 2, 3, 4, 1), ref))

    before = cc.causal_conv3d_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_k = vae_model.chunk_encode(vae, clip, ENCODE_WINDOW)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launched = cc.causal_conv3d_cuda.launches - before
    with mock.patch.object(vae_layers, "causal_conv3d",
                           cc.causal_conv3d_reference):
        t0 = time.perf_counter()
        m_p = vae_model.chunk_encode(vae, clip, ENCODE_WINDOW)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    vae32 = copy.deepcopy(vae).float()
    m_32 = vae_model.chunk_encode(vae32, clip, ENCODE_WINDOW)
    hooks = [m.register_forward_hook(per_conv) for m in vae.encoder.modules()
             if isinstance(m, vae_layers.CausalConv3d)]
    try:
        vae_model.chunk_encode(vae, clip, ENCODE_WINDOW)
    finally:
        for h in hooks:
            h.remove()
    del vae32
    if not all(torch.isfinite(m).all() for m in (m_k, m_p, m_32)):
        raise AssertionError("non-finite moments")
    r = dict(frames=17, moments=list(m_k.shape), rel_l2=rel_l2(m_k, m_p),
             kernel_vs_fp32=rel_l2(m_k, m_32), plain_vs_fp32=rel_l2(m_p, m_32),
             max_in_place_rel_l2=max(in_place), launches=launched,
             expected_launches=expect, kernel_s=kernel_s, plain_s=plain_s,
             moments_rms=m_32.square().mean().sqrt().item())
    log("full-width encode, kernel vs plain " + json.dumps(r))
    if launched != expect:
        raise AssertionError(f"{launched} conv launches in the encode, "
                             f"expected {expect}")
    if not (r["rel_l2"] <= ENCODE_REL_L2
            and r["kernel_vs_fp32"] <= 1.1 * r["plain_vs_fp32"]
            and r["max_in_place_rel_l2"] <= IN_PLACE_REL_L2):
        raise AssertionError(f"encode kernel route off: {r}")
    return r


def vae_grad_check(vae, dev, gen):
    """A backward through ``vae.decode`` of a small latent (2 frames of
    ``VAE_GRAD_LATENT``, 9 frames out) of a loss that weights every pixel
    by a seeded normal draw, through the conv kernel (its gradient route,
    ``CausalConv3dFunction``), through the plain version (autograd through
    ``causal_conv3d_reference``) and in fp32 (a float copy, every conv on
    ``F.conv3d``). Every kernel-routed conv's weight must get a finite,
    nonzero gradient; the two bf16 routes' decoder gradients drift from
    each other as the encode's moments do, so, as in
    :func:`encode_check`, the kernel route's distance to fp32 must be within
    1.1x of the plain route's. The kernel route's conv launches are
    returned (one per admitted decoder conv)."""
    h, w = VAE_GRAD_LATENT
    z = torch.randn((1, 2, h, w, vae.config.latent_channels), generator=gen,
                    device=dev)
    weight = torch.randn((1, 9, 8 * h, 8 * w, 3), generator=gen, device=dev)

    def grads(model):
        model.zero_grad(set_to_none=True)
        pixels = model.decode(z)
        (pixels.float() * weight).mean().backward()
        torch.cuda.synchronize()
        out = {n: p.grad for n, p in model.decoder.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    reset_launch_counts()
    g_k = grads(vae)
    launched = launch_counts()
    with mock.patch.object(vae_layers, "causal_conv3d",
                           cc.causal_conv3d_reference):
        g_p = grads(vae)
    vae32 = copy.deepcopy(vae).float()
    g_32 = grads(vae32)
    del vae32
    routed = [f"{n}.conv.weight" for n, m in vae.decoder.named_modules()
              if isinstance(m, vae_layers.CausalConv3d) and m.uses_kernel]
    bad = [n for n in routed if g_k[n] is None
           or not bool(torch.isfinite(g_k[n]).all())
           or not bool((g_k[n] != 0).any())]
    names = sorted(g_k)
    flat = {route: torch.cat([g[n].float().flatten() for n in names])
            for route, g in (("kernel", g_k), ("plain", g_p), ("fp32", g_32))}
    r = dict(latent=list(z.shape), routed_convs=len(routed),
             rel_l2=rel_l2(flat["kernel"], flat["plain"]),
             kernel_vs_fp32=rel_l2(flat["kernel"], flat["fp32"]),
             plain_vs_fp32=rel_l2(flat["plain"], flat["fp32"]),
             launches=launched, bad_convs=bad)
    log("VAE decode gradient, kernel vs plain vs fp32 " + json.dumps(r))
    if bad or len(routed) != kernel_conv_count(vae.decoder):
        raise AssertionError(f"kernel-routed convs without a finite nonzero "
                             f"weight gradient: {bad}")
    if launched != expected(conv=len(routed)):
        raise AssertionError(f"decode gradient launches {launched}, "
                             f"expected {expected(conv=len(routed))}")
    if not (torch.isfinite(flat["kernel"]).all()
            and r["kernel_vs_fp32"] <= 1.1 * r["plain_vs_fp32"]):
        raise AssertionError(f"decode gradient kernel route off: {r}")
    return r, launched


@torch.no_grad()
def randomize_(module: torch.nn.Module, gen: torch.Generator, std=0.02):
    """N(0, std) for every weight and bias, 1 + N(0, std) for norm weights:
    no layer is zero, and q/k keep the RMS the qk-norm gives them."""
    for name, p in module.named_parameters():  # the MMDiT's table is a buffer
        p.normal_(0.0, std, generator=gen)
        if p.dim() == 1 and "norm" in name and name.endswith("weight"):
            p.add_(1.0)


def dit_inputs(meta_pipe, dev, gen, dit, dtype):
    """Inputs of one forward at the 384x640 unit 15 stage 2 layout (the
    MMDiT's crop origin last)."""
    cfg = dit.config
    positions, t = layout_time_ids(meta_pipe, 384, 640, 15, 2, dev)
    lat_time = t[:, TEXT_LEN:]
    lat_len = lat_time.shape[1]
    width = cfg.patch_size ** 2 * dit.latent_channels  # one token
    tokens = torch.randn((B, lat_len, width), generator=gen,
                         device=dev).to(dtype)
    pos = torch.as_tensor(positions, device=dev)[None].expand(B, -1, -1)
    text = torch.randn((B, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                       device=dev).to(dtype)
    mask = text_time(dev)[None].expand(B, -1) == 0
    pooled = torch.randn((B, cfg.pooled_projection_dim), generator=gen,
                         device=dev).to(dtype)
    ts = torch.full((B,), 900.0, device=dev)
    return ((tokens, pos, lat_time, text, mask, pooled, ts)
            + dit.stage_inputs(B, 48, 80, dev)), lat_time[0]


@torch.no_grad()
def dit_check(dit, meta_pipe, dev, gen):
    inputs, lat_time = dit_inputs(meta_pipe, dev, gen, dit,
                                  next(dit.parameters()).dtype)
    before = fa.flash_fwd_cuda.launches
    out_k = dit(*inputs)
    torch.cuda.synchronize()
    launched = fa.flash_fwd_cuda.launches - before
    if launched != dit.num_attention_calls:
        raise AssertionError(f"{launched} kernel launches in one forward, "
                             f"expected {dit.num_attention_calls}")

    def plain(q, k, v, time_ids, *, causal, sm_scale, bounded):
        return fa.attention_reference(q, k, v, time_ids, causal=causal,
                                      sm_scale=sm_scale)

    with mock.patch.object(flux_blocks, "flash_attention", plain):
        out_p = dit(*inputs)
    torch.cuda.synchronize()
    valid = lat_time != fa.INVALID_TIME
    a, b = out_k[:, valid].float(), out_p[:, valid].float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite DiT output")
    rel = ((a - b).norm() / b.norm()).item()
    log(f"full-width {type(dit).__name__} forward, "
        f"L={inputs[2].shape[1] + TEXT_LEN}: "
        f"kernel vs plain relative L2 {rel:.3e} (limit {DIT_REL_L2}), "
        f"|out| rms {b.square().mean().sqrt().item():.3e}")
    if not rel <= DIT_REL_L2:
        raise AssertionError(f"DiT kernel vs plain relative L2 {rel}")
    return rel


def training_batch(dit_cfg, dev, gen, batch):
    """The JAX CLI's default training shape at 384x640: latents [B, 16, 48,
    80, 16] N(0, 1), T5 features [B, 128, 4096] with 100 valid tokens,
    pooled [B, 768] (flux) or [B, 2048] (MMDiT), null features of
    zeros."""
    lat = torch.randn((batch, TRAIN_FRAMES, 48, 80, 16), generator=gen,
                      device=dev)
    text = torch.randn((batch, TEXT_LEN, dit_cfg.joint_attention_dim),
                       generator=gen, device=dev)
    mask = (text_time(dev) == 0)[None].expand(batch, -1).contiguous()
    pooled = torch.randn((batch, dit_cfg.pooled_projection_dim),
                         generator=gen, device=dev)
    return {"latents": lat, "text_emb": text, "text_mask": mask,
            "pooled": pooled, "null_text_emb": torch.zeros_like(text),
            "null_pooled": torch.zeros_like(pooled)}


def launch_counts() -> dict:
    """Launches by kernel; ``flash_fwd`` is the bounded forward (K1),
    ``flash_fwd_classic`` the classic one (K2), which no path runs,
    ``flash_fwd_hn`` the heads-per-block forward (K6), which only the
    ``exp_flash_h2`` tool runs."""
    classic = fa.flash_fwd_cuda.classic_launches
    return {"flash_fwd": fa.flash_fwd_cuda.launches - classic,
            "flash_fwd_classic": classic,
            "flash_bwd_dkv": fa.flash_bwd_cuda.dkv_launches,
            "flash_bwd_dq": fa.flash_bwd_cuda.dq_launches,
            "causal_conv3d": cc.causal_conv3d_cuda.launches,
            "flash_fwd_hn": fa.flash_fwd_hn_cuda.launches}


def reset_launch_counts():
    fa.flash_fwd_cuda.launches = 0
    fa.flash_fwd_cuda.classic_launches = 0
    fa.flash_bwd_cuda.dkv_launches = 0
    fa.flash_bwd_cuda.dq_launches = 0
    cc.causal_conv3d_cuda.launches = 0
    fa.flash_fwd_hn_cuda.launches = 0


def expected(fwd=0, bwd=0, conv=0, hn=0) -> dict:
    """Launch counts of a path: ``bwd`` of each backward kernel."""
    return {"flash_fwd": fwd, "flash_fwd_classic": 0, "flash_bwd_dkv": bwd,
            "flash_bwd_dq": bwd, "causal_conv3d": conv, "flash_fwd_hn": hn}


def counted(before: dict) -> dict:
    return {k: n - before[k] for k, n in launch_counts().items()}


def dit_grad_check(dit, dev, gen):
    """One training-loss backward of a batch row at the stage-2 training
    layout through the kernels and through the plain version. Every
    parameter gets a nonzero gradient but the DiT's
    ``gradient_free_parameters`` (the MMDiT's last-block text-query
    projection, whose output that block discards), which get exactly 0."""
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    batch = training_batch(dit.config, dev, gen, 1)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    sb = add_ar_noise_stage(draws, sched, latent_pyramid(batch["latents"], 3),
                            2, 3, TRAIN_FRAMES)
    tokens, positions, time_ids, trainable = pack_clips(sb.clips)
    pos = torch.as_tensor(positions, device=dev)[None]
    times = torch.as_tensor(time_ids, device=dev)[None]
    target = patchify(sb.targets)
    L = TEXT_LEN + tokens.shape[1]
    extra = dit.stage_inputs(1, 48, 80, dev)

    def backward():
        dit.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pred = dit(tokens, pos, times, batch["text_emb"],
                       batch["text_mask"], batch["pooled"], sb.timesteps,
                       *extra)
            loss = (pred[:, -trainable:].float() - target.float()).square(
                ).mean()
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in dit.named_parameters()}
        dit.zero_grad(set_to_none=True)
        return loss.item(), grads

    before = launch_counts()
    t0 = time.perf_counter()
    loss_k, gk = backward()
    kernel_s = time.perf_counter() - t0
    launched = counted(before)
    n = dit.num_attention_calls
    if launched != expected(2 * n, n):
        raise AssertionError(f"launches {launched} in one remat forward+"
                             f"backward, expected {expected(2 * n, n)}")
    missing = [name for name, g in gk.items()
               if g is None or not bool((g != 0).any())]
    if missing != list(getattr(dit, "gradient_free_parameters", ())):
        raise AssertionError(f"{len(missing)} parameters got no gradient "
                             f"through the kernels, e.g. {missing[:5]}")

    def plain(q, k, v, time_ids, *, causal, sm_scale, bounded):
        return fa.attention_reference(q, k, v, time_ids, causal=causal,
                                      sm_scale=sm_scale)

    with mock.patch.object(flux_blocks, "flash_attention", plain):
        t0 = time.perf_counter()
        loss_p, gp = backward()
        plain_s = time.perf_counter() - t0
    diff2 = ref2 = 0.0
    worst = ("", 0.0)
    for name, g in gk.items():
        d2 = (g - gp[name]).float().square().sum().item()
        r2 = gp[name].float().square().sum().item()
        diff2, ref2 = diff2 + d2, ref2 + r2
        if r2 > 0 and math.sqrt(d2 / r2) > worst[1]:
            worst = (name, math.sqrt(d2 / r2))
    rel = math.sqrt(diff2 / ref2)
    r = dict(dit=type(dit).__name__, L=L, loss_kernel=loss_k,
             loss_plain=loss_p, rel_l2=rel, worst_leaf=worst[0],
             worst_leaf_rel_l2=worst[1], gradient_free=missing,
             launches=launched, kernel_s=kernel_s, plain_s=plain_s)
    log("full-width DiT gradient, kernel vs plain " + json.dumps(r))
    if not (math.isfinite(rel) and rel <= DIT_GRAD_REL_L2):
        raise AssertionError(f"DiT gradient relative L2 {rel} > "
                             f"{DIT_GRAD_REL_L2}")
    return r


@torch.no_grad()
def zero_output_(dit):
    """A fresh DiT's zero output projection (``randomize_`` drew it): the
    loss starts at E[target^2], below the anomaly gate."""
    dit.proj_out.weight.zero_()
    dit.proj_out.bias.zero_()


def train(dit, dev, gen, n_steps=TRAIN_STEPS):
    """``n_steps`` train steps of a release DiT at the CLI's default shape.
    Returns (steps, launches, peak GB, state)."""
    zero_output_(dit)
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(dit, TrainConfig(
        learning_rate=5e-5, weight_decay=1e-4, max_grad_norm=1.0,
        lr_schedule=cosine_schedule(5e-5, 1e-6, 1000, 10, 1000)))
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    step_fn = make_train_step(dit, sched, (1, 2, 1), True, 1, 1 / 3,
                              cfg_rate=0.1, compute_dtype=torch.bfloat16)
    batch = training_batch(dit.config, dev, gen, TRAIN_BATCH)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    steps = []
    reset_launch_counts()
    for _ in range(n_steps):
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=TRAIN_FRAMES))
        before = dit.proj_out.weight.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, draws, units)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = not torch.equal(before, dit.proj_out.weight)
        r = dict(dit=type(dit).__name__, step=state.step, units=units,
                 loss=m["train/loss"],
                 grad_norm=m["train/grad_norm"], applied=m["train/applied"],
                 moved=moved, lr_count=state.opt_count, seconds=seconds)
        log("train step " + json.dumps(r))
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite train step {r}")
        steps.append(r)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    attentions = dit.num_attention_calls * 3 * n_steps  # 3 stage forwards
    if launched != expected(2 * attentions, attentions):
        raise AssertionError(f"train launches {launched}, expected "
                             f"{expected(2 * attentions, attentions)}")
    if not any(r["applied"] and r["moved"] for r in steps):
        raise AssertionError("no train step passed the anomaly gate and "
                             "moved the parameters")
    log(f"train: peak memory {peak:.3f} GB, launches {launched}")
    return steps, launched, peak, state


def train_raw_pixels(dit, vae, state, dev, gen):
    """Raw-pixel train steps: ``make_train_step(vae=)`` on a ``"video"``
    batch of 121 frames of 384x640 (16 latent frames, the latent steps'
    shape), continuing ``state``. Returns (steps, launches, peak GB)."""
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    step_fn = make_train_step(dit, sched, (1, 2, 1), True, 1, 1 / 3,
                              cfg_rate=0.1, compute_dtype=torch.bfloat16,
                              vae=vae)
    batch = training_batch(dit.config, dev, gen, TRAIN_BATCH)
    del batch["latents"]
    batch["video"] = torch.rand((TRAIN_BATCH, RAW_FRAMES, HEIGHT, WIDTH, 3),
                                generator=gen, device=dev) * 2 - 1
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED + 1))
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    reset_launch_counts()
    for _ in range(RAW_STEPS):
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=TRAIN_FRAMES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, draws, units)
        torch.cuda.synchronize()
        r = dict(step=state.step, frames=RAW_FRAMES, units=units,
                 loss=m["train/loss"], grad_norm=m["train/grad_norm"],
                 applied=m["train/applied"],
                 seconds=time.perf_counter() - t0)
        log("raw-pixel train step " + json.dumps(r))
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["applied"]):
            raise AssertionError(f"raw-pixel train step failed: {r}")
        steps.append(r)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    attentions = dit.num_attention_calls * 3 * RAW_STEPS
    windows = len(vae_model._window_starts(RAW_FRAMES, VIDEO_ENCODE_WINDOW))
    want = expected(2 * attentions, attentions, kernel_conv_count(
        vae.encoder) * windows * TRAIN_BATCH * RAW_STEPS)
    if launched != want:
        raise AssertionError(f"raw-pixel train launches {launched}, "
                             f"expected {want}")
    log(f"raw-pixel train: peak memory {peak:.3f} GB, launches {launched}")
    return steps, launched, peak


def serve(pipe, dev, gen, name, temp):
    cfg = pipe.dit.config
    emb = torch.randn((1, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                      device=dev).to(pipe.dtype)
    mask = (text_time(dev) == 0)[None]
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen,
                         device=dev).to(pipe.dtype)
    seen = []
    decode = pipe.decode_latent

    def spy(latents, plan):
        seen.append(latents)
        return decode(latents, plan)

    forwards = sum(STEPS) + (temp - 1) * sum(VIDEO_STEPS)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy):
        t0 = time.perf_counter()
        frames = pipe.generate(
            torch.Generator(dev).manual_seed(SEED + temp), emb, mask, pooled,
            emb * 0, mask, pooled * 0, height=HEIGHT, width=WIDTH, temp=temp,
            num_inference_steps=STEPS, video_num_inference_steps=VIDEO_STEPS,
            guidance_scale=7.0, video_guidance_scale=5.0,
            output_type="pixels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counted(before)
    windows = len(vae_model._window_starts(temp, DECODE_WINDOW, 1))
    want = expected(pipe.dit.num_attention_calls * forwards,
                    conv=kernel_conv_count(pipe.vae.decoder) * windows)
    check_request(frames, seen, launched, want, temp)
    r = dict(request=name, temp=temp, frames=frames.shape[1],
             dit_forwards=forwards, launches=launched, wall_s=wall,
             dit_s=pipe.last_dit_seconds, decode_s=pipe.last_decode_seconds,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             latent_rms=seen[0].square().mean().sqrt().item(),
             frame_std=frames.float().std().item())
    log("request " + json.dumps(r))
    return r


def check_request(frames, seen, launched, want, temp):
    expect = (1, 1 + 8 * (temp - 1), HEIGHT, WIDTH, 3)
    if tuple(frames.shape) != expect or frames.dtype != torch.uint8:
        raise AssertionError(f"frames {tuple(frames.shape)} {frames.dtype}, "
                             f"expected {expect} uint8")
    if not torch.isfinite(seen[0]).all():
        raise AssertionError("non-finite latents")
    if frames.min() == frames.max():
        raise AssertionError("constant frames")
    if launched != want:
        raise AssertionError(f"launches {launched}, expected {want}")


class StandInTextEncoder:
    """Text features drawn from a generator seeded by the prompts, in the
    DiT's dtype: embeddings [B, 128, 4096], a mask of 100 valid tokens and
    pooled [B, 768]."""

    def __init__(self, cfg, dev, dtype):
        self.cfg, self.dev, self.dtype = cfg, dev, dtype

    def __call__(self, prompts):
        g = torch.Generator(self.dev).manual_seed(
            zlib.crc32("|".join(prompts).encode()))
        b = len(prompts)
        emb = torch.randn((b, TEXT_LEN, self.cfg.joint_attention_dim),
                          generator=g, device=self.dev).to(self.dtype)
        mask = (text_time(self.dev) == 0)[None].expand(b, -1)
        pooled = torch.randn((b, self.cfg.pooled_projection_dim),
                             generator=g, device=self.dev).to(self.dtype)
        return emb, mask, pooled


def serve_i2v(pipe, dev, gen):
    """One image-to-video request through ``PyramidFlowRunner``."""
    runner = PyramidFlowRunner(pipe, StandInTextEncoder(pipe.dit.config, dev,
                                                        pipe.dtype))
    image = ((smooth_video(gen, dev, 1, HEIGHT, WIDTH)[0, 0] + 1) * 127.5
             ).round().to(torch.uint8).cpu().numpy()
    seen, encode_s = [], []
    decode, encode = pipe.decode_latent, vae_model.chunk_encode

    def spy(latents, plan):
        seen.append(latents)
        return decode(latents, plan)

    def timed_encode(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
        return out

    forwards = (I2V_TEMP - 1) * sum(VIDEO_STEPS)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy), \
            mock.patch.object(vae_model, "chunk_encode", timed_encode):
        t0 = time.perf_counter()
        frames = runner.generate_i2v(
            "a red kite over a beach at dawn", image, seed=SEED,
            height=HEIGHT, width=WIDTH, temp=I2V_TEMP,
            num_inference_steps=STEPS,
            video_num_inference_steps=VIDEO_STEPS, guidance_scale=7.0,
            video_guidance_scale=5.0, output_type="pixels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counted(before)
    windows = len(vae_model._window_starts(I2V_TEMP, DECODE_WINDOW, 1))
    want = expected(pipe.dit.num_attention_calls * forwards, conv=(
        kernel_conv_count(pipe.vae.encoder)
        + kernel_conv_count(pipe.vae.decoder) * windows))
    check_request(frames, seen, launched, want, I2V_TEMP)
    r = dict(request="i2v", temp=I2V_TEMP, frames=frames.shape[1],
             dit_forwards=forwards, launches=launched, wall_s=wall,
             encode_s=encode_s[0], dit_s=pipe.last_dit_seconds,
             decode_s=pipe.last_decode_seconds,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             latent_rms=seen[0].square().mean().sqrt().item(),
             frame_std=frames.float().std().item())
    log("request " + json.dumps(r))
    return r


def mmdit_paths(vae, meta_pipe, dev, gen, paths):
    """The release MMDiT (24 joint blocks, 24 x 64 heads): a bf16 forward
    kernel vs plain, one T2V request through
    ``PyramidFlowPipeline(model_name="pyramid_mmdit")`` with the release
    VAE, then with fp32 parameters and remat the gradient check and
    ``MMDIT_TRAIN_STEPS`` latent train steps. Adds the request's and the
    steps' launches to ``paths``."""
    t0 = time.perf_counter()
    mmdit = PyramidDiffusionMMDiT(MMDiTConfig(), dtype=torch.bfloat16,
                                  device=dev)
    randomize_(mmdit, gen)
    torch.cuda.synchronize()
    log(f"MMDiT: {sum(p.numel() for p in mmdit.parameters()) / 1e9:.3f} B "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    dit_check(mmdit, meta_pipe, dev, gen)
    pipe = PyramidFlowPipeline(mmdit, vae, dtype=torch.bfloat16, device=dev,
                               model_name="pyramid_mmdit")
    reset_launch_counts()
    serve(pipe, dev, gen, "mmdit", MMDIT_TEMP)
    paths["MMDiT text-to-video"] = launch_counts()
    mmdit_text_request(pipe, dev, paths)
    del pipe, mmdit
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tmm = PyramidDiffusionMMDiT(MMDiTConfig(), dtype=torch.float32,
                                device=dev, remat=True)
    randomize_(tmm, gen)
    torch.cuda.synchronize()
    log(f"training MMDiT: fp32 parameters, remat, built in "
        f"{time.perf_counter() - t0:.1f} s")
    dit_grad_check(tmm, dev, gen)
    _, paths["MMDiT train (latents)"], _, state = train(
        tmm, dev, gen, MMDIT_TRAIN_STEPS)
    del tmm, state
    gc.collect()
    torch.cuda.empty_cache()


@torch.no_grad()
def randomize_lpips_(lpips: LPIPS, gen: torch.Generator):
    """He-normal VGG weights (each ReLU keeps its input's scale), zero
    biases, and heads |N(0, 1/C)| (non-negative, as the released ones)."""
    for name, p in lpips.named_parameters():
        if name.startswith("lin"):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen).abs_()
        elif name.endswith("weight"):
            p.normal_(0.0, math.sqrt(2.0 / p[0].numel()), generator=gen)
        else:
            p.zero_()


@torch.no_grad()
def randomize_disc_(disc: torch.nn.Module, gen: torch.Generator):
    """N(0, 0.02) conv weights and zero biases, as JAX initialises them."""
    for name, p in disc.named_parameters():
        if name.endswith("weight"):
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.zero_()


def gan_grad_check(vae, lpips, disc, dev, gen):
    """The generator's gradient of the GAN-VAE loss (``make_vae_train_step``
    with ``grads_only``, the discriminator on, so the adaptive weight is in
    it) on a smooth ``VAE_GRAD_CLIP`` clip of the fp32-master VAE: under
    bf16 autocast through the conv kernel, the same with the plain version
    patched in, and in fp32 (no autocast: every conv on fp32 ``F.conv3d``).
    Every conv that the kernel takes, in the encoder and the decoder, must
    get a finite, nonzero weight gradient; the kernel route's distance to
    fp32 must be within 1.1x of the plain route's; and the kernel route must
    launch the conv kernel once per admitted conv. Returns (result,
    launches)."""
    frames, side = VAE_GRAD_CLIP
    clip = smooth_video(gen, dev, frames, side, side)
    config = VAETrainConfig(disc_start=0)

    def grads(compute_dtype):
        state = create_vae_train_state(vae, disc, config)
        step = make_vae_train_step(vae, lpips, disc, grads_only=True,
                                   compute_dtype=compute_dtype)
        g, _, m = step(state, clip,
                       GeneratorDraws(torch.Generator(dev).manual_seed(SEED)))
        torch.cuda.synchronize()
        return g["vae"], m

    reset_launch_counts()
    g_k, m_k = grads(torch.bfloat16)
    launched = launch_counts()
    with mock.patch.object(vae_layers, "causal_conv3d",
                           cc.causal_conv3d_reference):
        g_p, m_p = grads(torch.bfloat16)
    g_32, m_32 = grads(None)
    routed = [f"{n}.conv.weight" for n, m in vae.named_modules()
              if isinstance(m, vae_layers.CausalConv3d)
              and m.admits(torch.bfloat16)]
    bad = [n for n in routed if not bool(torch.isfinite(g_k[n]).all())
           or not bool((g_k[n] != 0).any())]
    names = sorted(g_k)
    flat = {route: torch.cat([g[n].float().flatten() for n in names])
            for route, g in (("kernel", g_k), ("plain", g_p), ("fp32", g_32))}
    r = dict(clip=[1, frames, side, side, 3], routed_convs=len(routed),
             rel_l2=rel_l2(flat["kernel"], flat["plain"]),
             kernel_vs_fp32=rel_l2(flat["kernel"], flat["fp32"]),
             plain_vs_fp32=rel_l2(flat["plain"], flat["fp32"]),
             d_weight={"kernel": m_k["vae/d_weight"],
                       "plain": m_p["vae/d_weight"],
                       "fp32": m_32["vae/d_weight"]},
             total_loss={"kernel": m_k["vae/total_loss"],
                         "plain": m_p["vae/total_loss"],
                         "fp32": m_32["vae/total_loss"]},
             launches=launched, bad_convs=bad)
    log("GAN-VAE generator gradient, kernel vs plain vs fp32 "
        + json.dumps(r))
    if bad or len(routed) != kernel_conv_count(vae, torch.bfloat16):
        raise AssertionError(f"kernel-routed convs without a finite nonzero "
                             f"weight gradient: {bad}")
    if launched != expected(conv=len(routed)):
        raise AssertionError(f"generator gradient launches {launched}, "
                             f"expected {expected(conv=len(routed))}")
    if not (torch.isfinite(flat["kernel"]).all()
            and r["kernel_vs_fp32"] <= 1.1 * r["plain_vs_fp32"]):
        raise AssertionError(f"generator gradient kernel route off: {r}")
    return r, launched


def vae_gan_train(vae, lpips, disc, dev, gen):
    """``VAE_TRAIN_STEPS`` steps of ``make_vae_train_step`` (fp32 masters,
    bf16 autocast) on a smooth clip of the stage-1 recipe's shape, with
    ``disc_start=1``: at step 0 the adaptive weight is 0 and the
    discriminator's weights do not move (its AdamW takes zero gradients),
    at steps 1-2 the weight is positive and every one moves. Every
    metric finite; exactly one conv launch per admitted conv and step, no
    other kernel. Returns (steps, launches, peak GB)."""
    frames, side = VAE_TRAIN_CLIP
    clip = smooth_video(gen, dev, frames, side, side)
    state = create_vae_train_state(vae, disc, VAETrainConfig(disc_start=1))
    step_fn = make_vae_train_step(vae, lpips, disc,
                                  compute_dtype=torch.bfloat16)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    per_step = expected(conv=kernel_conv_count(vae, torch.bfloat16))
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    reset_launch_counts()
    for i in range(VAE_TRAIN_STEPS):
        # the biases before an instance norm get no gradient: the weights
        weights = [p for n, p in disc.named_parameters()
                   if n.endswith("weight")]
        disc0 = [p.detach().clone() for p in weights]
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(state, clip, draws)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counted(before)
        moved = sum(not torch.equal(a, p) for a, p in zip(disc0, weights))
        r = dict(step=i, clip=[1, frames, side, side, 3], seconds=seconds,
                 conv_launches=launched["causal_conv3d"],
                 disc_weights_moved=moved, **m)
        log("GAN-VAE train step " + json.dumps(r))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite GAN-VAE train step {r}")
        if launched != per_step:
            raise AssertionError(f"GAN-VAE step launches {launched}, "
                                 f"expected {per_step}")
        if i == 0 and (m["vae/d_weight"] != 0 or moved):
            raise AssertionError(f"step 0 has the discriminator on: {r}")
        if i > 0 and not (m["vae/d_weight"] > 0 and moved == len(disc0)):
            raise AssertionError(f"step {i} has the discriminator off: {r}")
        steps.append(r)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"GAN-VAE train: {card_line()}, peak memory {peak:.3f} GB, step "
        f"seconds {[round(r['seconds'], 3) for r in steps]}, launches "
        f"{launched}")
    return steps, launched, peak


def gan_vae_paths(dev, paths):
    """GAN-VAE training at the release VAE's width: the VAE with fp32
    parameters (bf16 autocast in the steps), a frozen random LPIPS (VGG16)
    and ``PatchDiscriminator2D()``, each drawn from a generator of its own;
    the generator-gradient check, then the train steps. Adds both paths'
    launches to ``paths``."""
    t0 = time.perf_counter()
    vae = CausalVideoVAE(VAEConfig(), device=dev)
    randomize_(vae, torch.Generator(dev).manual_seed(SEED + 5))
    lpips = LPIPS(device=dev)
    randomize_lpips_(lpips, torch.Generator(dev).manual_seed(SEED + 6))
    disc = PatchDiscriminator2D(device=dev)
    randomize_disc_(disc, torch.Generator(dev).manual_seed(SEED + 7))
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    torch.cuda.synchronize()
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6  # noqa
    log(f"GAN-VAE: VAE {count(vae):.1f} M fp32 params "
        f"({kernel_conv_count(vae, torch.bfloat16)} convs on the conv kernel "
        f"under bf16 autocast), LPIPS {count(lpips):.1f} M (frozen), "
        f"discriminator {count(disc):.1f} M, built in "
        f"{time.perf_counter() - t0:.1f} s")
    _, paths["GAN-VAE generator gradient"] = gan_grad_check(
        vae, lpips, disc, dev, gen)
    _, paths["GAN-VAE train"], _ = vae_gan_train(vae, lpips, disc, dev, gen)
    del vae, lpips, disc
    gc.collect()
    torch.cuda.empty_cache()


def installed_line() -> str:
    """Whether the optional packages the checkpoint path could use import
    here: the port reads safetensors itself, tokenizes with transformers
    only when a checkpoint's tokenizers are loaded, and saves PNGs with
    PIL."""
    found = []
    for name in ("transformers", "safetensors", "PIL"):
        try:
            __import__(name)
            found.append(f"{name} yes")
        except ImportError:
            found.append(f"{name} no")
    return "installed: " + ", ".join(found)


SAFETENSORS_DTYPE = {torch.float32: "F32", torch.float16: "F16",
                     torch.bfloat16: "BF16", torch.int64: "I64",
                     torch.int32: "I32", torch.bool: "BOOL"}


def write_safetensors(tensors: dict, path: str) -> int:
    """``tensors`` as one safetensors file: an 8-byte little-endian header
    length, a JSON header (``dtype``, ``shape``, ``data_offsets``) padded
    with spaces to 8 bytes, then each tensor's bytes in row-major order.
    Returns the file's size."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPE[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1)
                    .view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def write_component(directory: str, state: dict, config: dict,
                    shards: int = 1) -> int:
    """One component directory of the released layout: ``config.json`` and
    ``state`` in ``shards`` safetensors files. Returns the bytes written."""
    os.makedirs(directory)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f)
    keys, size = list(state), 0
    for i in range(shards):
        name = ("diffusion_pytorch_model.safetensors" if shards == 1 else
                f"model-{i + 1:05d}-of-{shards:05d}.safetensors")
        size += write_safetensors({k: state[k] for k in keys[i::shards]},
                                  os.path.join(directory, name))
    return size


def state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def clip_config_json(cfg: CLIPTextConfig) -> dict:
    """The HF ``config.json`` keys ``clip_config_from_dir`` reads."""
    return {"architectures": ["CLIPTextModelWithProjection"
                              if cfg.use_projection else "CLIPTextModel"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "layer_norm_eps": cfg.layer_norm_eps,
            "eos_token_id": cfg.eos_token_id, "hidden_act": cfg.hidden_act,
            "projection_dim": cfg.projection_dim}


def t5_config_json(cfg: T5Config) -> dict:
    """The HF ``config.json`` keys ``t5_config_from_dir`` reads."""
    return {"architectures": ["T5EncoderModel"],
            "feed_forward_proj": "gated-gelu",
            **{k: getattr(cfg, k) for k in (
                "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
                "num_heads", "relative_attention_num_buckets",
                "relative_attention_max_distance", "layer_norm_epsilon")}}


class HashTokenizer:
    """A deterministic stand-in for the checkpoint's tokenizers, whose files
    this script does not write: each whitespace word of the lowercased
    prompt becomes a vocabulary id from its CRC-32 (clear of the special
    ids), then EOS (after BOS for CLIP), padded to ``max_length`` (CLIP
    pads with EOS, T5 with 0). Returns numpy ``input_ids`` and
    ``attention_mask``, as a HF tokenizer called with
    ``return_tensors="np"``."""

    def __init__(self, kind: str):
        if kind == "clip":  # vocab 49408: BOS 49406, EOS 49407
            self.model_max_length, self.first, self.span = 77, 0, 49406
            self.head, self.eos, self.pad = [49406], 49407, 49407
        else:  # T5: pad 0, EOS 1, unk 2; sentencepiece ids below 32100
            self.model_max_length, self.first, self.span = 128, 3, 32097
            self.head, self.eos, self.pad = [], 1, 0

    def __call__(self, prompts, padding="max_length", max_length=None,
                 truncation=True, return_tensors="np"):
        n = max_length or self.model_max_length
        ids = np.full((len(prompts), n), self.pad, np.int64)
        mask = np.zeros((len(prompts), n), np.int64)
        for i, p in enumerate(prompts):
            words = [self.first + zlib.crc32(w.encode()) % self.span
                     for w in p.lower().split()]
            toks = self.head + words[:n - 1 - len(self.head)] + [self.eos]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def hash_tokenizers(path, kind):
    """Stands in for ``encoder._load_tokenizer``."""
    return HashTokenizer(kind)


@torch.no_grad()
def randomize_text_(module: torch.nn.Module, gen: torch.Generator):
    """HF's initialisation of T5 and CLIP, drawn from ``gen``: Linear
    weights N(0, 1/fan_in) (T5's q also over d_kv), T5's shared embedding
    N(0, 1) and relative bias N(0, 1/d_model), CLIP's embeddings
    N(0, 0.02^2); norm weights 1 + N(0, 0.02^2) and biases N(0, 0.02^2), so
    no layer is zero."""
    cfg = module.config
    for name, p in module.named_parameters():
        if name == "shared.weight":
            std = 1.0
        elif "relative_attention_bias" in name:
            std = cfg.d_model ** -0.5
        elif "embedding" in name:
            std = 0.02
        elif p.dim() == 2:
            std = p.shape[1] ** -0.5
            if name.endswith("SelfAttention.q.weight"):
                std *= cfg.d_kv ** -0.5
        else:
            std = 0.02
        p.normal_(0.0, std, generator=gen)
        if p.dim() == 1 and "norm" in name and name.endswith("weight"):
            p.add_(1.0)


def assert_loaded(name: str, module: torch.nn.Module, written: dict):
    """Every tensor of ``module`` equals the one written, bit for bit."""
    got = module.state_dict()
    if sorted(got) != sorted(written):
        raise AssertionError(f"{name}: loaded keys differ from the written")
    for k, w in written.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                g.reshape(-1).view(torch.uint8),
                w.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{name}: {k} differs from the written")


def text_features_check(te: FluxTextEncoder, dev):
    """The bf16 encoders' features against an fp32 copy of the same
    weights on the same tokens: relative L2 of the valid tokens'
    embeddings and of the pooled vectors, each <= ``TEXT_REL_L2``. Returns
    (embeddings error, pooled error, encode seconds of the prompt, of the
    negative prompt)."""
    prompts = [TEXT_PROMPT + PROMPT_SUFFIX, DEFAULT_NEGATIVE_PROMPT]
    seconds = []
    for p in prompts:  # each as the runner encodes it, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        te([p])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    emb, mask, pooled = te(prompts)
    clip32 = CLIPTextEncoder(te.clip.config, device=dev)
    clip32.load_state_dict(te.clip.state_dict())
    t532 = T5Encoder(te.t5.config, device=dev)
    t532.load_state_dict(te.t5.state_dict())
    emb32, mask32, pooled32 = FluxTextEncoder(
        clip32, t532, tokenizers=(te.clip_tokenizer, te.t5_tokenizer)
    )(prompts)
    if not torch.equal(mask, mask32):
        raise AssertionError("bf16 and fp32 masks differ")
    if not (torch.isfinite(emb).all() and torch.isfinite(pooled).all()):
        raise AssertionError("non-finite text features")
    rel = (rel_l2(emb[mask], emb32[mask]), rel_l2(pooled, pooled32))
    log(f"text features (CLIP-L 12x768 + T5-XXL 24x4096, bf16) against "
        f"fp32: embeddings of {int(mask.sum())} valid tokens relative L2 "
        f"{rel[0]:.3e}, pooled {rel[1]:.3e} (limit {TEXT_REL_L2})")
    if not max(rel) <= TEXT_REL_L2:
        raise AssertionError(f"text features relative L2 {rel}")
    return rel + tuple(seconds)


def checkpoint_path(pipe, dev, paths):
    """Phase 8b: the serving miniFLUX and VAE with a full-width CLIP-L and
    T5-XXL (seeded random weights, a generator of their own) written as a
    release-layout checkpoint under ``CKPT_DIR``, loaded through
    ``PyramidFlowRunner.from_pretrained`` with the hash tokenizers, checked
    bit for bit, and one string-prompt request served from it. The
    directory is removed at the end, whatever happens."""
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    # the released FLUX CLIP-L config carries the legacy eos_token_id 2
    clip_cfg, t5_cfg = CLIPTextConfig(eos_token_id=2), T5Config()
    clip = CLIPTextEncoder(clip_cfg, dtype=torch.bfloat16, device=dev)
    randomize_text_(clip, gen)
    t5 = T5Encoder(t5_cfg, dtype=torch.bfloat16, device=dev)
    randomize_text_(t5, gen)
    components = {
        CKPT_VARIANT: (pipe.dit, dataclasses.asdict(pipe.dit.config), 1),
        "causal_video_vae": (pipe.vae, dataclasses.asdict(pipe.vae.config),
                             1),
        "text_encoder": (clip, clip_config_json(clip_cfg), 1),
        "text_encoder_2": (t5, t5_config_json(t5_cfg), CKPT_T5_SHARDS),
    }
    written = {sub: m.state_dict() for sub, (m, _, _) in components.items()}
    need = sum(state_bytes(sd) for sd in written.values())
    log(f"checkpoint: T5-XXL {sum(p.numel() for p in t5.parameters()) / 1e9:.3f}"
        f" B params, CLIP-L {sum(p.numel() for p in clip.parameters()) / 1e6:.1f}"
        f" M params; {need / 1e9:.3f} GB to write")
    os.makedirs(os.path.dirname(CKPT_DIR), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(CKPT_DIR)).free
    log(f"checkpoint: {free / 1e9:.1f} GB free under "
        f"{os.path.abspath(os.path.dirname(CKPT_DIR))}")
    if free < need + 2 ** 30:
        raise RuntimeError(f"{free / 1e9:.1f} GB free, the checkpoint needs "
                           f"{need / 1e9:.1f} GB and 1 GiB of margin")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        nbytes = sum(write_component(os.path.join(CKPT_DIR, sub),
                                     written[sub], config, shards)
                     for sub, (_, config, shards) in components.items())
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(text_encoder, "_load_tokenizer",
                               hash_tokenizers):
            runner = PyramidFlowRunner.from_pretrained(
                CKPT_DIR, CKPT_VARIANT, "pyramid_flux", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = {CKPT_VARIANT: runner.pipeline.dit,
                  "causal_video_vae": runner.pipeline.vae,
                  "text_encoder": runner.text_encoder.clip,
                  "text_encoder_2": runner.text_encoder.t5}
        for sub, module in loaded.items():
            assert_loaded(sub, module, written[sub])
        convs = [m.conv.weight for m in runner.pipeline.vae.modules()
                 if isinstance(m, vae_layers.CausalConv3d)]
        if not all(w.is_contiguous(memory_format=torch.channels_last_3d)
                   for w in convs):
            raise AssertionError("loaded VAE conv weights not channels-last")
        log(f"checkpoint: wrote {nbytes / 1e9:.3f} GB in {write_s:.1f} s, "
            f"from_pretrained loaded it in {load_s:.1f} s; every tensor "
            f"equal to the written one bit for bit, {len(convs)} VAE conv "
            f"weights channels-last")
        del written, components, clip, t5
        gc.collect()
        torch.cuda.empty_cache()
        rel_emb, rel_pooled, enc_s, neg_s = text_features_check(
            runner.text_encoder, dev)
        gc.collect()
        torch.cuda.empty_cache()

        seen = []
        decode = runner.pipeline.decode_latent

        def spy(latents, plan):
            seen.append(latents)
            return decode(latents, plan)

        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(runner.pipeline, "decode_latent", spy):
            t0 = time.perf_counter()
            frames = runner.generate(
                TEXT_PROMPT, seed=SEED, height=HEIGHT, width=WIDTH, temp=1,
                num_inference_steps=STEPS,
                video_num_inference_steps=VIDEO_STEPS, guidance_scale=7.0,
                video_guidance_scale=5.0, output_type="pixels")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        paths["flux from checkpoint, string prompt"] = launched = \
            launch_counts()
        windows = len(vae_model._window_starts(1, DECODE_WINDOW, 1))
        want = expected(runner.pipeline.dit.num_attention_calls * sum(STEPS),
                        conv=kernel_conv_count(runner.pipeline.vae.decoder)
                        * windows)
        check_request(frames, seen, launched, want, 1)
        r = dict(request="checkpoint", prompt=TEXT_PROMPT, temp=1,
                 bytes=nbytes, write_s=write_s, load_s=load_s,
                 text_encode_s=enc_s, negative_encode_s=neg_s,
                 text_rel_l2=rel_emb, pooled_rel_l2=rel_pooled,
                 launches=launched, wall_s=wall,
                 dit_s=runner.pipeline.last_dit_seconds,
                 decode_s=runner.pipeline.last_decode_seconds,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                 frame_std=frames.float().std().item(),
                 phase_s=time.perf_counter() - t_phase)
        log("request " + json.dumps(r))
        del runner
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return r


def mmdit_text_request(pipe, dev, paths):
    """One T2V request (temp 1) through ``PyramidFlowRunner`` with the SD3
    text encoders at full width: CLIP-L projected (12 x 768), CLIP-G
    (32 x 1280, projected to 1280) and T5-XXL, seeded random weights from
    a generator of their own, the hash tokenizers. Pooled must be 2048
    wide."""
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    kw = dict(dtype=torch.bfloat16, device=dev)
    encoders = [CLIPTextEncoder(CLIPTextConfig(use_projection=True), **kw),
                CLIPTextEncoder(CLIPTextConfig.clip_g(), **kw),
                T5Encoder(T5Config(), **kw)]
    for m in encoders:
        randomize_text_(m, gen)
    te = SD3TextEncoder(*encoders, tokenizers=(
        HashTokenizer("clip"), HashTokenizer("clip"), HashTokenizer("t5")))
    emb, mask, pooled = te(TEXT_PROMPT + PROMPT_SUFFIX)
    if tuple(emb.shape) != (1, TEXT_LEN, 4096) or \
            tuple(pooled.shape) != (1, 2048):
        raise AssertionError(f"SD3 text features {tuple(emb.shape)}, "
                             f"pooled {tuple(pooled.shape)}")
    if not (torch.isfinite(emb).all() and torch.isfinite(pooled).all()):
        raise AssertionError("non-finite SD3 text features")
    runner = PyramidFlowRunner(pipe, te)
    seen = []
    decode = pipe.decode_latent

    def spy(latents, plan):
        seen.append(latents)
        return decode(latents, plan)

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy):
        t1 = time.perf_counter()
        frames = runner.generate(
            TEXT_PROMPT, seed=SEED, height=HEIGHT, width=WIDTH, temp=1,
            num_inference_steps=STEPS, video_num_inference_steps=VIDEO_STEPS,
            guidance_scale=7.0, video_guidance_scale=5.0,
            output_type="pixels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    paths["MMDiT from text, string prompt"] = launched = launch_counts()
    windows = len(vae_model._window_starts(1, DECODE_WINDOW, 1))
    want = expected(pipe.dit.num_attention_calls * sum(STEPS),
                    conv=kernel_conv_count(pipe.vae.decoder) * windows)
    check_request(frames, seen, launched, want, 1)
    r = dict(request="mmdit text", prompt=TEXT_PROMPT, temp=1,
             pooled_width=pooled.shape[-1], launches=launched, wall_s=wall,
             dit_s=pipe.last_dit_seconds, decode_s=pipe.last_decode_seconds,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             frame_std=frames.float().std().item(),
             phase_s=time.perf_counter() - t0)
    log("request " + json.dumps(r))
    del runner, te, encoders
    gc.collect()
    torch.cuda.empty_cache()
    return r


def build_libraries():
    """The four kernel libraries, one nvcc each, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = {"flash_fwd": pool.submit(fa.kernel_library),
                "flash_bwd": pool.submit(fa.bwd_kernel_library),
                "causal_conv3d": pool.submit(cc.kernel_library),
                "flash_fwd_hn": pool.submit(fa.hn_kernel_library)}
        libs = {name: f.result() for name, f in libs.items()}
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        if not lib.build_seconds:
            log(f"build {name}: an earlier build of the same sources, "
                f"loaded (no compiler output)")
            continue
        lines = lib.build_log.splitlines()
        log(f"build {name}: nvcc {lib.build_seconds:.2f} s, "
            f"{sum('Compiling entry' in x for x in lines)} kernels, "
            f"{sum('C7518' in x for x in lines)} C7518 warnings (wgmma "
            f"serialised)")
        for line in lines:
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "Performance Loss" in line:
                log("  " + line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device count {torch.cuda.device_count()}")
    log(installed_line())
    build_libraries()

    # the kernel checks draw from their own generator, so that a check added
    # or removed there leaves the models' random weights as they were
    kgen = torch.Generator(dev).manual_seed(SEED)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    meta_pipe = PyramidFlowPipeline(None, device=dev)
    checks, hn_checks = kernel_vs_plain(meta_pipe, dev, kgen)
    fwd_edge_checks(meta_pipe, dev, kgen)
    fwd_host_cost(meta_pipe, dev, kgen)
    hn_checks += hn_tool_layout(dev)
    hn_empty_rows(dev, kgen)
    bwd_checks = bwd_vs_plain(meta_pipe, dev, kgen)
    paths = {"exp_flash_h2 tool": tool_path()}

    t0 = time.perf_counter()
    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16,
                                 device=dev)
    randomize_(dit, gen)
    vae = CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device=dev)
    randomize_(vae, gen)
    torch.cuda.synchronize()
    log(f"models: DiT {sum(p.numel() for p in dit.parameters()) / 1e9:.3f} B "
        f"params, VAE {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M "
        f"params ({kernel_conv_count(vae.encoder)} encoder and "
        f"{kernel_conv_count(vae.decoder)} decoder convs on the conv "
        f"kernel), built in {time.perf_counter() - t0:.1f} s")
    dit_check(dit, meta_pipe, dev, gen)
    conv_shapes = set()
    with record_conv_shapes(conv_shapes):
        encode_check(vae, dev, gen)
        # its own generator: the draws of the paths after it stay as they were
        _, paths["VAE decode gradient"] = vae_grad_check(
            vae, dev, torch.Generator(dev).manual_seed(SEED + 2))

        # each path counted from 0
        pipe = PyramidFlowPipeline(dit, vae, dtype=torch.bfloat16,
                                   device=dev)
        reset_launch_counts()
        requests = [serve(pipe, dev, gen, name, temp)
                    for name, temp in REQUESTS]
        paths["text-to-video"] = launch_counts()
        log("text-to-video decode seconds through the conv kernel: "
            + ", ".join(f"({r['request']}) {r['decode_s']:.3f} of "
                        f"{r['wall_s']:.3f} s wall" for r in requests)
            + "; PR 2 call 4 on cuDNN (NVIDIA H100 80GB HBM3, 700 W): (a) "
              "6.142 s and (b) 15.107 s wall, decode about 0.5 s")
        reset_launch_counts()
        serve_i2v(pipe, dev, gen)
        paths["image-to-video"] = launch_counts()
        # a string prompt through from_pretrained, from a checkpoint of the
        # serving models and full-width text encoders
        checkpoint_path(pipe, dev, paths)

        # training: free the serving DiT first; the VAE stays for raw pixels
        del pipe, dit
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tdit = PyramidFluxTransformer(FluxConfig(), dtype=torch.float32,
                                      device=dev, remat=True)
        randomize_(tdit, gen)
        torch.cuda.synchronize()
        log(f"training DiT: fp32 parameters, remat, built in "
            f"{time.perf_counter() - t0:.1f} s")
        dit_grad_check(tdit, dev, gen)
        _, paths["train (latents)"], _, state = train(tdit, dev, gen)
        _, paths["train (raw pixels)"], _ = train_raw_pixels(
            tdit, vae, state, dev, gen)

        # the MMDiT at full width and depth, after the flux training state
        # is freed: a forward check, one request, the gradient, two steps
        del tdit, state
        gc.collect()
        torch.cuda.empty_cache()
        mmdit_paths(vae, meta_pipe, dev, gen, paths)
        # GAN-VAE training: an fp32-master VAE of its own under bf16 autocast
        gan_vae_paths(dev, paths)
    log("launches by path " + json.dumps(paths))
    total = {k: sum(p[k] for p in paths.values()) for k in launch_counts()}
    unused = [k for k, n in total.items()
              if n == 0 and k != "flash_fwd_classic"]
    if unused:
        raise AssertionError(f"kernels no path launched: {unused}")

    # the conv kernel at every shape the paths gave it, with the models freed
    del vae
    gc.collect()
    torch.cuda.empty_cache()
    log(f"conv shapes the paths launched: {len(conv_shapes)}")
    conv_checks = conv_vs_plain(conv_shapes, dev, kgen)
    conv_checks += conv_edge_checks(dev, kgen)

    timed = next(r for r in checks if r["layout"] == TIMED_LAYOUT
                 and r["causal"] and r["bounded"])
    classic = next(r for r in checks if r["layout"] == TIMED_LAYOUT
                   and r["causal"] and not r["bounded"])
    btimed = next(r for r in bwd_checks if r["layout"] == TIMED_LAYOUT
                  and r["d"] == D and r["causal"])
    ctimed = next(r for r in conv_checks if "plain_ms" in r)
    hn_timed = next(r for r in hn_checks if "ms" in r and r["causal"])
    # operations of each timed call, for the rate
    conv_flops = conv_bound(*TIMED_CONV)[0]
    flops = {"flash_fwd": timed["flops"], "flash_fwd_classic": classic["flops"],
             "flash_bwd_dkv": btimed["flops_dkv"],
             "flash_bwd_dq": btimed["flops_dq"], "causal_conv3d": conv_flops,
             "flash_fwd_hn": timed["flops"]}
    def own_ms(e):
        # K3 and K4 share one ``ms``, the whole backward as the path calls
        # it; their rate and share of the bound are of their own time
        return e["kernel_ms"] if e["name"].startswith("flash_bwd") else e["ms"]

    log(json.dumps({"kernels": [dict(
        e, tflops=flops[e["name"]] / own_ms(e) / 1e9,
        bound_share=e["bound_ms"] / own_ms(e)) for e in [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:207",
        "launches": total["flash_fwd"],
        "max_abs_err": max(r["max_abs_err_o"] for r in checks
                           if r["bounded"]),
        "ms": timed["ms"],
        "kernel_ms": timed["kernel_ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
    }, {
        "name": "flash_fwd_classic",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:122",
        "launches": total["flash_fwd_classic"],
        "max_abs_err": max(r["max_abs_err_o"] for r in checks
                           if not r["bounded"]),
        "ms": classic["ms"],
        "kernel_ms": classic["kernel_ms"],
        "plain_ms": classic["plain_ms"],
        "bound_ms": classic["bound_ms"],
        "bound_by": classic["bound_by"],
        "library_ms": classic["library_ms"],
    }, {
        "name": "flash_bwd_dkv",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:447",
        "launches": total["flash_bwd_dkv"],
        "max_abs_err": max(max(r["max_abs_err_dk"], r["max_abs_err_dv"])
                           for r in bwd_checks),
        "ms": btimed["ms"],
        "kernel_ms": btimed["kernel_ms_dkv"],
        "delta_kernel_ms": btimed["kernel_ms_delta"],
        "plain_ms": btimed["plain_ms"],
        "bound_ms": btimed["bound_ms_dkv"],
        "bound_by": btimed["bound_by_dkv"],
        "library_ms": btimed["library_ms"],
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:514",
        "launches": total["flash_bwd_dq"],
        "max_abs_err": max(r["max_abs_err_dq"] for r in bwd_checks),
        "ms": btimed["ms"],
        "kernel_ms": btimed["kernel_ms_dq"],
        "delta_kernel_ms": btimed["kernel_ms_delta"],
        "plain_ms": btimed["plain_ms"],
        "bound_ms": btimed["bound_ms_dq"],
        "bound_by": btimed["bound_by_dq"],
        "library_ms": btimed["library_ms"],
    }, {
        "name": "causal_conv3d",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/causal_conv3d.cu",
        "replaces": "pyramid_flow_tpu/ops/causal_conv3d.py:42",
        "launches": total["causal_conv3d"],
        "max_abs_err": max(r["max_abs_err"] for r in conv_checks),
        "ms": ctimed["ms"],
        "plain_ms": ctimed["plain_ms"],
        "bound_ms": ctimed["bound_ms"],
        "bound_by": ctimed["bound_by"],
        "library_ms": ctimed["library_ms"],
    }, {
        "name": "flash_fwd_hn",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd_hn.cu",
        "replaces": "tools/exp_flash_h2.py:46",
        "launches": total["flash_fwd_hn"],
        "max_abs_err": max(r["max_abs_err_o"] for r in hn_checks),
        "ms": hn_timed["ms"],
        "kernel_ms": hn_timed["kernel_ms"],
        "plain_ms": hn_timed["plain_ms"],
        "bound_ms": hn_timed["bound_ms"],
        "bound_by": hn_timed["bound_by"],
        "library_ms": hn_timed["library_ms"],
    }]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
