#!/usr/bin/env python3
"""Run the PyTorch port's text-to-video, image-to-video and DiT-training paths
(the AR and the full-sequence recipe) for both DiT families, the
string-prompt path from a release-layout checkpoint, the HTTP serving app,
the latent-extraction tool, the EMA evaluation path, GAN-VAE training, the
heads-per-block attention experiment, the sequence-, fully-sharded- and
context-parallel paths (two ranks
sharing the card), with accumulation and sharded checkpoints, the 768p
request on the memory-planned decode with the 768p tools, the DiTs'
classic-softmax route in serving and training, and a request at two latent
frames per unit, once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: its name and power limit as nvidia-smi reports them, the
   torch and CUDA versions, and whether ``transformers``, ``safetensors``
   and ``PIL`` import;
2. build: the five kernel libraries from ``pyramid_flow_tpu_torch/csrc``
   (the flash-attention forward, the heads-per-block forward, the backward,
   the causal conv and the fused q/k/v pass), one nvcc each, started
   together; ptxas's register,
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
   way (its forward plus backward less its forward); then K7, the fused
   q/k/v pass (``ops/qk_norm_rope.py``), at each family's attention sites
   (miniFLUX's dual site, 128 text + 3072 latent tokens, and its single
   one, 24 x 64 heads; SD3's; Wan's self-attention, 40 x 128 heads
   normalised over 5120, and its cross-attention over 512 text tokens):
   q and k within ``QK_ULPS`` ulps of each rotated pair of the plain
   version (fp32, one rounding) and one more of the modules' composition,
   v bit-equal, one launch a site; timed beside the plain version and the
   composition it replaced, with its bytes bound; then K8, the fused
   residual update and LayerNorm (``ops/residual_norm.py``), at miniFLUX's
   dual-block site (a bf16 stream of 2 x 3072 rows x 1536) and Wan's (an
   fp32 stream of 2 x 2944 rows x 5120), each call the blocks make there
   (``NORM_SITES``): the stream bit-equal to the plain version, h within
   ``NORM_ULPS`` bf16 ulps (of the magnitude of its terms) of it and
   ``NORM_COMPOSED_ULPS`` of the blocks' composition, one launch a call;
   each site's first call (the attention's gated residual fused with the
   MLP's modulated norm; Wan's with ``norm3``'s affine norm) timed the
   same way, with its bytes bound;
5. the experiment: ``pyramid_flow_tpu_torch.tools.exp_flash_h2.main`` in
   this process with ``--full`` (its checks, K1 and K6 at each hs timed at
   the 768p stage-2 layout, L=11008, then K1 and K6 at hs=2 again with
   every time id equal, every tile FULL: the masked and FULL times are
   logged side by side), its launches held to exactly its count;
6. full-width DiT: the release-architecture miniFLUX (19 dual + 38 single
   blocks, 24 x 64 heads) in bf16 with random weights, one forward at the
   384x640 unit 15 stage 2 layout on each softmax route (the bounded
   forward K1, and the classic one K2 with ``bounded_softmax=False``; 57
   launches of its kernel and none of the other) and through the plain
   version; each kernel route within relative L2 2e-2 of the plain version
   on the valid tokens; then the same DiT and inputs in fp32 on the plain
   route (a copy built after the bf16 forwards and freed at once): each
   route's relative L2 to fp32, each kernel route's within 1.1x of the
   plain route's;
6b. out of the bounded forward's envelope: a full-width miniFLUX cut to
   2 + 4 blocks (seeded, SEED + 12) whose qk-norm gains are scaled by 4 and
   then by 1.25 until ``bounded_softmax_overshoot`` over its attentions
   reads above 150 log2 units; at phase 6's layout the classic route must
   stay within 1.1x of the plain version's distance to fp32 and the
   bounded route must not (beyond it or non-finite): the scenario the
   training CLI's warning describes (the bf16 plain version is itself
   about 1e-1 from fp32 there, so fp32 is the anchor);
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
8. serve: text-to-video through ``PyramidFlowPipeline.generate`` (384x640,
   steps [20,20,20]/[10,10,10], guidance 7/5, uint8 frames out): (a) temp
   1, then the same request on the classic route (K2); then the pyramid at
   two latent frames per unit, a second pipeline
   (``frame_per_unit=2``) over the same models: the DiT's forward at its
   widest layout (unit 2 stage 2, L = 4608, two time ids in the current
   clip) on both routes held as phase 6 holds them, and one request at
   temp 5 (unit 0, then two units of two frames: 5 latent frames, 33
   pixel frames; K1 57 x (60 + 2 x 30) = 6840, K5 34 x 3 windows); one
   image-to-video request through ``PyramidFlowRunner.generate_i2v`` (a
   seeded smooth 384x640 image, a seeded stand-in text encoder, temp 4,
   the same steps and guidance); after phase 8b, (b) the JAX bench's
   request (``bench.py``: temp 16, 121 frames, ``save_memory=True`` and
   ``release_dit_before_decode=True``, the pipeline then the DiT's only
   holder). The latents must be finite, the frames not constant, the flash
   forward of the route launched exactly 57 times per DiT forward and the
   other not at all, and the conv kernel exactly once per admitted conv and
   VAE window; each request's wall, DiT and decode seconds and peak memory
   (of the request, its DiT phase and its decode) are printed;
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
   request's wall seconds and the peak memory. Then, on the same
   checkpoint (that runner freed first): the port's serving app
   (``tools/serve.py``) in a thread on 127.0.0.1 and a free port,
   ``GET /healthz``, one T2V ``POST /generate`` (temp 1, the app's default
   steps) while ``/progress`` is polled, whose frames must equal
   ``pipeline.generate`` on the same prompt features and seed bit for bit
   and whose progress must reach ``unit == units``, and one I2V request
   with a seeded base64 PNG (temp 2), each with its exact K1 and K5
   launches and its wall time; and the latent-extraction tool on two
   seeded clips of 121 frames at 384x640 (written with cv2; without cv2
   its per-clip function runs on the pixels, and the log says the decode
   was bypassed), with ``--world 2`` for both ranks and once with
   ``--tile 256``: the rows and file names the JAX tool writes, each latent
   equal to ``chunk_encode`` (``tiled_encode``) + ``gaussian_sample`` on the
   tool's generator, and one K5 launch per admitted encoder conv, window
   and tile;
9. full-width DiT gradient: the release DiT with fp32 parameters, bf16
   autocast and remat, one training-loss backward of a batch row at the
   384x640 unit-16 stage-2 training layout (L = 3068), through the plain
   version and through the kernels on each softmax route; relative L2 of
   each route's concatenated parameter gradient to the plain one <= 5e-2,
   every parameter with a nonzero gradient, and exactly 2 launches of the
   route's forward (forward and recompute) and one of each backward kernel
   per attention;
10. train: the serving DiT freed, ``create_train_state`` on that DiT (its
   output projection zeroed, as the JAX model initialises it) and three
   ``make_train_step`` steps at the JAX CLI's default shape (batch 4, 16
   latent frames of 48x80, units from ``sample_stage_length``, the CLI's lr
   schedule), then two raw-pixel steps (``vae=``, batch 4 of 121 frames of
   384x640, the same 16 latent frames); finite losses and grad norms,
   updates applied, exact kernel launch counts; step seconds and the peak
   memory printed. Between the latent and the raw-pixel steps, the EMA
   evaluation: ``export_ema_params``/``load_ema_params`` round-trip the
   state's EMA bit for bit (bytes and seconds printed),
   ``from_train_state(use_ema=True)`` builds a bf16 DiT holding exactly the
   EMA, cast, which serves one temp-1 request with its exact launches, and
   the training model's parameters and EMA are unchanged afterwards;
10b. the full-sequence recipe (``--no_temporal_pyramid``,
   ``scripts/train_pyramid_flow_without_ar.sh``) on phase 10's DiT and
   train state, its draws from a generator of its own (SEED + 15): at its
   stage-2 layout (one clip of 16 frames of 48x80 latents after the
   prompt, L = 15488, B=1, H=24, D=64, causal) K1 and K2 forward and
   K3/K4 backward after each one's ``lse`` against the plain version
   computed one head at a time (phase 3's and phase 4's tolerances), each
   wrapper timed as the training path calls it beside SDPA with the same
   mask, with the tile split; the whole DiT's gradient at its stage-1
   layout (L = 3968, where the plain route fits beside the state) on both
   routes against the plain route as phase 9 holds it; then three
   full-depth steps of a full-sequence step function on that state at
   phase 10's shape (each stage forward one clip of all 16 frames: 960,
   3840 and 15360 latent tokens; finite, one at least applied and moving
   the parameters, exactly 342 K1 and 171 K3/K4 launches per step; seconds
   and peak memory printed);
11. the MMDiT, after the flux training state is freed: the release SD3
   MMDiT (24 joint blocks, 24 x 64 heads, 1536 wide) in bf16, its forward
   kernel vs plain (relative L2 <= 2e-2, with the table's crop origin),
   anchored to fp32 as phase 6; one
   T2V request through ``PyramidFlowPipeline(model_name="pyramid_mmdit")``
   with the release VAE (384x640, temp 4, 128 text tokens of width 4096,
   100 valid, pooled 2048; 24 flash launches per DiT forward), and one
   string-prompt request (temp 1) through ``PyramidFlowRunner`` with the
   SD3 text encoders at full width (CLIP-L projected, CLIP-G 32 x 1280
   projected to 1280, T5-XXL; seeded random weights from a generator of
   their own, the word-hash tokenizers; pooled 2048 wide), and one I2V
   request (temp 2) from the flux I2V request's image, checked as that
   one is; then with
   fp32 parameters and remat the gradient check of phase 9 (every
   parameter nonzero but the last block's text-query projection, which it
   discards), two latent train steps at the shape of phase 10 and one
   full-sequence step on that state (144 K1, 72 K3/K4 launches; its batch
   from SEED + 16);
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
   tile does not divide, and 512 -> 256 channels (phase 12 runs after phase
   13, so it checks the CP step's shapes too);
13. the multi-rank paths, with the models freed, each rank a child process
   of this script (``--child NAME``; never given by hand) on the one card:
   whether the card's gloo carries all_to_all, all_gather, the halo
   exchange and FSDP2's gathers on CUDA tensors (NCCL refuses two ranks on
   one device; where gloo does not, the paths run on one NCCL rank); then
   on two ranks: ``sp_flash_attention`` at sp=2 against one rank's
   ``flash_attention`` (output, lse, the three gradients: bit for bit); an
   SP request of the release miniFLUX and VAE (384x640, temp 1, steps
   [2, 2, 2]) with one DiT forward held to the sp=1 forward (relative L2
   2e-2) and, on rank 0, both anchored to fp32 (the SP forward within 1.1x
   of the sp=1 forward's distance; the bf16 plain route's printed), and
   the frames to the sp=1 request's (printed); train steps of a
   2 + 4-block full-width DiT (fp32, bf16 autocast, remat, the CLI's
   default shape) on an fsdp=2 and an sp=2 mesh, loss and gradient norm
   held to the parent's one-device steps (1e-2 and 2e-2 relative); a cp=2
   GAN-VAE step of the release VAE on 32 frames of 128x128, K5 launched
   with front frames on every rank (zeros on the first), its gradient held
   to the parent's cp=1 step's (in fp32 within 1e-2; in bf16 within 1.1x
   of the cp=1 bf16 route's distance to fp32, as phase 11b); one
   ``accum_steps=2`` step of a 2 + 4-block full-width DiT on the fsdp=2
   mesh over a global batch of 8 (each rank holds one micro-batch whole
   and none of the other), held to the parent's one-device accumulated
   step as the sharded steps are, then its state saved with
   ``torch.distributed.checkpoint`` and resumed on an sp=2 mesh, equal to
   the saved state gathered, exactly (bytes and seconds printed); then one
   full-depth step of the training CLI on one NCCL rank with
   ``--classic_softmax`` (K2 342 launches, K1 none, K3/K4 171). Every rank's
   launches join the kernels line, beside the card's name and power limit;
14. 768p, with the earlier models freed: the release miniFLUX and VAE
   (``profile_768p.build_models``, seeded) serve one T2V request at
   768x1280 (temp 2, the steps and guidance of phase 8, the DiT released
   before the decode) on ``decode_settings(True, 16.0,
   dit_resident=False)``, the 16 GB class's plan (full-height window-2
   strips, 4 of 46 latent pixels): exactly 57 x 90 K1 and 34 x 2 x 4 K5
   launches, the decode's peak memory against 16 GB (printed), then the
   request's latents decoded in those strips through the conv kernel, the
   plain version and fp32 (the kernel route within 1.1x of the plain
   route's distance to fp32) and untiled (the strips' distance to it,
   printed); ``profile_768p`` at its defaults without the sweep (each
   stage's forward, K1 and K2 alone and their shares, the 17-frame decode
   through
   ``decode_latent(save_memory=True)``; exact launches) and K1 against the
   plain version at its stage-2 layout (phase 3's tolerances on phase 3's
   inputs, ``exp_flash_h2``'s on the tool's q = k = v);
   ``exp_vae_tiling`` with ``--iters 1`` (its ten plans, exact launches,
   none out of memory); ``exp_decode_scan`` (the CUDA-graph windows
   captured and equal to ``chunk_decode``'s bit for bit; exact launches,
   each replay counting the conv launches it runs and the capture none);
   ``exp_conv_stack`` (exact launches); every K5 shape
   these paths launched (and the conv-stack shapes), with zero and with
   carried front frames, against the plain version (phase 12's limit, not
   timed); the guidance-embedded miniFLUX's forward as phase 6 checks the
   DiT (``guidance`` 4.5); a release-width VAE of 2D twin blocks, one
   encode and decode of a 9-frame 256x256 clip (finite, no kernel launch).

Each path (the experiment, the VAE decode gradient, text-to-video on each
softmax route, image-to-video, the string prompt from the checkpoint, the
bench's request, the HTTP T2V and
I2V requests, the two extraction runs, latent training, the EMA request,
raw-pixel training, full-sequence training, MMDiT text-to-video, the MMDiT
string prompt, MMDiT image-to-video, MMDiT latent training on each recipe,
the GAN-VAE generator gradient, GAN-VAE training, and
phase 13's SP attention, SP serving, sharded training per mesh, the CP
GAN-VAE step, the accumulated sharded step and the training CLI on the
classic route, on every rank; phase 14's 768p request and its four tools)
runs
with every launch counter set to 0 just before it and read just after. Before the
last line the script prints one JSON object with each kernel's launches
summed over those paths, its largest error against the plain version, its
time, the plain version's, the least time the card could take (bytes or
operations at the H100's published peaks) and one PyTorch call's time for
the same function, its rate (``tflops``) and ``bound_share`` (the least
time over its time), at the 384x640 unit 15 stage 2 attention layout and
at the 128->128 384x640 decode conv; K7 at miniFLUX's dual site, with its
largest distance in ulps (``max_pair_ulps``), the composed chain's time
(``composed_ms``) and no rate (its bound is bytes); K8 the same at
miniFLUX's dual-block site (``max_term_ulps``). Each time is that of the wrapper call
the paths make; the forwards also give ``kernel_ms``, the kernel's own
device time. K3 and K4 share one ``ms``, the whole backward as the path
calls it, with their own ``kernel_ms`` and the delta kernel's
(``delta_kernel_ms``) beside it; their rate and share are of their own
time. Each entry gives its launches by path (``launches_by_path``), and
every kernel must have been launched by some path. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from pyramid_flow_tpu_torch.models.flux.blocks import RMSNorm
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
from pyramid_flow_tpu_torch.ops import qk_norm_rope as qkr
from pyramid_flow_tpu_torch.ops.composition import composition
from pyramid_flow_tpu_torch.ops import residual_norm as rn
from pyramid_flow_tpu_torch.ops.rope import rope_freqs
from pyramid_flow_tpu_torch.pipeline.noising import (
    GeneratorDraws, add_ar_noise_stage, add_pyramid_noise_stage,
    latent_pyramid, sample_stage_length)
from pyramid_flow_tpu_torch.pipeline.packing import pack_clips, patchify
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline, decode_settings, device_memory_gb)
from pyramid_flow_tpu_torch.pipeline.runner import (
    DEFAULT_NEGATIVE_PROMPT, PROMPT_SUFFIX, PyramidFlowRunner)
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.lr_schedules import cosine_schedule
from pyramid_flow_tpu_torch.training.train_state import (
    TrainConfig, create_train_state)
from pyramid_flow_tpu_torch.tools import exp_flash_h2
from pyramid_flow_tpu_torch.tools import (
    exp_conv_stack, exp_decode_scan, exp_vae_tiling, profile_768p)
from pyramid_flow_tpu_torch.tools import extract_video_vae_latents
from pyramid_flow_tpu_torch.tools import serve as serve_app
from pyramid_flow_tpu_torch.utils.checkpoint import (
    export_ema_params, load_ema_params)
from pyramid_flow_tpu_torch.utils.video_io import (
    frames_from_bytes, video_bytes)
from pyramid_flow_tpu_torch.training.trainer import (
    VIDEO_ENCODE_WINDOW, make_train_step)
from pyramid_flow_tpu_torch.training.vae_trainer import (
    VAETrainConfig, create_vae_train_state, make_vae_train_step)
from pyramid_flow_tpu_torch.parallel import comm as par_comm
from pyramid_flow_tpu_torch.parallel import sp as par_sp
from pyramid_flow_tpu_torch.parallel.cp import (
    make_cp_mesh, previous_frames, time_shard)
from pyramid_flow_tpu_torch.parallel.mesh import (
    MeshConfig, data_rank, make_mesh, param_sharding)
from pyramid_flow_tpu_torch.parallel.sp import a2a_bytes, sp_flash_attention

SEED = 0
B, H, D = 2, 24, 64
TEXT_LEN, TEXT_VALID = 128, 100   # the prompt's last 28 tokens are masked
O_ATOL, LSE_ATOL, DIT_REL_L2 = 1e-2, 2e-3, 2e-2
QK_ULPS = 1  # K7 against its plain version, in ulps of each rotated pair
# K8 against its plain version and the composition, in bf16 ulps of h's terms
NORM_ULPS, NORM_COMPOSED_ULPS = 1, 4
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
# T2V (a), and (b) the JAX bench's request (bench.py: temp 16, 384x640, the
# steps and guidance below, save_memory, the DiT released before the decode)
T2V_TEMP, BENCH_TEMP = 1, 16
I2V_TEMP = 4
# the pyramid at two latent frames per unit: a second pipeline over the
# serving models; its request (unit 0, then two units of two frames: 5
# latent frames, 33 pixel frames), and the (unit, stage) of its widest
# layout, the last unit's stage 2 (L = 4608), where the DiT is checked
FPU, FPU_TEMP, FPU_CHECK = 2, 5, (2, 2)
STEPS, VIDEO_STEPS = [20, 20, 20], [10, 10, 10]
DECODE_WINDOW, ENCODE_WINDOW = 2, 16  # latent frames; pixel frames
# (B, T, H, W, C, Co, front): the decoder's 128->128 conv in its steady
# window (2 latent frames, after its temporal upsamplers)
TIMED_CONV = (1, 16, HEIGHT, WIDTH, 128, 128, True)
CONV_REL, ENCODE_REL_L2, IN_PLACE_REL_L2 = 2e-2, 2e-2, 2e-3
VAE_GRAD_LATENT = (12, 20)  # latent h, w of the decode gradient: 96x160
RAW_STEPS = 2
MMDIT_TEMP, MMDIT_TRAIN_STEPS = 4, 2
# the MMDiT's I2V request, from the flux I2V request's image
MMDIT_I2V_TEMP = 2
# the full-sequence recipe (scripts/train_pyramid_flow_without_ar.sh:
# --no_temporal_pyramid, at phase 10's shape): each stage row is one clip
# of all 16 frames, so the stage-2 row is L = 128 + 16 x 960 = 15488
# tokens, where the kernels are checked (B=1: the recipe's one stage-2
# row); the gradient check at stage 1 (L = 128 + 16 x 240 = 3968), where
# the plain route fits beside the train state; the steps of each DiT, and
# the timed calls per kernel at L = 15488
FULL_GRAD_STAGE, FULL_STEPS, FULL_MMDIT_STEPS, FULL_REPS = 1, 3, 1, 5
# out of the bounded forward's envelope: a full-width miniFLUX cut to 2 + 4
# blocks whose qk-norm gains grow (from GAIN0, by GAIN_STEP) until the
# bounded forward's overshoot passes ENVELOPE_LOG2 log2 units (its shift
# underflows near 120)
ENVELOPE_DEPTH, ENVELOPE_LOG2, GAIN0, GAIN_STEP = (2, 4), 150.0, 4.0, 1.25
HN_TIMED_HS = 2  # the heads per block timed beside K1 (the JAX default)
TOOL_ITERS = 8   # the tool's timed launches per kernel
RAW_FRAMES = 1 + 8 * (TRAIN_FRAMES - 1)  # 121 pixel frames, 16 latent
# the release-layout checkpoint the string-prompt phase writes and deletes
CKPT_DIR = os.path.join("build", "smoke_checkpoint")
CKPT_VARIANT = "diffusion_transformer_384p"
CKPT_T5_SHARDS = 2
TEXT_PROMPT = "a cat walks on grass"
TEXT_REL_L2 = 2e-2  # bf16 text features against an fp32 copy
# the HTTP requests after phase 8b: T2V at the app's default steps, then
# I2V from a seeded image
HTTP_T2V_TEMP, HTTP_I2V_TEMP = 1, 2
# latent extraction: two seeded clips at the tool's default size, the
# tiled run's tile (pixels)
EXTRACT_CLIPS, EXTRACT_FRAMES, EXTRACT_TILE = 2, 121, 256
EXTRACT_DIR = os.path.join("build", "smoke_extract")
# the EMA export's directory (written and removed by the EMA phase)
EMA_DIR = os.path.join("build", "smoke_ema")
# GAN-VAE training: the reference's stage-1 recipe clip
# (scripts/train_causal_video_vae.sh: batch 1, 17 frames at 256p), and the
# generator-gradient check's smaller clip (frames, side)
VAE_TRAIN_CLIP, VAE_TRAIN_STEPS = (17, 256), 3
VAE_GRAD_CLIP = (9, 128)
# NVIDIA H100 SXM published dense peaks
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# the multi-rank phases (13): ranks sharing the one card, their files, the
# serving request's steps per stage (cut from 20), the sharded train
# steps' depth (cut from 19 + 38 blocks) and count, the CP GAN-VAE clip
# (cut from the recipe's 256x256: two ranks share the card); the fsdp=2
# mesh takes one of the steps, the sp=2 mesh both
PAR_DIR = os.path.join("build", "smoke_parallel")
PAR_WORLD = 2
SP_SERVE_STEPS, SP_SERVE_TEMP = [2, 2, 2], 1
# (2 + 4 blocks since the 768p phase was added: FSDP2's gathers over gloo
# take most of a sharded step, and the whole run keeps to about 650 s)
PAR_TRAIN_DEPTH, PAR_TRAIN_STEPS = (2, 4), 2
# the accumulated sharded step (accum_steps=2 over a global batch of 8, on
# the fsdp mesh) and the DCP save and resume: a 2 + 4-block full-width DiT
PAR_ACCUM_DEPTH, PAR_ACCUM_BATCH, PAR_ACCUM_STEPS = (2, 4), 8, 2
PAR_LOSS_REL, PAR_GNORM_REL = 1e-2, 2e-2
# fp32 cp=2 against fp32 cp=1: 2.2e-3 measured on an H100: cuDNN's
# fp32 algorithms differ between 16- and 32-frame convs, and the GAN loss
# with random weights amplifies rounding (bf16: 2.3e-1)
CP_CLIP, CP_FP32_REL_L2 = (32, 128), 1e-2
CHILD_TIMEOUT = 600


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
    """[B, L] attention time ids of the DiT at one (unit, stage) of
    ``meta_pipe``'s pyramid: the prompt, then the pipeline's own packed
    latent layout, whose current clip is one frame at unit 0 and
    ``meta_pipe.frame_per_unit`` frames after it."""
    h_lat, w_lat = height // 8, width // 8
    budget = meta_pipe._cond_token_budget(unit, h_lat, w_lat)[stage]
    frames = 1 if unit == 0 else meta_pipe.frame_per_unit
    positions, time_ids, _ = meta_pipe._stage_metadata(
        B, frames, h_lat, w_lat, unit, stage, budget)
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


# K7's sites at the 384x640 request's unit 15 stage 2 (B = 2, the CFG
# rows): heads, head dim, norm group, text tokens, latent tokens, RoPE axes
# (None: no rotation; then k and v come from QK_TEXT_LEN text tokens)
QK_SITES = dict(
    flux_dual=(24, 64, "head", 128, 3072, (16, 24, 24)),
    flux_single=(24, 64, "head", 0, 3200, (16, 24, 24)),
    sd3=(24, 64, "head", 128, 3072, (64,)),
    wan_self=(40, 128, "token", 0, 2944, (44, 42, 42)),
    wan_cross=(40, 128, "token", 0, 2944, None))
QK_TEXT_LEN = 512
QK_TIMED_SITE = "flux_dual"


def qk_site(name, dev, seed):
    """``(slots, num_heads, cos, sin)`` of K7's site ``name`` in bf16: q and
    k normalised (and rotated), v copied; sources 3 N(0, 1), gains
    1 + N(0, 0.2), latent positions on a half-pixel grid; drawn from a CPU
    generator of their own."""
    g = torch.Generator().manual_seed(seed)
    heads, dh, group, lt, lx, axes = QK_SITES[name]
    width = heads * dh

    def src(n):
        return (3 * torch.randn((B, n, width), generator=g)).to(
            dev, torch.bfloat16)

    def norm():
        n = dh if group == "head" else width
        m = RMSNorm(n, dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            m.weight.copy_(1 + 0.2 * torch.randn(n, generator=g))
        return m

    if axes is None:
        return ((qkr.Slot((src(lx),), (norm(),)),
                 qkr.Slot((src(QK_TEXT_LEN),), (norm(),)),
                 qkr.Slot((src(QK_TEXT_LEN),))), heads, None, None)
    lens = (lt, lx) if lt else (lx,)
    slots = tuple(qkr.Slot(tuple(src(n) for n in lens),
                           tuple(norm() for _ in lens), True)
                  for _ in range(2))
    slots += (qkr.Slot(tuple(src(n) for n in lens)),)
    lat = torch.randint(0, 96, (B, lx, len(axes)), generator=g) / 2
    pos = torch.cat([torch.zeros(B, lt, len(axes)), lat], dim=1)
    cos, sin = rope_freqs(pos.to(dev), axes)
    return slots, heads, cos, sin


def pair_ulps(got, want) -> float:
    """The largest distance between two bf16 ``[..., D]`` tensors in ulps of
    each rotated pair's magnitude (a rotation spreads one rounding of its
    input over both of its outputs)."""
    a, w = got.float(), want.float()
    mag = w.unflatten(-1, (-1, 2)).norm(dim=-1).repeat_interleave(2, dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return ((a - w).abs() / ulp).max().item()


@torch.no_grad()
def qk_vs_plain(dev, reps=20):
    """K7 at each family's sites: q and k within ``QK_ULPS`` of the plain
    version (``qk_norm_rope_reference``, fp32 rounded once) and within
    ``QK_ULPS + 1`` of the modules' composition (``qk_norm_rope_composed``,
    which rounds once more), v bit-equal; one launch per site. Timed with
    CUDA events around wrapper calls back to back, as the paths make them
    (``ms``), the kernel's own device time from a profiler trace
    (``kernel_ms``), the plain version's and the composition's (with the
    ``.contiguous()`` copies the attention made of it) the same way; the
    bytes bound: each source read once, each output written once, cos/sin
    once, at 3.35 TB/s."""
    rows = []
    for i, name in enumerate(QK_SITES):
        slots, heads, cos, sin = qk_site(name, dev, SEED + i)
        before = qkr.qk_norm_rope_cuda.launches
        got = qkr.qkv_heads(slots, heads, cos, sin)
        torch.cuda.synchronize()
        launched = qkr.qk_norm_rope_cuda.launches - before
        plain = qkr.qk_norm_rope_reference(slots, heads, cos, sin)
        composed = [t.contiguous() for t in qkr.qk_norm_rope_composed(
            slots, heads, cos, sin)]
        nbytes = sum(2 * t.numel() * t.element_size() for slot in slots
                     for t in slot.sources)
        if cos is not None:
            nbytes += 2 * cos.numel() * cos.element_size()

        def kernel():
            return qkr.qk_norm_rope_cuda(slots, heads, cos, sin)

        r = dict(site=name, tokens=[[t.shape[1] for t in slot.sources]
                                    for slot in slots],
                 heads=heads, head_dim=got[0].shape[-1],
                 norm_group=slots[0].norms[0].weight.shape[0],
                 launches=launched,
                 max_pair_ulps=max(pair_ulps(a, b)
                                   for a, b in zip(got[:2], plain[:2])),
                 max_pair_ulps_composed=max(
                     pair_ulps(a, b) for a, b in zip(got[:2], composed[:2])),
                 v_bit_equal=torch.equal(got[2], plain[2]),
                 ms=cuda_ms(kernel, reps),
                 kernel_ms=kernel_device_ms(kernel, reps, "qk_norm_rope"),
                 plain_ms=cuda_ms(lambda: qkr.qk_norm_rope_reference(
                     slots, heads, cos, sin), reps),
                 composed_ms=cuda_ms(lambda: [t.contiguous() for t in (
                     qkr.qk_norm_rope_composed(slots, heads, cos, sin))],
                     reps),
                 bytes=nbytes)
        r["bound_ms"], r["bound_by"] = bound(0.0, nbytes)
        log("qk_norm_rope vs plain " + json.dumps(r))
        if not (launched == 1 and r["max_pair_ulps"] <= QK_ULPS
                and r["max_pair_ulps_composed"] <= QK_ULPS + 1
                and r["v_bit_equal"]):
            raise AssertionError(f"qk_norm_rope off its plain version: {r}")
        rows.append(r)
    return rows


# K8's sites at the 384x640 request's unit 15 stage 2 (B = 2, the CFG
# rows): the stream's dtype, its rows and width, and each call a block
# makes there as (residual, norm): residual None, "gated" (x + gate * y) or
# "plain" (x + y); norm None, "mod" (adaLN's modulation) or "affine" (a
# LayerNorm's weight and bias). miniFLUX's dual-block stream: the
# attention's residual with the MLP's norm, the block's first norm, the
# MLP's residual; a Wan block: the self-attention's residual with norm3,
# its first norm, the cross-attention's residual with the FFN's norm, the
# FFN's residual. A site's first call is the one timed.
NORM_SITES = dict(
    flux_dual=(torch.bfloat16, 3072, 1536,
               (("gated", "mod"), (None, "mod"), ("gated", None))),
    wan=(torch.float32, 2944, 5120,
         (("gated", "affine"), (None, "mod"), ("plain", "mod"),
          ("gated", None))))
NORM_TIMED_SITE = "flux_dual"


def norm_operands(name, call, dev, seed):
    """``(x, y, gate, norm)`` of ``call`` at K8's site ``name``: the stream
    3 N(0, 1), the product's output y N(0, 1) in bf16, the gate and the
    modulation 0.5 N(0, 1), chunks of one ``[B, 6, D]`` tensor in the
    stream's dtype, as the blocks cut them; an affine norm's weight 1 + N(0,
    0.2) and bias N(0, 0.2) in bf16, as Wan's ``norm3`` holds them; drawn
    from a CPU generator of their own."""
    g = torch.Generator().manual_seed(seed)
    dtype, rows, width, _ = NORM_SITES[name]
    residual, kind = call
    x = (3 * torch.randn((B, rows, width), generator=g)).to(dev, dtype)
    y = torch.randn((B, rows, width), generator=g).to(dev, torch.bfloat16)
    mod = (0.5 * torch.randn((B, 6, width), generator=g)).to(
        dev, dtype).chunk(6, dim=1)
    norm = rn.Norm(mod[0], mod[1]) if kind == "mod" else None
    if kind == "affine":
        bias = 0.2 * torch.randn((width,), generator=g)
        weight = 1 + 0.2 * torch.randn((width,), generator=g)
        norm = rn.Norm(bias.to(dev, torch.bfloat16),
                       weight.to(dev, torch.bfloat16), 1e-6, True)
    return (x, y if residual else None, mod[2] if residual == "gated"
            else None, norm)


def term_ulps(got, want, x_out, norm, stream=None) -> float:
    """The largest distance between two bf16 ``h`` in bf16 ulps of the
    magnitude of its terms, ``|n * mul| + |add|`` (``n`` the normalised
    stream; ``mul`` ``1 + scale``, an affine norm's weight): a sum that
    cancels keeps its terms' rounding; with ``stream`` (``|x| + |gate *
    y|``), normalised and scaled as the stream is, the residual's terms too
    (the composition rounds the product before the sum and passes that on
    to ``h``)."""
    xf = x_out.float()
    n = F.layer_norm(xf, xf.shape[-1:], eps=norm.eps)
    mul = norm.scale.float() if norm.affine else 1 + norm.scale.float()
    mag = (n * mul).abs() + norm.shift.float().abs()
    if stream is not None:
        rstd = torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True)
                           + norm.eps)
        mag = mag + stream * rstd * mul.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


@torch.no_grad()
def norm_vs_plain(dev, reps=20):
    """K8 at miniFLUX's dual-block site and Wan's, every call the blocks
    make there: ``x'`` bit-equal to the plain version
    (``residual_norm_reference``), ``h`` within ``NORM_ULPS`` of it and
    within ``NORM_COMPOSED_ULPS`` of the blocks' composition
    (``residual_norm_composed``, which rounds more often); one launch per
    call. A site's first call is timed as ``qk_vs_plain`` times K7, beside
    the plain version and the composition it replaced; the bytes bound: x
    and y read once, x' and h written once, at 3.35 TB/s."""
    rows = []
    for i, name in enumerate(NORM_SITES):
        for j, call in enumerate(NORM_SITES[name][3]):
            rows.append(norm_call_vs_plain(
                dev, name, call, SEED + 10 + 10 * i + j, reps if j == 0
                else 0))
    return rows


def norm_call_vs_plain(dev, name, call, seed, reps) -> dict:
    """One call of ``norm_vs_plain``, timed where ``reps``."""
    x, y, gate, norm = norm_operands(name, call, dev, seed)
    before = rn.residual_norm_cuda.launches
    got = rn.residual_norm(x, y, gate, norm, torch.bfloat16)
    torch.cuda.synchronize()
    launched = rn.residual_norm_cuda.launches - before
    plain = rn.residual_norm_reference(x, y, gate, norm, torch.bfloat16)
    r = dict(site=name, call="+".join(c or "none" for c in call),
             rows=list(x.shape[:2]), width=x.shape[2], stream=str(x.dtype),
             launches=launched, stream_bit_equal=torch.equal(got[0],
                                                             plain[0]),
             max_term_ulps=None, max_term_ulps_composed=None)
    if norm is not None:
        composed = rn.residual_norm_composed(x, y, gate, norm,
                                             torch.bfloat16)
        terms = x.float().abs()
        if y is not None:
            terms = terms + (y.float() if gate is None
                             else gate.float() * y.float()).abs()
        r.update(max_term_ulps=term_ulps(got[1], plain[1], plain[0], norm),
                 max_term_ulps_composed=term_ulps(got[1], composed[1],
                                                  plain[0], norm, terms))
    if reps:
        def kernel():
            return rn.residual_norm_cuda(x, y, gate, norm, torch.bfloat16)

        nbytes = x.numel() * (x.element_size() + (
            x.element_size() + 2 if y is not None else 0)
            + (2 if norm is not None else 0))
        r.update(ms=cuda_ms(kernel, reps),
                 kernel_ms=kernel_device_ms(kernel, reps, "residual_norm"),
                 plain_ms=cuda_ms(lambda: rn.residual_norm_reference(
                     x, y, gate, norm, torch.bfloat16), reps),
                 composed_ms=cuda_ms(lambda: rn.residual_norm_composed(
                     x, y, gate, norm, torch.bfloat16), reps),
                 bytes=nbytes)
        r["bound_ms"], r["bound_by"] = bound(0.0, nbytes)
    log("residual_norm vs plain " + json.dumps(r))
    if not (launched == 1 and r["stream_bit_equal"] and (norm is None or (
            r["max_term_ulps"] <= NORM_ULPS
            and r["max_term_ulps_composed"] <= NORM_COMPOSED_ULPS))):
        raise AssertionError(f"residual_norm off its plain version: {r}")
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
    """The experiment's entry point, ``exp_flash_h2.main``, in this process
    with ``--full``: its checks (three K6 launches at hs=2), its sweep at
    L=11008 (K1 and K6 at each hs that fits, each warmed up and timed), then
    K1 and K6 at ``FULL_HS`` again with every tile FULL (the tool prints
    the masked and FULL rows one after the other); launches counted from 0
    and held to exactly that."""
    reset_launch_counts()
    t0 = time.perf_counter()
    if exp_flash_h2.main(["--iters", str(TOOL_ITERS), "--full"]) != 0:
        raise AssertionError("exp_flash_h2.main failed")
    seconds = time.perf_counter() - t0
    launched = launch_counts()
    runs = exp_flash_h2.WARMUP + TOOL_ITERS
    fit = sum(fa.flash_fwd_hn_resources(hs, True)["fits"]
              for hs in fa.HN_HEADS_PER_BLOCK)
    full_fits = fa.flash_fwd_hn_resources(exp_flash_h2.FULL_HS,
                                          True)["fits"]
    want = expected(fwd=2 * runs, hn=3 + (fit + full_fits) * runs)
    log(f"exp_flash_h2 tool (--full): {seconds:.3f} s, launches {launched}")
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


def bwd_path_ms(q, k, v, t, do, causal, reps, bounded=True):
    """The attention backward as the training path calls it:
    ``torch.autograd.grad`` through ``flash_attention`` (on the softmax
    route ``bounded`` picks) less its forward,
    as :func:`sdpa_backward_ms` times SDPA (``ms``), and each backward
    kernel's own device time from a profiler trace of the same calls
    (``kernel_ms_dkv``, ``kernel_ms_dq``, ``kernel_ms_delta``; None where
    the trace holds no such kernel). Returns that dict and the trace's
    milliseconds per call of every kernel a forward plus backward
    launches."""
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def fwd():
        return fa.flash_attention(*qkv, t, causal=causal, bounded=bounded)

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


def dit_inputs(meta_pipe, dev, gen, dit, dtype, unit=15, stage=2):
    """Inputs of one forward at a 384x640 (unit, stage) layout of
    ``meta_pipe``'s pyramid, by default unit 15 stage 2 (the MMDiT's crop
    origin last)."""
    cfg = dit.config
    positions, t = layout_time_ids(meta_pipe, HEIGHT, WIDTH, unit, stage,
                                   dev)
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
    shrink = meta_pipe.num_stages - 1 - stage
    return ((tokens, pos, lat_time, text, mask, pooled, ts)
            + dit.stage_inputs(B, HEIGHT // 8 >> shrink, WIDTH // 8 >> shrink,
                               dev)), lat_time[0]


def plain_attention_route(q, k, v, time_ids, *, causal, sm_scale, bounded):
    """The DiTs' attention on the plain version (patched in for
    ``parallel.sp.flash_attention``)."""
    return fa.attention_reference(q, k, v, time_ids, causal=causal,
                                  sm_scale=sm_scale)


@contextlib.contextmanager
def plain_route():
    """The DiTs on their plain version: the attention's
    (``plain_attention_route``), and the q/k chain and the blocks' norms
    and residuals composed (``ops.composition.composition``) in place of K7
    and K8."""
    with mock.patch.object(par_sp, "flash_attention",
                           plain_attention_route), composition():
        yield


@torch.no_grad()
def fp32_forward(dit, inputs, **forward_kw):
    """The same DiT and inputs in fp32 on the plain route, sp=1: a float
    copy built for the call and freed before it returns."""
    dit32 = type(dit)(dit.config, dtype=torch.float32, device=inputs[0].device)
    dit32.load_state_dict(dit.state_dict())
    inputs32 = [t.float() if t.dtype == torch.bfloat16 else t for t in inputs]
    with plain_route():
        out = dit32(*inputs32, **forward_kw)
    torch.cuda.synchronize()
    del dit32
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the DiTs' two softmax routes: (name, bounded_softmax)
ROUTES = (("bounded", True), ("classic", False))


def route_launches(bounded: bool, n: int, serving: bool = True,
                   norms: int = 0) -> dict:
    """``expected``'s keywords for ``n`` attentions on a DiT's route: K1's
    launches on the bounded softmax, K2's on the classic one, and in a
    serving forward (no autograd) K7's, one per attention, and K8's,
    ``norms`` (``num_norm_calls`` per forward); training composes the q/k
    chain and the norms (neither kernel has a backward)."""
    return dict(fwd=n if bounded else 0, classic=0 if bounded else n,
                qk=n if serving else 0, norm=norms if serving else 0)


@torch.no_grad()
def dit_routes(dit, inputs, lat_time, **forward_kw):
    """One bf16 forward on each softmax route (K1 for the bounded one, K2
    for the classic one, each launched once per attention and the other
    not at all) and one through the plain version, then the same DiT and
    inputs in fp32 on the plain route (a copy built after the bf16 forwards
    and freed before this returns). Returns per route whether its output is
    finite, its relative L2 to the plain version and to fp32, whether it is
    ``anchored`` (finite and within 1.1x of the plain version's distance to
    fp32: two bf16 routes drift apart with random weights about as far as
    each drifts from fp32, as the encode check holds the conv kernel) and
    whether it ``holds`` (anchored, and within ``DIT_REL_L2`` of the plain
    version). ``forward_kw`` go to every forward (the guidance DiT's
    ``guidance``). The DiT's route is left as it was."""
    valid = lat_time != fa.INVALID_TIME
    n, route = dit.num_attention_calls, dit.bounded_softmax
    outs = {}
    try:
        for name, bounded in ROUTES:
            dit.bounded_softmax = bounded
            before = launch_counts()
            out = dit(*inputs, **forward_kw)
            torch.cuda.synchronize()
            want = expected(**route_launches(bounded, n,
                                             norms=dit.num_norm_calls))
            if counted(before) != want:
                raise AssertionError(f"{name} forward launches "
                                     f"{counted(before)}, expected {want}")
            outs[name] = out[:, valid].float()
    finally:
        dit.bounded_softmax = route
    with plain_route():
        b = dit(*inputs, **forward_kw)[:, valid].float()
    torch.cuda.synchronize()
    out_32 = fp32_forward(dit, inputs, **forward_kw)[:, valid]
    if not (torch.isfinite(b).all() and torch.isfinite(out_32).all()):
        raise AssertionError("non-finite plain or fp32 DiT output")
    r = dict(dit=type(dit).__name__, L=inputs[2].shape[1] + TEXT_LEN,
             plain_vs_fp32=rel_l2(b, out_32),
             out_rms=b.square().mean().sqrt().item())
    for name, a in outs.items():
        finite = bool(torch.isfinite(a).all())
        rel = rel_l2(a, b) if finite else None
        to_32 = rel_l2(a, out_32) if finite else None
        anchored = finite and to_32 <= 1.1 * r["plain_vs_fp32"]
        r[name] = dict(finite=finite, rel_l2=rel, vs_fp32=to_32,
                       anchored=anchored,
                       holds=anchored and rel <= DIT_REL_L2)
    return r


def dit_check(dit, meta_pipe, dev, gen, unit=15, stage=2, **forward_kw):
    """``dit_routes`` at a 384x640 (unit, stage) layout of ``meta_pipe``'s
    pyramid, by default unit 15 stage 2: both softmax routes must hold."""
    inputs, lat_time = dit_inputs(meta_pipe, dev, gen, dit,
                                  next(dit.parameters()).dtype, unit, stage)
    r = dit_routes(dit, inputs, lat_time, **forward_kw)
    log(f"full-width {r['dit']} forward, L={r['L']} (unit {unit} stage "
        f"{stage}, {meta_pipe.frame_per_unit} frames per unit), each route "
        f"against the plain version (limit {DIT_REL_L2}) and fp32 (within "
        f"1.1x of the plain version's {r['plain_vs_fp32']:.3e}): "
        + ", ".join(
            f"{name} {r[name]['rel_l2']}, {r[name]['vs_fp32']}"
            for name, _ in ROUTES) + f"; |out| rms {r['out_rms']:.3e}")
    failed = [name for name, _ in ROUTES if not r[name]["holds"]]
    if failed:
        raise AssertionError(f"DiT forward off on the {failed} route: {r}")
    return r


def envelope_check(meta_pipe, dev) -> dict:
    """Out of the bounded forward's envelope: a full-width miniFLUX cut to
    ``ENVELOPE_DEPTH`` blocks, bf16, seeded weights (SEED + 12), whose
    qk-norm gains are multiplied by ``GAIN0`` and then by ``GAIN_STEP``
    until ``bounded_softmax_overshoot`` over its attentions' post-RoPE q
    and k (the training probe's reading) passes ``ENVELOPE_LOG2``. Then at
    the ``dit_check`` layout the classic route (K2) must stay anchored to
    fp32 and the bounded route (K1) must not (nor hold): the scenario the
    training CLI's warning describes, and why ``--classic_softmax`` exists.
    At these gains the bf16 plain version itself sits about 1e-1 from fp32
    on an H100 (scores 16 times the envelope's amplify every bf16
    rounding), and the classic route about 5e-2 from it, so ``DIT_REL_L2``
    between two bf16 routes is below the rounding there and fp32 is the
    anchor; the relative L2 to the plain version is printed."""
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    dual, single = ENVELOPE_DEPTH
    dit = PyramidFluxTransformer(
        FluxConfig(num_layers=dual, num_single_layers=single),
        dtype=torch.bfloat16, device=dev)
    randomize_(dit, gen)
    inputs, lat_time = dit_inputs(meta_pipe, dev, gen, dit, torch.bfloat16)
    tq = torch.cat([text_time(dev), lat_time.to(torch.int32)])[None]
    norms = [p for name, p in dit.named_parameters()
             if name.split(".")[-2] in ("norm_q", "norm_k", "norm_added_q",
                                        "norm_added_k")]
    gain, factor, readings = 1.0, GAIN0, []
    while not readings or readings[-1] <= ENVELOPE_LOG2:
        with torch.no_grad():
            for p in norms:
                p.mul_(factor)
        gain, factor = gain * factor, GAIN_STEP
        with torch.no_grad(), dit.capture_qk() as captured:
            dit(*inputs)
        readings.append(max(fa.bounded_softmax_overshoot(q[:1], k[:1], tq)
                            .item() for q, k in captured))
    r = dit_routes(dit, inputs, lat_time)
    r.update(depth=list(ENVELOPE_DEPTH), qk_gain=gain,
             overshoot_log2=readings, seconds=time.perf_counter() - t0)
    log("out of the envelope " + json.dumps(r))
    if not r["classic"]["anchored"] or r["bounded"]["anchored"]:
        raise AssertionError(
            f"out of the envelope the classic route must stay anchored to "
            f"fp32 and the bounded route must not: {r}")
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    return r


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
    ``flash_fwd_classic`` the classic one (K2, the DiTs' classic-softmax
    route), ``flash_fwd_hn`` the heads-per-block forward (K6), which only
    the ``exp_flash_h2`` tool runs, ``qk_norm_rope`` the fused q/k/v pass
    (K7) and ``residual_norm`` the fused residual update and LayerNorm (K8;
    a graph replay adds the launches its graphs hold of each)."""
    classic = fa.flash_fwd_cuda.classic_launches
    return {"flash_fwd": fa.flash_fwd_cuda.launches - classic,
            "flash_fwd_classic": classic,
            "flash_bwd_dkv": fa.flash_bwd_cuda.dkv_launches,
            "flash_bwd_dq": fa.flash_bwd_cuda.dq_launches,
            "causal_conv3d": cc.causal_conv3d_cuda.launches,
            "flash_fwd_hn": fa.flash_fwd_hn_cuda.launches,
            "qk_norm_rope": qkr.qk_norm_rope_cuda.launches,
            "residual_norm": rn.residual_norm_cuda.launches}


def reset_launch_counts():
    fa.flash_fwd_cuda.launches = 0
    fa.flash_fwd_cuda.classic_launches = 0
    fa.flash_bwd_cuda.dkv_launches = 0
    fa.flash_bwd_cuda.dq_launches = 0
    cc.causal_conv3d_cuda.launches = 0
    fa.flash_fwd_hn_cuda.launches = 0
    qkr.qk_norm_rope_cuda.launches = 0
    rn.residual_norm_cuda.launches = 0


def expected(fwd=0, bwd=0, conv=0, hn=0, classic=0, qk=0, norm=0) -> dict:
    """Launch counts of a path: ``fwd`` of K1, ``classic`` of K2, ``bwd`` of
    each backward kernel, ``qk`` of K7, ``norm`` of K8."""
    return {"flash_fwd": fwd, "flash_fwd_classic": classic,
            "flash_bwd_dkv": bwd, "flash_bwd_dq": bwd, "causal_conv3d": conv,
            "flash_fwd_hn": hn, "qk_norm_rope": qk, "residual_norm": norm}


def counted(before: dict) -> dict:
    return {k: n - before[k] for k, n in launch_counts().items()}


def ar_noise_stage(draws, sched, pyramid, stage):
    """The AR recipe's noising of one stage row, every unit of the clip."""
    return add_ar_noise_stage(draws, sched, pyramid, stage, 3, TRAIN_FRAMES)


def full_noise_stage(draws, sched, pyramid, stage):
    """The full-sequence recipe's noising of one stage row: one clip of
    every frame."""
    return add_pyramid_noise_stage(draws, sched, pyramid, stage, 3)


def dit_grad_check(dit, dev, gen, stage=2, noise_stage=ar_noise_stage):
    """One training-loss backward of a batch row at a training layout,
    by default the AR recipe's at stage 2 (``noise_stage`` noises the row
    at ``stage``), through the plain version, then through the kernels on
    each softmax route (K1 or K2 forward, K3/K4 backward after its
    ``lse``), each held to the plain gradient. Every parameter gets a
    nonzero gradient but the DiT's ``gradient_free_parameters`` (the
    MMDiT's last-block text-query projection, whose output that block
    discards), which get exactly 0. The plain gradient waits in host
    memory, each leaf brought back for its comparison, so that the check
    fits beside a train state on the card. The DiT's route is left as it
    was."""
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    batch = training_batch(dit.config, dev, gen, 1)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    pyramid = latent_pyramid(batch["latents"], 3)
    sb = noise_stage(draws, sched, pyramid, stage)
    tokens, positions, time_ids, trainable = pack_clips(sb.clips)
    pos = torch.as_tensor(positions, device=dev)[None]
    times = torch.as_tensor(time_ids, device=dev)[None]
    target = patchify(sb.targets)
    L = TEXT_LEN + tokens.shape[1]
    extra = dit.stage_inputs(1, *pyramid[stage].shape[2:4], dev)

    def backward():
        # K7 has no backward: the q/k chain composed, as the train step has
        dit.zero_grad(set_to_none=True)
        with composition():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                pred = dit(tokens, pos, times, batch["text_emb"],
                           batch["text_mask"], batch["pooled"],
                           sb.timesteps, *extra)
                loss = (pred[:, -trainable:].float()
                        - target.float()).square().mean()
            loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad for n, p in dit.named_parameters()}
        dit.zero_grad(set_to_none=True)
        return loss.item(), grads

    with plain_route():
        t0 = time.perf_counter()
        loss_p, gp = backward()
        plain_s = time.perf_counter() - t0
    gp = {m: g.cpu() for m, g in gp.items()}
    torch.cuda.empty_cache()
    n, route = dit.num_attention_calls, dit.bounded_softmax
    r = dict(dit=type(dit).__name__, L=L, stage=stage,
             recipe=noise_stage.__name__, loss_plain=loss_p, plain_s=plain_s)
    try:
        for name, bounded in ROUTES:
            dit.bounded_softmax = bounded
            before = launch_counts()
            t0 = time.perf_counter()
            loss_k, gk = backward()
            kernel_s = time.perf_counter() - t0
            launched = counted(before)
            want = expected(bwd=n, **route_launches(bounded, 2 * n,
                                                    serving=False))
            if launched != want:
                raise AssertionError(f"{name} route: launches {launched} in "
                                     f"one remat forward+backward, expected "
                                     f"{want}")
            missing = [m for m, g in gk.items()
                       if g is None or not bool((g != 0).any())]
            if missing != list(getattr(dit, "gradient_free_parameters", ())):
                raise AssertionError(f"{len(missing)} parameters got no "
                                     f"gradient on the {name} route, e.g. "
                                     f"{missing[:5]}")
            diff2 = ref2 = 0.0
            worst = ("", 0.0)
            for m, g in gk.items():
                ref = gp[m].to(dev)
                d2 = (g - ref).float().square().sum().item()
                r2 = ref.float().square().sum().item()
                diff2, ref2 = diff2 + d2, ref2 + r2
                if r2 > 0 and math.sqrt(d2 / r2) > worst[1]:
                    worst = (m, math.sqrt(d2 / r2))
            del gk
            r[name] = dict(loss=loss_k, rel_l2=math.sqrt(diff2 / ref2),
                           worst_leaf=worst[0], worst_leaf_rel_l2=worst[1],
                           gradient_free=missing, launches=launched,
                           seconds=kernel_s)
    finally:
        dit.bounded_softmax = route
    log("full-width DiT gradient, each route vs plain " + json.dumps(r))
    for name, _ in ROUTES:
        rel = r[name]["rel_l2"]
        if not (math.isfinite(rel) and rel <= DIT_GRAD_REL_L2):
            raise AssertionError(f"DiT gradient on the {name} route: "
                                 f"relative L2 {rel} > {DIT_GRAD_REL_L2}")
    return r


@torch.no_grad()
def zero_output_(dit):
    """A fresh DiT's zero output projection (``randomize_`` drew it): the
    loss starts at E[target^2], below the anomaly gate."""
    dit.proj_out.weight.zero_()
    dit.proj_out.bias.zero_()


def train(dit, dev, gen, n_steps=TRAIN_STEPS, use_temporal_pyramid=True,
          state=None):
    """``n_steps`` train steps of a release DiT at the CLI's default shape,
    on the AR recipe or (``use_temporal_pyramid=False``) the full-sequence
    one, from a new train state or on ``state``. Returns (steps, launches,
    peak GB, state)."""
    torch.cuda.reset_peak_memory_stats(dev)
    if state is None:
        zero_output_(dit)
        state = create_train_state(dit, TrainConfig(
            learning_rate=5e-5, weight_decay=1e-4, max_grad_norm=1.0,
            lr_schedule=cosine_schedule(5e-5, 1e-6, 1000, 10, 1000)))
    sched = PyramidFlowMatchEulerDiscreteScheduler()
    step_fn = make_train_step(dit, sched, (1, 2, 1), use_temporal_pyramid, 1,
                              1 / 3, cfg_rate=0.1,
                              compute_dtype=torch.bfloat16)
    batch = training_batch(dit.config, dev, gen, TRAIN_BATCH)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    steps = []
    reset_launch_counts()
    # the latent tokens of each stage forward: on the full-sequence recipe
    # every stage row is one clip of all TRAIN_FRAMES frames
    tokens = []
    hook = dit.register_forward_pre_hook(
        lambda module, args: tokens.append(args[0].shape[1]))
    full = [TRAIN_FRAMES * (48 >> (3 - s)) * (80 >> (3 - s))
            for s in range(3)]
    for _ in range(n_steps):
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=TRAIN_FRAMES))
        before = dit.proj_out.weight.detach().clone()
        tokens.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, draws, units)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        moved = not torch.equal(before, dit.proj_out.weight)
        r = dict(dit=type(dit).__name__, step=state.step,
                 recipe="AR" if use_temporal_pyramid else "full sequence",
                 units=units, latent_tokens=list(tokens),
                 loss=m["train/loss"],
                 grad_norm=m["train/grad_norm"], applied=m["train/applied"],
                 moved=moved, lr_count=state.opt_count, seconds=seconds)
        log("train step " + json.dumps(r))
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"non-finite train step {r}")
        if not use_temporal_pyramid and tokens != full:
            raise AssertionError(f"full-sequence stage forwards of "
                                 f"{tokens} latent tokens, expected {full}")
        steps.append(r)
    hook.remove()
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    attentions = dit.num_attention_calls * 3 * n_steps  # 3 stage forwards
    if launched != expected(2 * attentions, attentions):
        raise AssertionError(f"train launches {launched}, expected "
                             f"{expected(2 * attentions, attentions)}")
    if not any(r["applied"] and r["moved"] for r in steps):
        raise AssertionError("no train step passed the anomaly gate and "
                             "moved the parameters")
    log(f"train ({'AR' if use_temporal_pyramid else 'full sequence'}): "
        f"peak memory {peak:.3f} GB, launches {launched} ({card_line()})")
    return steps, launched, peak, state


def ema_evaluation(state, vae, dev, paths):
    """The EMA evaluation path after the latent train steps:
    ``export_ema_params``/``load_ema_params`` round-trip the state's EMA
    (and the persistent buffers) bit for bit through ``EMA_DIR``;
    ``PyramidFlowPipeline.from_train_state(use_ema=True)`` builds a bf16
    DiT holding exactly the EMA, cast; one temp-1 request from it (its own
    generator, SEED + 11) with the predicted launches; and the training
    model's parameters and EMA are unchanged afterwards."""
    t_phase = time.perf_counter()
    params = {n: p.detach().cpu() for n, p in state.params.items()}
    ema = {n: t.cpu() for n, t in state.ema_state_dict().items()}
    shutil.rmtree(EMA_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = export_ema_params(EMA_DIR, state.step, ema)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_ema_params(EMA_DIR)
        load_s = time.perf_counter() - t0
        same = loaded.keys() == ema.keys() and all(
            torch.equal(loaded[n], t) for n, t in ema.items())
        del loaded
    finally:
        shutil.rmtree(EMA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    pipe = PyramidFlowPipeline.from_train_state(
        state.model, state, vae, use_ema=True, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = pipe.dit.state_dict()
    cast = held.keys() == ema.keys() and all(
        torch.equal(held[n].cpu(), t.to(torch.bfloat16))
        for n, t in ema.items())
    del held
    reset_launch_counts()
    req = serve(pipe, dev, torch.Generator(dev).manual_seed(SEED + 11),
                "ema", 1)
    paths["EMA evaluation, T2V"] = req["launches"]
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    unchanged = all(torch.equal(p.detach().cpu(), params[n])
                    for n, p in state.params.items()) and all(
        torch.equal(t.cpu(), ema[n]) for n, t in state.ema.items())
    r = dict(step=state.step, ema_bytes=nbytes, export_s=save_s,
             load_s=load_s, round_trip_bit_equal=same,
             from_train_state_s=build_s, holds_the_ema_cast=cast,
             request_wall_s=req["wall_s"], training_model_unchanged=unchanged,
             phase_s=time.perf_counter() - t_phase, card=card_line())
    log("EMA evaluation " + json.dumps(r))
    if not (same and cast and unchanged):
        raise AssertionError(f"EMA evaluation: {r}")
    return r


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


def full_sequence_time_ids(dev) -> torch.Tensor:
    """[1, L] attention time ids of the full-sequence recipe's stage-2 row:
    the prompt (100 valid tokens, time id 0), then its one clip of
    ``TRAIN_FRAMES`` frames of 48x80 latents as ``pack_clips`` packs it
    (frame f: time id f, 960 tokens)."""
    _, _, time_ids, _ = pack_clips(
        [torch.zeros((1, TRAIN_FRAMES, 48, 80, 16), device=dev)])
    return torch.cat([text_time(dev),
                      torch.as_tensor(time_ids, device=dev)])[None]


def full_sequence_kernels(dev, gen) -> list:
    """K1 and K2 forward, and K3/K4 backward after each one's ``lse``, at
    the full-sequence stage-2 layout (B=1, H=24, D=64, L = 15488, causal)
    against the plain version computed one head at a time (one head's fp32
    scores take 0.96 GB, all 24 heads 23 GB), with phase 3's and phase 4's
    tolerances (the upstream gradient zero on padded rows). Each wrapper is
    timed with CUDA events as the training path calls it (the backward:
    ``torch.autograd.grad`` through ``flash_attention`` less its forward),
    beside SDPA with the same mask and the plain version; the tile split
    of the layout. Returns one result per softmax route."""
    t = full_sequence_time_ids(dev)
    L = t.shape[1]
    shape = (1, H, L, D)
    q, k = rms_normal(shape, gen, dev), rms_normal(shape, gen, dev)
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    valid = t[0] != fa.INVALID_TIME
    do = (torch.randn(shape, generator=gen, device=dev)
          * valid[:, None]).bfloat16()
    o_ref, lse_ref = plain_attention(q, k, v, t, True, head_chunk=1)
    plain_ms = cuda_ms(lambda: plain_attention(q, k, v, t, True, head_chunk=1),
                       reps=1, warmup=0)
    plain_bwd_ms = None
    # bounds: operations on the visible pairs; bytes as phases 3 and 4 count
    pairs = H * visible_pairs(t[0], True)
    io = H * L * D * 2  # one [1, H, L, D] bf16 tensor
    reads = 4 * io + 2 * H * L * 4 + 2 * L * 4
    fwd_bound = bound(4 * D * pairs, 4 * io + H * L * 4 + 2 * L * 4)
    dkv_bound = bound(8 * D * pairs, reads + 2 * io)
    dq_bound = bound(6 * D * pairs, reads + io)
    mask = sdpa_mask(t, True)
    sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), FULL_REPS)
    del mask
    sdpa_bwd = sdpa_backward_ms(q, k, v, t, do, True, FULL_REPS)
    split = tile_split(t, t, True)
    results = []
    for name, bounded in ROUTES:
        def run():
            return fa.flash_fwd_cuda(q, k, v, t, t, causal=True,
                                     sm_scale=D ** -0.5, bounded=bounded)
        o, lse = run()
        got = fa.flash_bwd_cuda(q, k, v, t, t, o, lse, do, causal=True,
                                sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        r = dict(layout="full sequence, stage 2", L=L, route=name,
                 tiles=split,
                 max_abs_err_o=(o.float() - o_ref.float())[:, :, valid]
                 .abs().max().item(),
                 max_abs_err_lse=(lse - lse_ref)[:, :, valid].abs().max()
                 .item())
        ok = r["max_abs_err_o"] <= O_ATOL and r["max_abs_err_lse"] <= LSE_ATOL
        ref = plain_backward(q, k, v, t, o, lse, do, True, head_chunk=1)
        if plain_bwd_ms is None:
            plain_bwd_ms = cuda_ms(lambda: plain_backward(
                q, k, v, t, o, lse, do, True, head_chunk=1), reps=1, warmup=0)
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            ok = (ok and bool(torch.isfinite(a).all())
                  and err <= GRAD_REL * scale)
            r[f"max_abs_err_{gname}"], r[f"max_abs_{gname}"] = err, scale
        del o, lse, got, ref
        r.update(ms=cuda_ms(run, FULL_REPS), plain_ms=plain_ms,
                 library_ms=sdpa_fwd_ms, bound_ms=fwd_bound[0],
                 bound_by=fwd_bound[1])
        bwd = bwd_path_ms(q, k, v, t, do, True, FULL_REPS, bounded)[0]
        r["backward"] = dict(
            bwd, plain_ms=plain_bwd_ms, library_ms=sdpa_bwd["library_ms"],
            bound_ms_dkv=dkv_bound[0], bound_by_dkv=dkv_bound[1],
            bound_ms_dq=dq_bound[0], bound_by_dq=dq_bound[1])
        log(f"kernels at the full-sequence stage-2 layout, {card_line()} "
            + json.dumps(r))
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at the "
                                 f"full-sequence layout: {r}")
        results.append(r)
    del q, k, v, do, o_ref, lse_ref
    torch.cuda.empty_cache()
    return results


def full_sequence_paths(dit, state, dev, paths) -> dict:
    """Phase 10b, the full-sequence recipe on phase 10's train DiT and
    state (fp32 parameters, bf16 autocast, remat), its draws from a
    generator of its own (SEED + 15): the kernels at its stage-2 layout
    (``full_sequence_kernels``), the whole DiT's gradient at its stage-1
    layout on both softmax routes against the plain route
    (``dit_grad_check``), then ``FULL_STEPS`` train steps at phase 10's
    shape on that state with a full-sequence step function (``train``)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    kernels = full_sequence_kernels(dev, gen)
    grad = dit_grad_check(dit, dev, gen, FULL_GRAD_STAGE, full_noise_stage)
    steps, paths["train (latents), full sequence"], peak, _ = train(
        dit, dev, gen, FULL_STEPS, use_temporal_pyramid=False, state=state)
    r = dict(steps=steps, peak_mem_gb=peak,
             phase_s=time.perf_counter() - t_phase, card=card_line())
    log("full-sequence recipe " + json.dumps(r))
    r.update(kernels=kernels, grad=grad)
    return r


def request_shape(pipe, temp, i2v=False):
    """(DiT forwards, latent frames) of a request at ``temp`` through
    ``pipe``, by the pipeline's unit arithmetic on its ``frame_per_unit``
    (fpu): text-to-video generates unit 0 (one frame, ``STEPS``) and
    (temp - 1) // fpu later units (fpu frames each, ``VIDEO_STEPS``);
    image-to-video takes the image as unit 0 and generates
    temp // fpu - 1 later units."""
    fpu = pipe.frame_per_unit
    later = temp // fpu - 1 if i2v else (temp - 1) // fpu
    first = 0 if i2v else sum(STEPS)
    return first + later * sum(VIDEO_STEPS), 1 + later * fpu


def serve(pipe, dev, gen, name, temp, bench=False):
    """One T2V request at 384x640 through ``pipe`` on its DiT's softmax
    route and its frames per unit, the features drawn from ``gen``, with
    its exact launches; the
    peak memory of the whole request, of its DiT phase and of its decode,
    and the memory held when the decode starts. ``bench``: as the JAX bench
    makes it, the DiT released before the decode, which frees its memory
    where the pipeline is its only holder; the pipeline then has no DiT."""
    cfg, n = pipe.dit.config, pipe.dit.num_attention_calls
    bounded, norms = pipe.dit.bounded_softmax, pipe.dit.num_norm_calls
    emb = torch.randn((1, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                      device=dev).to(pipe.dtype)
    mask = (text_time(dev) == 0)[None]
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen,
                         device=dev).to(pipe.dtype)
    seen, memory = [], {}
    decode = pipe.decode_latent

    def spy(latents, **kw):
        seen.append(latents)
        memory["dit_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        memory["decode_start_gb"] = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        out = decode(latents, **kw)
        memory["decode_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        return out

    forwards, n_latent = request_shape(pipe, temp)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy):
        t0 = time.perf_counter()
        frames = pipe.generate(
            torch.Generator(dev).manual_seed(SEED + temp), emb, mask, pooled,
            emb * 0, mask, pooled * 0, height=HEIGHT, width=WIDTH, temp=temp,
            num_inference_steps=STEPS, video_num_inference_steps=VIDEO_STEPS,
            guidance_scale=7.0, video_guidance_scale=5.0,
            output_type="pixels", save_memory=True,
            release_dit_before_decode=bench)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counted(before)
    windows = len(vae_model._window_starts(n_latent, DECODE_WINDOW, 1))
    want = expected(**route_launches(bounded, n * forwards,
                                     norms=norms * forwards),
                    conv=kernel_conv_count(pipe.vae.decoder) * windows)
    check_request(frames, seen, launched, want, n_latent)
    r = dict(request=name, temp=temp, frame_per_unit=pipe.frame_per_unit,
             latent_frames=n_latent, frames=frames.shape[1],
             bounded_softmax=bounded, bench=bench,
             dit_released=pipe.dit is None, dit_forwards=forwards,
             launches=launched, wall_s=wall,
             dit_s=pipe.last_dit_seconds, decode_s=pipe.last_decode_seconds,
             peak_mem_gb=max(memory["dit_peak_gb"],
                             memory["decode_peak_gb"]), **memory,
             latent_rms=seen[0].square().mean().sqrt().item(),
             frame_std=frames.float().std().item(), card=card_line())
    log("request " + json.dumps(r))
    return r


def check_request(frames, seen, launched, want, n_latent):
    """A request's ``n_latent`` latent frames (``request_shape``), decoded
    to 1 + 8 (n_latent - 1) uint8 frames, finite and not constant, with
    exactly the launches ``want``."""
    if seen[0].shape[1] != n_latent:
        raise AssertionError(f"{seen[0].shape[1]} latent frames, expected "
                             f"{n_latent}")
    expect = (1, 1 + 8 * (n_latent - 1), HEIGHT, WIDTH, 3)
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


def i2v_image(gen, dev) -> np.ndarray:
    """The image-to-video requests' seeded smooth 384x640 uint8 image."""
    return ((smooth_video(gen, dev, 1, HEIGHT, WIDTH)[0, 0] + 1) * 127.5
            ).round().to(torch.uint8).cpu().numpy()


def serve_i2v(pipe, dev, image, temp=I2V_TEMP, name="i2v"):
    """One image-to-video request from ``image`` through
    ``PyramidFlowRunner`` at ``temp``, with its exact launches."""
    runner = PyramidFlowRunner(pipe, StandInTextEncoder(pipe.dit.config, dev,
                                                        pipe.dtype))
    seen, encode_s = [], []
    decode, encode = pipe.decode_latent, vae_model.chunk_encode

    def spy(latents, **kw):
        seen.append(latents)
        return decode(latents, **kw)

    def timed_encode(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*args, **kw)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
        return out

    forwards, n_latent = request_shape(pipe, temp, i2v=True)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(pipe, "decode_latent", spy), \
            mock.patch.object(vae_model, "chunk_encode", timed_encode):
        t0 = time.perf_counter()
        frames = runner.generate_i2v(
            "a red kite over a beach at dawn", image, seed=SEED,
            height=HEIGHT, width=WIDTH, temp=temp,
            num_inference_steps=STEPS,
            video_num_inference_steps=VIDEO_STEPS, guidance_scale=7.0,
            video_guidance_scale=5.0, output_type="pixels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counted(before)
    windows = len(vae_model._window_starts(n_latent, DECODE_WINDOW, 1))
    want = expected(**route_launches(
        True, pipe.dit.num_attention_calls * forwards,
        norms=pipe.dit.num_norm_calls * forwards), conv=(
        kernel_conv_count(pipe.vae.encoder)
        + kernel_conv_count(pipe.vae.decoder) * windows))
    check_request(frames, seen, launched, want, n_latent)
    r = dict(request=name, temp=temp, frames=frames.shape[1],
             dit_forwards=forwards, launches=launched, wall_s=wall,
             encode_s=encode_s[0], dit_s=pipe.last_dit_seconds,
             decode_s=pipe.last_decode_seconds,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             latent_rms=seen[0].square().mean().sqrt().item(),
             frame_std=frames.float().std().item())
    log("request " + json.dumps(r))
    return r


def two_frame_units(dit, vae, dev, paths):
    """The pyramid at ``FPU`` latent frames per unit, through a second
    ``PyramidFlowPipeline(dit, vae, frame_per_unit=FPU)`` over the serving
    models (no model memory of its own), its draws from a generator of
    their own (SEED + 14). First the DiT at the request's widest layout,
    ``FPU_CHECK`` (text, a padded history of two stage-2 frames and one
    stage-1 frame, two current frames with a time id each), on both softmax
    routes against the plain version and fp32 as ``dit_check`` holds them
    (launches made for that count for no path); then one T2V request at
    ``FPU_TEMP`` with its exact launches (``serve``)."""
    pipe = PyramidFlowPipeline(dit, vae, frame_per_unit=FPU,
                               dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    unit, stage = FPU_CHECK
    _, t = layout_time_ids(pipe, HEIGHT, WIDTH, unit, stage, dev)
    budget = pipe._cond_token_budget(unit, HEIGHT // 8, WIDTH // 8)[stage]
    current = t[0, TEXT_LEN + budget:]
    ids = current.unique().tolist()
    # 64-row query tiles holding more than one valid time id
    rows = t[0, :t.shape[1] // fa.FWD_TILE_Q * fa.FWD_TILE_Q].view(
        -1, fa.FWD_TILE_Q)
    straddle = [i for i, r in enumerate(rows)
                if len(set(r.tolist()) - {fa.INVALID_TIME}) > 1]
    log(f"two frames per unit: unit {unit} stage {stage} layout L="
        f"{t.shape[1]}, history budget {budget}, current time ids {ids}, "
        f"query tiles straddling two time ids {straddle}, tiles (causal) "
        f"{tile_split(t, t, True)}")
    if len(ids) != FPU or fa.INVALID_TIME in ids:
        raise AssertionError(f"the current clip's time ids {ids}: expected "
                             f"{FPU} valid ones")
    check = dit_check(dit, pipe, dev, gen, unit=unit, stage=stage)
    reset_launch_counts()
    request = serve(pipe, dev, gen, "a, two frames per unit", FPU_TEMP)
    paths["text-to-video, two frames per unit"] = launch_counts()
    return check, request


def mmdit_paths(vae, meta_pipe, dev, gen, paths, image):
    """The release MMDiT (24 joint blocks, 24 x 64 heads): a bf16 forward
    kernel vs plain, one T2V request through
    ``PyramidFlowPipeline(model_name="pyramid_mmdit")`` with the release
    VAE, the string-prompt request, one I2V request from ``image`` (the
    flux I2V request's), then with fp32 parameters and remat the gradient
    check, ``MMDIT_TRAIN_STEPS`` latent train steps and
    ``FULL_MMDIT_STEPS`` on the full-sequence recipe (its batch from a
    generator of its own, SEED + 16). Adds the requests' and the steps'
    launches to ``paths``."""
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
    paths["MMDiT image-to-video"] = serve_i2v(
        pipe, dev, image, MMDIT_I2V_TEMP, "mmdit i2v")["launches"]
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
    _, paths["MMDiT train (latents), full sequence"], _, _ = train(
        tmm, dev, torch.Generator(dev).manual_seed(SEED + 16),
        FULL_MMDIT_STEPS, use_temporal_pyramid=False, state=state)
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
    """Whether the optional packages the paths could use import here: the
    port reads safetensors itself, tokenizes with transformers only when a
    checkpoint's tokenizers are loaded, saves PNGs with PIL, decodes clips
    with cv2 (the extraction tool) and writes mp4 through imageio's ffmpeg
    plugin (the inference CLI and the serving app; without it they keep
    PNG frames or answer an npz)."""
    found = []
    for name in ("transformers", "safetensors", "PIL", "cv2", "imageio",
                 "imageio_ffmpeg"):
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

        def spy(latents, **kw):
            seen.append(latents)
            return decode(latents, **kw)

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
        want = expected(**route_launches(
            True, runner.pipeline.dit.num_attention_calls * sum(STEPS),
            norms=runner.pipeline.dit.num_norm_calls * sum(STEPS)),
            conv=kernel_conv_count(runner.pipeline.vae.decoder) * windows)
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
        gc.collect()
        torch.cuda.empty_cache()
        # the serving app and the extraction tool on the same checkpoint
        http_serving(dev, paths)
        latent_extraction(pipe.vae, dev, paths)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return r


def http_get(url: str):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.headers["Content-Type"], r.read()


def http_post(url: str, req: dict):
    r = urllib.request.Request(url, data=json.dumps(req).encode(),
                               method="POST",
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=600) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def seeded_png(dev, seed: int) -> str:
    """A smooth 384x640 image from its own generator, as base64 PNG."""
    from PIL import Image

    gen = torch.Generator(dev).manual_seed(seed)
    img = ((smooth_video(gen, dev, 1, HEIGHT, WIDTH)[0, 0] + 1) * 127.5
           ).round().to(torch.uint8).cpu().numpy()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def http_serving(dev, paths):
    """The port's serving app on phase 8b's checkpoint: its
    ``ThreadingHTTPServer`` on 127.0.0.1 and a free port, in a thread;
    ``GET /healthz``; one T2V ``POST /generate`` at temp 1 and the app's
    default steps while ``/progress`` is polled, its frames equal bit for
    bit to ``pipeline.generate`` on the same prompt features and seed (both
    bodies decoded the same way); one I2V request with a seeded base64 PNG
    at temp 2. Each request's K1 and K5 launches must be the predicted
    counts."""
    t_phase = time.perf_counter()
    app = serve_app.ServingApp(argparse.Namespace(
        model_path=CKPT_DIR, variant=CKPT_VARIANT, model_name="pyramid_flux"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(text_encoder, "_load_tokenizer", hash_tokenizers):
        pipe = app.build_pipeline()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    server = serve_app.make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(http_get(url + "/healthz")[2])
        if health != {"status": "ok", "devices": 1,
                      "variants_loaded": [CKPT_VARIANT]}:
            raise AssertionError(f"/healthz answered {health}")
        polls, done = [], threading.Event()

        def poll():
            while not done.wait(0.25):
                polls.append(json.loads(http_get(url + "/progress")[2]))

        req = {"prompt": TEXT_PROMPT, "temp": HTTP_T2V_TEMP,
               "height": HEIGHT, "width": WIDTH, "seed": SEED}
        poller = threading.Thread(target=poll)
        poller.start()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            status, ctype, body = http_post(url + "/generate", req)
        finally:
            done.set()
            poller.join(timeout=60)
        t2v_wall = time.perf_counter() - t0
        paths["HTTP serving, T2V"] = launched = launch_counts()
        final = json.loads(http_get(url + "/progress")[2])
        frames = frames_from_bytes(body, ctype)
        te = app.text_encoder
        ref = pipe.generate(
            torch.Generator(dev).manual_seed(SEED),
            *te(TEXT_PROMPT + serve_app.PROMPT_SUFFIX),
            *te(serve_app.NEGATIVE_PROMPT), height=HEIGHT, width=WIDTH,
            temp=HTTP_T2V_TEMP, num_inference_steps=20,
            video_num_inference_steps=10, guidance_scale=7.0,
            video_guidance_scale=5.0, output_type="pixels")
        ref = frames_from_bytes(*video_bytes(ref[0].cpu().numpy()))
        forwards = 3 * 20  # the app's default steps, temp 1
        windows = len(vae_model._window_starts(HTTP_T2V_TEMP,
                                               DECODE_WINDOW, 1))
        want = expected(**route_launches(
            True, pipe.dit.num_attention_calls * forwards,
            norms=pipe.dit.num_norm_calls * forwards),
            conv=kernel_conv_count(pipe.vae.decoder) * windows)
        t2v = dict(request="HTTP T2V", status=status, content_type=ctype,
                   frames=list(frames.shape), wall_s=t2v_wall,
                   bit_equal_to_generate=bool(np.array_equal(frames, ref)),
                   progress_polls=len(polls),
                   polls_running=sum(p.get("status") == "running"
                                     for p in polls),
                   final_progress={k: final.get(k) for k in
                                   ("status", "phase", "unit", "units")},
                   launches=launched, expected_launches=want)
        log("request " + json.dumps(t2v))
        if not t2v["bit_equal_to_generate"]:
            diff = np.abs(frames.astype(np.int16) - ref.astype(np.int16))
            raise AssertionError(f"HTTP T2V frames differ from generate: "
                                 f"max {diff.max()}, {(diff > 0).mean()} "
                                 f"of values")
        if (status != 200 or frames.shape != (1, HEIGHT, WIDTH, 3)
                or final.get("status") != "done"
                or final.get("unit") != final.get("units")):
            raise AssertionError(f"HTTP T2V request: {t2v}")
        if launched != want:
            raise AssertionError(f"HTTP T2V launches {launched}, expected "
                                 f"{want}")

        req = {"prompt": "a red kite over a beach at dawn",
               "temp": HTTP_I2V_TEMP, "height": HEIGHT, "width": WIDTH,
               "seed": SEED, "image": seeded_png(dev, SEED + 9)}
        reset_launch_counts()
        t0 = time.perf_counter()
        status, ctype, body = http_post(url + "/generate", req)
        i2v_wall = time.perf_counter() - t0
        paths["HTTP serving, I2V"] = launched = launch_counts()
        frames = frames_from_bytes(body, ctype)
        forwards = (HTTP_I2V_TEMP - 1) * 3 * 10
        windows = len(vae_model._window_starts(HTTP_I2V_TEMP,
                                               DECODE_WINDOW, 1))
        want = expected(**route_launches(
            True, pipe.dit.num_attention_calls * forwards,
            norms=pipe.dit.num_norm_calls * forwards), conv=(
            kernel_conv_count(pipe.vae.encoder)
            + kernel_conv_count(pipe.vae.decoder) * windows))
        i2v = dict(request="HTTP I2V", status=status, content_type=ctype,
                   frames=list(frames.shape), wall_s=i2v_wall,
                   frame_std=float(frames.std()), launches=launched,
                   expected_launches=want)
        log("request " + json.dumps(i2v))
        shape = (1 + 8 * (HTTP_I2V_TEMP - 1), HEIGHT, WIDTH, 3)
        if status != 200 or frames.shape != shape or frames.std() == 0:
            raise AssertionError(f"HTTP I2V request: {i2v}")
        if launched != want:
            raise AssertionError(f"HTTP I2V launches {launched}, expected "
                                 f"{want}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    log(f"HTTP serving: pipeline and text encoders loaded in {load_s:.1f} "
        f"s, T2V {t2v_wall:.3f} s, I2V {i2v_wall:.3f} s wall per request, "
        f"phase {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    del app, pipe, te
    gc.collect()
    torch.cuda.empty_cache()


def write_clip(path: str, video: torch.Tensor) -> None:
    """Pixels [T, H, W, 3] in [-1, 1] as an MJPG clip (cv2)."""
    import cv2

    t, h, w, _ = video.shape
    frames = ((video + 1) * 127.5).round().to(torch.uint8).cpu().numpy()
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (w, h))
    for f in frames:
        out.write(np.ascontiguousarray(f[:, :, ::-1]))  # RGB -> BGR
    out.release()


def latent_extraction(vae, dev, paths):
    """The extraction tool on phase 8b's checkpoint: two seeded clips of
    121 frames at 384x640, ``--world 2`` for both ranks in turn, then once
    ``--tile`` over both; the rows and file names as the JAX tool writes
    them, every latent equal to ``chunk_encode`` (or ``tiled_encode``) and
    ``gaussian_sample`` of the same frames by ``vae`` (the checkpoint's
    weights, bit for bit) on the tool's generator, and the K5 launches one
    per admitted encoder conv, window and tile. Without cv2 the tool's
    per-clip function runs on the seeded pixels and the video decode is
    bypassed (said in the log)."""
    try:
        import cv2  # noqa: F401
        decode = True
    except ImportError:
        decode = False
    t_phase = time.perf_counter()
    shutil.rmtree(EXTRACT_DIR, ignore_errors=True)
    os.makedirs(EXTRACT_DIR)
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    clips = [smooth_video(gen, dev, EXTRACT_FRAMES, HEIGHT, WIDTH)[0]
             for _ in range(EXTRACT_CLIPS)]
    items = []
    for i, clip in enumerate(clips):
        item = {"video": os.path.join(EXTRACT_DIR, f"clip{i}.avi"),
                "text": f"clip {i}"}
        if decode:
            write_clip(item["video"], clip)
        items.append(item)
    anno = os.path.join(EXTRACT_DIR, "videos.jsonl")
    with open(anno, "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in items)
    per_window = kernel_conv_count(vae.encoder)
    windows = len(vae_model._window_starts(EXTRACT_FRAMES, ENCODE_WINDOW))
    stride = int(EXTRACT_TILE * 0.75)
    tiles = len(range(0, HEIGHT, stride)) * len(range(0, WIDTH, stride))
    runs = {"world 2": [(r, 2, 0) for r in range(2)],
            "tiled": [(0, 1, EXTRACT_TILE)]}
    results = []
    try:
        for name, ranks in runs.items():
            reset_launch_counts()
            t0 = time.perf_counter()
            got = {}
            for rank, world, tile in ranks:
                out_dir = os.path.join(EXTRACT_DIR, name.replace(" ", ""))
                out_anno = os.path.join(out_dir, f"anno{rank}.jsonl")
                if decode:
                    extract_video_vae_latents.main([
                        "--model_path", CKPT_DIR, "--anno_file", anno,
                        "--output_dir", out_dir, "--output_anno", out_anno,
                        "--rank", str(rank), "--world", str(world),
                        "--tile", str(tile), "--num_frames",
                        str(EXTRACT_FRAMES), "--height", str(HEIGHT),
                        "--width", str(WIDTH), "--window_size",
                        str(ENCODE_WINDOW)])
                    with open(out_anno) as f:
                        rows = [json.loads(x) for x in f]
                    for row in rows:
                        got[row["latent"]] = (row, np.load(row["latent"]))
                else:  # the per-clip function on the seeded pixels
                    g = torch.Generator(dev).manual_seed(0)
                    for i, item in enumerate(items[rank::world]):
                        path = os.path.join(out_dir,
                                            f"latent_{rank}_{i:07d}.npy")
                        got[path] = ({**item, "latent": path},
                                     extract_video_vae_latents.encode_clip(
                                         vae, clips[rank + i * world].cpu()
                                         .numpy(), g, ENCODE_WINDOW, tile))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = launch_counts()
            paths[f"latent extraction ({name})"] = launched
            per_clip = per_window * windows * (tiles if ranks[0][2] else 1)
            want = expected(conv=per_clip * EXTRACT_CLIPS)
            # what the JAX tool writes: items[rank::world], each with its
            # latent latent_<rank>_<i>.npy
            names, errs = [], []
            for rank, world, tile in ranks:
                g = torch.Generator(dev).manual_seed(0)
                for i, item in enumerate(items[rank::world]):
                    path = os.path.join(
                        EXTRACT_DIR, name.replace(" ", ""),
                        f"latent_{rank}_{i:07d}.npy")
                    names.append(os.path.basename(path))
                    row, latent = got[path]
                    if row != {**item, "latent": path}:
                        raise AssertionError(f"extraction row {row}")
                    if decode:
                        video, _ = tool_frames(item)
                        x = torch.from_numpy(video)[None].to(dev)
                    else:
                        x = clips[rank + i * world][None]
                    with torch.no_grad():
                        moments = (vae_model.tiled_encode(
                            vae, x, tile, temporal_chunk=True,
                            window_size=ENCODE_WINDOW) if tile else
                            vae_model.chunk_encode(vae, x, ENCODE_WINDOW))
                    ref = vae_model.gaussian_sample(moments, g)[0]
                    ref = ref.float().cpu().numpy()
                    errs.append(float(np.abs(latent - ref).max()))
                    if latent.shape != (1 + (EXTRACT_FRAMES - 1) // 8,
                                        HEIGHT // 8, WIDTH // 8,
                                        vae.config.latent_channels):
                        raise AssertionError(f"latent {latent.shape}")
            r = dict(run=name, video_decode=decode, clips=len(got),
                     files=sorted(names), seconds=seconds,
                     seconds_per_clip=seconds / EXTRACT_CLIPS,
                     max_abs_diff_to_encode=max(errs), launches=launched,
                     expected_launches=want)
            log("latent extraction " + json.dumps(r))
            if max(errs) != 0.0:
                raise AssertionError(f"extracted latents differ from "
                                     f"chunk_encode + gaussian_sample: {r}")
            if launched != want:
                raise AssertionError(f"extraction launches {launched}, "
                                     f"expected {want}")
            results.append(r)
    finally:
        shutil.rmtree(EXTRACT_DIR, ignore_errors=True)
    log(f"latent extraction: {time.perf_counter() - t_phase:.1f} s"
        f"{'' if decode else ' (no cv2: the video decode was bypassed)'} "
        f"({card_line()})")
    return results


def tool_frames(item):
    """The clip's frames as the tool decodes them."""
    from pyramid_flow_tpu_torch.data.datasets import VideoFrameProcessor
    return VideoFrameProcessor(EXTRACT_FRAMES, (HEIGHT, WIDTH))(
        item["video"])


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

    def spy(latents, **kw):
        seen.append(latents)
        return decode(latents, **kw)

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
    want = expected(**route_launches(
        True, pipe.dit.num_attention_calls * sum(STEPS),
        norms=pipe.dit.num_norm_calls * sum(STEPS)),
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


# ------------------------------------------------------- multi-rank phases
# Each runs in child processes of this script (``--child NAME``), which
# join a process group of their own: the card's gloo on CUDA tensors for
# two ranks sharing the card (NCCL refuses two ranks on one device), or
# NCCL for a world of one. The parent writes what they compare with into
# PAR_DIR first, and reads their results back from there.


def child_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK="0", MASTER_ADDR="localhost",
                MASTER_PORT=str(port))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_children(name: str, world: int, backend: str) -> list:
    """``world`` children running phase ``name`` on ``backend``; returns
    each rank's result. A child that fails, or outlives CHILD_TIMEOUT,
    fails the run; every child is stopped before this returns."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", name,
         "--backend", backend], env=child_env(r, world, port))
        for r in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase {name} outlived "
                                     f"{CHILD_TIMEOUT} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"phase {name}: ranks exited {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(PAR_DIR, f"{name}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def rank_log(msg):
    log(f"[rank {torch.distributed.get_rank()}] {msg}")


def gloo_question(dev) -> dict:
    """Whether the group's backend carries, on CUDA tensors, what the
    parallel paths need: all_to_all_single, all_gather, the halo exchange
    with its gradient, and FSDP2's all-gather and reduce-scatter (a step
    of a fully sharded two-layer model)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    world, rank = dist.get_world_size(), dist.get_rank()
    ops = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            ops[name] = "ok"
        except Exception as e:  # reported to the parent, which decides
            ops[name] = f"{type(e).__name__}: {str(e)[:200]}"

    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    attempt("all_to_all_single", lambda: dist.all_to_all_single(
        torch.empty_like(x), x))
    attempt("all_gather", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(world)], x))

    def halo():
        f = torch.full((1, 4, 2, 2, 1), float(rank + 1), device=dev,
                       requires_grad=True)
        front = previous_frames(f, 2, dist.group.WORLD)
        want = 0.0 if rank == 0 else float(rank)
        assert bool((front == want).all()), front
        front.sum().backward()
        assert f.grad is not None

    attempt("halo_exchange", halo)

    def fsdp():
        mesh = init_device_mesh("cuda", (world,))
        m = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 8)).to(dev)
        for layer in m:
            fully_shard(layer, mesh=mesh)
        fully_shard(m, mesh=mesh)
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3)
        m(torch.randn(4, 64, device=dev)).sum().backward()
        opt.step()

    attempt("fsdp2_all_gather_reduce_scatter", fsdp)
    rank_log("collectives on CUDA tensors: " + json.dumps(ops))
    return {"ops": ops}


def sp_attention_phase(dev, mesh) -> dict:
    """``sp_flash_attention`` over the sp ranks at the stage-2 timed layout
    (B=2, H=24, D=64, causal, bounded) against one rank's
    ``flash_attention`` on the whole sequence: the output, the lse (through
    the same all_to_all and the forward kernel) and the three gradients.
    Each head runs the same kernel over the same keys, so they agree bit
    for bit. Launches of the sp call alone."""
    group = mesh.get_group("sp")
    sp = group.size()
    r = group.rank()
    gen = torch.Generator(dev).manual_seed(SEED + 20)
    meta_pipe = PyramidFlowPipeline(None, device=dev)
    _, t = layout_time_ids(meta_pipe, 384, 640, 15, 2, dev)
    pad = -t.shape[1] % (sp * 128)  # the DiT's own padding under sp
    t = F.pad(t, (0, pad), value=fa.INVALID_TIME).contiguous()
    L = t.shape[1]
    q, k, v = (rms_normal((B, H, L, D), gen, dev) for _ in range(3))
    valid = (t != fa.INVALID_TIME)[:, None, :, None]
    do = (torch.randn((B, H, L, D), generator=gen, device=dev)
          * valid).bfloat16()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref = fa.flash_attention(*leaves, t, causal=True, bounded=True)
    o_ref.backward(do)
    _, lse_ref = fa.flash_fwd_cuda(q, k, v, t, t, causal=True,
                                   sm_scale=D ** -0.5, bounded=True)
    sl = slice(r * L // sp, (r + 1) * L // sp)
    shards = [x[:, :, sl].clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    reset_launch_counts()
    o = sp_flash_attention(*shards, t, group, causal=True, bounded=True)
    o.backward(do[:, :, sl].contiguous())
    torch.cuda.synchronize()
    launched = launch_counts()
    heads = slice(r * H // sp, (r + 1) * H // sp)
    qa, ka, va = (par_comm.all_to_all(x[:, :, sl].contiguous(), group, 1, 2)
                  .contiguous() for x in (q, k, v))
    _, lse = fa.flash_fwd_cuda(qa, ka, va, t, t, causal=True,
                               sm_scale=D ** -0.5, bounded=True)
    vrow = valid[:, :, sl]

    def err(a, b, mask=None):
        d = (a.float() - b.float()).abs()
        return (d * mask if mask is not None else d).max().item()

    vl = valid[:, 0, :, 0]
    res = dict(layout=TIMED_LAYOUT, L=L, sp=sp, heads_per_rank=H // sp,
               max_abs_err_o=err(o, o_ref[:, :, sl], vrow),
               max_abs_err_lse=err(lse.masked_fill(~vl[:, None], 0),
                                   lse_ref[:, heads].masked_fill(
                                       ~vl[:, None], 0)),
               max_abs_err_dq=err(shards[0].grad, leaves[0].grad[:, :, sl]),
               max_abs_err_dk=err(shards[1].grad, leaves[1].grad[:, :, sl]),
               max_abs_err_dv=err(shards[2].grad, leaves[2].grad[:, :, sl]),
               a2a_bytes_per_attention=4 * a2a_bytes(shards[0], group),
               launches=launched)
    with torch.no_grad():
        res["sp_fwd_ms"] = cuda_ms(lambda: sp_flash_attention(
            *shards, t, group, causal=True, bounded=True), 5)
        res["one_rank_fwd_ms"] = cuda_ms(lambda: fa.flash_attention(
            q, k, v, t, causal=True, bounded=True), 5)
    worst = max(v for k_, v in res.items() if k_.startswith("max_abs_err"))
    res["bit_equal"] = worst == 0
    rank_log(f"SP attention ({card_line()}) " + json.dumps(res))
    if launched != expected(1, 1):
        raise AssertionError(f"SP attention launches {launched}")
    gmax = max(x.grad.abs().max().item() for x in leaves)
    if not (res["max_abs_err_o"] <= O_ATOL
            and res["max_abs_err_lse"] <= LSE_ATOL
            and max(res[f"max_abs_err_d{n}"] for n in "qkv")
            <= GRAD_REL * gmax):
        raise AssertionError(f"SP attention off one rank's: {res}")
    return {"result": res, "launches": launched}


def sp_serving_phase(dev, mesh) -> dict:
    """The release miniFLUX and VAE (bf16, weights from SEED + 21, the same
    on every rank) with the DiT sequence-parallel over the sp ranks: one
    forward held to the sp=1 forward of the same rank on the same inputs
    and, on rank 0, both anchored to the same DiT in fp32 on the plain
    route (the SP forward within 1.1x of the sp=1 forward's distance to
    fp32; the bf16 plain route's distance printed beside them), then one
    T2V request at 384x640, temp 1, SP_SERVE_STEPS, and the same request at
    sp=1 on the same draws."""
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    t0 = time.perf_counter()
    dit = PyramidFluxTransformer(FluxConfig(), dtype=torch.bfloat16,
                                 device=dev, mesh=mesh)
    randomize_(dit, gen)
    vae = CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device=dev)
    randomize_(vae, gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    meta_pipe = PyramidFlowPipeline(None, device=dev)
    inputs, lat_time = dit_inputs(meta_pipe, dev, gen, dit, torch.bfloat16)
    valid = lat_time != fa.INVALID_TIME
    with torch.no_grad():
        out_sp = dit(*inputs)
        dit.set_mesh(None)
        out_1 = dit(*inputs)
        anchor = {}
        if torch.distributed.get_rank() == 0:
            # the fp32 anchor (one rank: every rank's output is the whole)
            with plain_route():
                out_p = dit(*inputs)[:, valid]
            out_32 = fp32_forward(dit, inputs)[:, valid]
            anchor = dict(sp_vs_fp32=rel_l2(out_sp[:, valid], out_32),
                          sp1_vs_fp32=rel_l2(out_1[:, valid], out_32),
                          plain_vs_fp32=rel_l2(out_p, out_32))
            del out_p, out_32
        dit.set_mesh(mesh)
    fwd_rel = rel_l2(out_sp[:, valid], out_1[:, valid])
    cfg = dit.config
    emb = torch.randn((1, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                      device=dev).bfloat16()
    mask = (text_time(dev) == 0)[None]
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen,
                         device=dev).bfloat16()
    pipe = PyramidFlowPipeline(dit, vae, dtype=torch.bfloat16, device=dev)

    def request():
        return pipe.generate(
            torch.Generator(dev).manual_seed(SEED + 1), emb, mask, pooled,
            emb * 0, mask, pooled * 0, height=HEIGHT, width=WIDTH,
            temp=SP_SERVE_TEMP, num_inference_steps=SP_SERVE_STEPS,
            video_num_inference_steps=SP_SERVE_STEPS, guidance_scale=7.0,
            video_guidance_scale=5.0, output_type="pixels")

    # each forward's shard of this rank: its text and image tokens
    shards, split = [], par_sp.SeqShard.split

    def spy(shard, ctx, x):
        shards.append((shard.text_local, shard.chunk - shard.text_local))
        return split(shard, ctx, x)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(par_sp.SeqShard, "split", spy):
        frames_sp = request()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    dit.set_mesh(None)
    frames_1 = request()
    dit.set_mesh(mesh)
    diff = (frames_sp.float() - frames_1.float()).abs()
    forwards = sum(SP_SERVE_STEPS)
    windows = len(vae_model._window_starts(SP_SERVE_TEMP, DECODE_WINDOW, 1))
    if len(shards) != forwards:
        raise AssertionError(f"SP shards {shards}: {forwards} forwards")
    # K8 launches only on rows: where this rank's text (image) shard is
    # empty, the dual blocks' text (image) stream runs on no rows
    text_norms, image_norms = (
        sum(getattr(blk, name).NORM_CALLS for blk in dit.transformer_blocks)
        for name in ("norm1_context", "norm1"))
    norms = sum(dit.num_norm_calls - (0 if text else text_norms)
                - (0 if image else image_norms) for text, image in shards)
    want = expected(**route_launches(True, dit.num_attention_calls
                                     * forwards, norms=norms),
                    conv=kernel_conv_count(vae.decoder) * windows)
    res = dict(card=card_line(), sp=group_size(mesh, "sp"),
               steps=SP_SERVE_STEPS, temp=SP_SERVE_TEMP,
               models_built_s=build_s, dit_forward_rel_l2=fwd_rel,
               **anchor,
               wall_s=wall, dit_s=pipe.last_dit_seconds,
               decode_s=pipe.last_decode_seconds, peak_mem_gb=peak,
               k1_launches=launched["flash_fwd"],
               frames=list(frames_sp.shape),
               frames_mean_abs_diff=diff.mean().item(),
               frames_max_abs_diff=diff.max().item(),
               shards=shards, launches=launched)
    rank_log("SP serving " + json.dumps(res))
    if fwd_rel > DIT_REL_L2:
        raise AssertionError(f"SP DiT forward off the sp=1 forward: {res}")
    if anchor and not anchor["sp_vs_fp32"] <= 1.1 * anchor["sp1_vs_fp32"]:
        raise AssertionError(f"SP DiT forward further from fp32 than the "
                             f"sp=1 forward: {res}")
    shape = (1, 1 + 8 * (SP_SERVE_TEMP - 1), HEIGHT, WIDTH, 3)
    if (tuple(frames_sp.shape) != shape or frames_sp.dtype != torch.uint8
            or frames_sp.min() == frames_sp.max()):
        raise AssertionError(f"SP frames {tuple(frames_sp.shape)} "
                             f"{frames_sp.dtype}, expected {shape} uint8, "
                             "not constant")
    if launched != want:
        raise AssertionError(f"SP serving launches {launched}, expected "
                             f"{want}")
    del pipe, dit, vae
    gc.collect()
    torch.cuda.empty_cache()
    return {"result": res, "launches": launched}


def group_size(mesh, dim: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(dim)]


def par_train_dit(dev, mesh=None, depth=PAR_TRAIN_DEPTH,
                  batch_size=TRAIN_BATCH):
    """The cut-depth full-width training DiT (fp32, remat) with weights from
    SEED + 22, its batch (the CLI's default shape) and its draws: the same
    in the parent's one-device reference and on every rank."""
    gen = torch.Generator(dev).manual_seed(SEED + 22)
    dual, single = depth
    cfg = FluxConfig(num_layers=dual, num_single_layers=single)
    dit = PyramidFluxTransformer(cfg, dtype=torch.float32, device=dev,
                                 remat=True, mesh=mesh)
    randomize_(dit, gen)
    zero_output_(dit)
    batch = training_batch(cfg, dev, gen, batch_size)
    return dit, batch


def par_train_state(dit):
    return create_train_state(dit, TrainConfig(
        learning_rate=5e-5, weight_decay=1e-4, max_grad_norm=1.0,
        lr_schedule=cosine_schedule(5e-5, 1e-6, 1000, 10, 1000)))


def par_train_steps(dit, batch, dev, mesh=None, n_steps=PAR_TRAIN_STEPS,
                    accum_steps=1):
    """``n_steps`` train steps of ``dit`` on its rows of ``batch``: the
    steps' metrics and seconds, and the train state after them."""
    state = par_train_state(dit)
    step_fn = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler(),
                              (1, 2, 1), True, 1, 1 / 3, cfg_rate=0.1,
                              accum_steps=accum_steps,
                              compute_dtype=torch.bfloat16, mesh=mesh)
    draws = GeneratorDraws(torch.Generator(dev).manual_seed(SEED))
    index, count = data_rank(mesh)
    per = next(iter(batch.values())).shape[0] // count
    local = {k: v[index * per:(index + 1) * per] for k, v in batch.items()}
    steps = []
    for _ in range(n_steps):
        units = tuple(sample_stage_length(0, state.step, 3, 31, 1, 8,
                                          max_units=TRAIN_FRAMES))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, local, draws, units)
        torch.cuda.synchronize()
        steps.append(dict(units=units, loss=m["train/loss"],
                          grad_norm=m["train/grad_norm"],
                          applied=m["train/applied"],
                          seconds=time.perf_counter() - t0))
    return steps, state


def par_train_reference(dev, accum_steps=1) -> list:
    """The parent's one-device steps of the cut-depth DiT, which the
    sharded steps are held to; with ``accum_steps`` 2, the accumulated
    step of the shallower DiT on the global batch of 8."""
    if accum_steps == 1:
        dit, batch = par_train_dit(dev)
        n, what = PAR_TRAIN_STEPS, "sharded-train"
    else:
        dit, batch = par_train_dit(dev, None, PAR_ACCUM_DEPTH,
                                   PAR_ACCUM_BATCH)
        n, what = 1, "accumulated sharded-train"
    torch.cuda.reset_peak_memory_stats(dev)
    steps, state = par_train_steps(dit, batch, dev, n_steps=n,
                                   accum_steps=accum_steps)
    log(f"{what} reference, one device ({card_line()}): "
        f"{json.dumps(steps)}, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    del dit, batch, state
    gc.collect()
    torch.cuda.empty_cache()
    return steps


def sharded_train_phase(dev, shape, n_steps, reference) -> dict:
    """``n_steps`` train steps of the cut-depth DiT on a (dp, fsdp, sp) mesh
    of ``shape`` with FSDP2, each rank on its rows: loss and gradient norm
    held to the one-device steps, launches, seconds and peak memory per
    rank."""
    mesh = make_mesh(MeshConfig(*shape), "cuda")
    dit, batch = par_train_dit(dev, mesh)
    stats = {}
    param_sharding(dit, mesh, min_shard_dim=1024, stats_out=stats,
                   verbose=False)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    steps, state = par_train_steps(dit, batch, dev, mesh, n_steps)
    launched = launch_counts()
    attentions = dit.num_attention_calls * 3 * n_steps
    res = dict(card=card_line(), mesh=dict(zip(("dp", "fsdp", "sp"), shape)),
               depth=PAR_TRAIN_DEPTH, steps=steps, reference=reference,
               rule_fraction=stats["rule_fraction"],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches=launched)
    rank_log("sharded train " + json.dumps(res))
    for got, ref in zip(steps, reference):
        if not (abs(got["loss"] - ref["loss"]) <= PAR_LOSS_REL * ref["loss"]
                and abs(got["grad_norm"] - ref["grad_norm"])
                <= PAR_GNORM_REL * ref["grad_norm"]):
            raise AssertionError(f"sharded step off the one-device step: "
                                 f"{got} vs {ref}")
    if launched != expected(2 * attentions, attentions):
        raise AssertionError(f"sharded train launches {launched}")
    del dit, batch, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"result": res, "launches": launched}


def states_equal(a, b) -> bool:
    """Whether two train-state dicts hold the same keys and values, every
    tensor equal bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(states_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(states_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    return a == b


def host_state(state) -> dict:
    """The train state made whole on the host, on every rank: parameters,
    EMA and AdamW state keyed by parameter name, the param groups' settings
    and the counts. A DTensor's local shard is copied to the CPU and
    gathered over gloo there, on a CPU mesh of the same ranks: gloo's
    all_gather of CUDA tensors (``TrainState.state_dict``'s gather, a
    functional collective) crashes the process with two ranks on one card
    (a segfault, on an H100 with torch 2.11); on NCCL that route works."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    meshes = {}

    def whole(t):
        if not isinstance(t, DTensor):
            return t.detach().cpu() if isinstance(t, torch.Tensor) else t
        mesh = t.device_mesh
        key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape))
        if key not in meshes:
            meshes[key] = DeviceMesh("cpu", mesh.mesh,
                                     mesh_dim_names=mesh.mesh_dim_names)
        return DTensor.from_local(
            t.to_local().detach().cpu(), meshes[key], t.placements,
            run_check=False, shape=t.shape, stride=t.stride()).full_tensor()

    names = {id(p): n for n, p in state.model.named_parameters()}
    return {
        "counts": (state.step, state.opt_count),
        "params": {n: whole(p) for n, p in state.params.items()},
        "ema": {n: whole(t) for n, t in state.ema.items()},
        "optimizer": {names[id(p)]: {k: whole(v) for k, v in s.items()}
                      for p, s in state.optimizer.state.items()},
        "groups": [{k: v for k, v in g.items() if k != "params"}
                   for g in state.optimizer.param_groups]}


def accum_dcp_phase(dev, world, reference) -> dict:
    """One ``accum_steps=2`` step of the 2 + 4-block DiT on a (1, world,
    1) mesh over the global batch of 8 (each rank holds one micro-batch
    whole and none of the other), held to the parent's one-device
    accumulated step; then the state saved with
    ``torch.distributed.checkpoint`` (each rank its shards) and restored on
    a fresh (1, 1, world) state, which, gathered (``host_state``), must
    equal the saved state gathered, exactly. Bytes and seconds printed."""
    import torch.distributed as dist

    mesh = make_mesh(MeshConfig(1, world, 1), "cuda")
    dit, batch = par_train_dit(dev, mesh, PAR_ACCUM_DEPTH, PAR_ACCUM_BATCH)
    param_sharding(dit, mesh, min_shard_dim=1024, verbose=False)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    steps, state = par_train_steps(dit, batch, dev, mesh, 1,
                                   accum_steps=PAR_ACCUM_STEPS)
    launched = launch_counts()
    attentions = dit.num_attention_calls * 3 * PAR_ACCUM_STEPS
    want = expected(2 * attentions, attentions)
    saved = host_state(state)
    ckpt = os.path.join(PAR_DIR, "dcp")
    dist.barrier()
    t0 = time.perf_counter()
    state.save_sharded(ckpt)
    dist.barrier()
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    files = sorted(os.listdir(ckpt))
    del dit, state
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(MeshConfig(1, 1, world), "cuda")
    dit, _ = par_train_dit(dev, mesh, PAR_ACCUM_DEPTH, PAR_ACCUM_BATCH)
    param_sharding(dit, mesh, min_shard_dim=1024, verbose=False)
    resumed = par_train_state(dit)
    dist.barrier()
    t0 = time.perf_counter()
    resumed.load_sharded(ckpt)
    dist.barrier()
    load_s = time.perf_counter() - t0
    again = host_state(resumed)
    exact = states_equal(saved, again)
    res = dict(card=card_line(), depth=PAR_ACCUM_DEPTH,
               global_batch=PAR_ACCUM_BATCH, accum_steps=PAR_ACCUM_STEPS,
               mesh={"dp": 1, "fsdp": world, "sp": 1}, steps=steps,
               reference=reference, launches=launched,
               expected_launches=want,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               dcp_files=files, dcp_bytes=nbytes, dcp_save_s=save_s,
               dcp_resume_mesh={"dp": 1, "fsdp": 1, "sp": world},
               dcp_load_s=load_s, resumed_state_equal=exact)
    rank_log("accumulated sharded step and DCP " + json.dumps(res))
    got, ref = steps[0], reference[0]
    if not (abs(got["loss"] - ref["loss"]) <= PAR_LOSS_REL * ref["loss"]
            and abs(got["grad_norm"] - ref["grad_norm"])
            <= PAR_GNORM_REL * ref["grad_norm"]):
        raise AssertionError(f"accumulated sharded step off the one-device "
                             f"step: {got} vs {ref}")
    if launched != want:
        raise AssertionError(f"accumulated sharded step launches {launched}")
    if not exact:
        raise AssertionError("the DCP resume differs from the saved state")
    del dit, resumed, saved, again
    gc.collect()
    torch.cuda.empty_cache()
    return {"result": res, "launches": launched}


def cp_nets(dev):
    """The GAN-VAE nets of phase 11 (fp32 VAE, random frozen LPIPS,
    ``PatchDiscriminator2D``; the same seeds) and the CP clip."""
    vae = CausalVideoVAE(VAEConfig(), device=dev)
    randomize_(vae, torch.Generator(dev).manual_seed(SEED + 5))
    lpips = LPIPS(device=dev)
    randomize_lpips_(lpips, torch.Generator(dev).manual_seed(SEED + 6))
    disc = PatchDiscriminator2D(device=dev)
    randomize_disc_(disc, torch.Generator(dev).manual_seed(SEED + 7))
    frames, side = CP_CLIP
    clip = smooth_video(torch.Generator(dev).manual_seed(SEED + 23), dev,
                        frames, side, side)
    return vae, lpips, disc, clip


def cp_gan_grads(dev, mesh=None, compute_dtype=torch.bfloat16):
    """The GAN step's gradients (``grads_only``, the discriminator on,
    continuation clips, under ``compute_dtype`` autocast or in fp32) on this
    rank's shard of the CP clip; with the conv calls recorded (shape and
    front frames)."""
    vae, lpips, disc, clip = cp_nets(dev)
    if mesh is not None:
        clip = time_shard(clip, mesh.get_group("cp"))
    state = create_vae_train_state(vae, disc, VAETrainConfig(disc_start=0))
    step = make_vae_train_step(vae, lpips, disc, grads_only=True,
                               compute_dtype=compute_dtype, is_init=False,
                               mesh=mesh)
    calls = []
    conv = vae_layers.causal_conv3d

    def recorder(x, weight, bias, front=None):
        calls.append((tuple(x.shape) + (weight.shape[0], front is not None),
                      front is not None and bool(front.abs().max() > 0)))
        return conv(x, weight, bias, front)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(vae_layers, "causal_conv3d", recorder):
        g, _, m = step(state, clip,
                       GeneratorDraws(torch.Generator(dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = launch_counts()
    names = sorted(g["vae"])
    flat = torch.cat([g["vae"][n].float().flatten() for n in names]
                     + [g["logvar"].float().flatten()])
    return dict(flat=flat, metrics=m, seconds=seconds, launches=launched,
                calls=calls, routed=kernel_conv_count(vae, torch.bfloat16),
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def cp_reference(dev) -> dict:
    """The parent's cp=1 steps on the whole clip, in bf16 (the conv kernel)
    and in fp32; their gradients go to PAR_DIR for rank 0 to compare with,
    as phase 11b holds the kernel route: the bf16 gradient of the GAN loss
    with random weights sits ~2.4e-1 from fp32 on any route (phase 11b)."""
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        r = cp_gan_grads(dev, compute_dtype=dtype)
        torch.save(r["flat"].cpu(), os.path.join(PAR_DIR,
                                                 f"cp1_{name}_grads.pt"))
        out[name] = dict(metrics=r["metrics"], seconds=r["seconds"],
                         peak_mem_gb=r["peak_mem_gb"])
        del r
        gc.collect()
        torch.cuda.empty_cache()
    bf16, fp32 = (torch.load(os.path.join(PAR_DIR, f"cp1_{n}_grads.pt"))
                  for n in ("bf16", "fp32"))
    out["bf16_vs_fp32"] = rel_l2(bf16, fp32)
    log(f"CP GAN-VAE reference, cp=1 ({card_line()}): clip "
        f"{[1, CP_CLIP[0], CP_CLIP[1], CP_CLIP[1], 3]} " + json.dumps(out))
    return out


def cp_gan_phase(dev, world, reference) -> dict:
    """One GAN step of the release VAE at cp=world on CP_CLIP (T/cp frames
    per rank): every admitted conv launches the conv kernel with front
    frames, nonzero on every rank but the first; rank 0 holds the whole
    gradient to the cp=1 step's by relative L2."""
    import torch.distributed as dist

    mesh = make_cp_mesh(1, world, "cuda")
    r32 = cp_gan_grads(dev, mesh, None)  # fp32: no kernel
    m32, r32 = r32["metrics"], r32["flat"]
    r = cp_gan_grads(dev, mesh)
    rank = dist.get_rank()
    fronts = [c[0][-1] for c in r["calls"]]
    nonzero = sum(c[1] for c in r["calls"])
    res = dict(card=card_line(), cp=world, clip_per_rank=[
        1, CP_CLIP[0] // world, CP_CLIP[1], CP_CLIP[1], 3],
        seconds=r["seconds"], peak_mem_gb=r["peak_mem_gb"],
        conv_launches=r["launches"]["causal_conv3d"],
        conv_calls_with_front=sum(fronts), nonzero_fronts=nonzero,
        d_weight=r["metrics"]["vae/d_weight"],
        total_loss=r["metrics"]["vae/total_loss"],
        reference_total_loss=reference["bf16"]["metrics"]["vae/total_loss"],
        fp32_d_weight=m32["vae/d_weight"],
        fp32_total_loss=m32["vae/total_loss"],
        reference_fp32_d_weight=reference["fp32"]["metrics"]["vae/d_weight"],
        reference_fp32_total_loss=reference["fp32"]["metrics"][
            "vae/total_loss"],
        launches=r["launches"])
    if rank == 0:
        ref32 = torch.load(os.path.join(PAR_DIR, "cp1_fp32_grads.pt")).to(dev)
        ref16 = torch.load(os.path.join(PAR_DIR, "cp1_bf16_grads.pt")).to(dev)
        res.update(fp32_cp_vs_fp32_cp1=rel_l2(r32, ref32),
                   bf16_cp_vs_fp32_cp1=rel_l2(r["flat"], ref32),
                   bf16_cp1_vs_fp32_cp1=reference["bf16_vs_fp32"],
                   bf16_cp_vs_bf16_cp1=rel_l2(r["flat"], ref16))
    rank_log("CP GAN-VAE " + json.dumps(res))
    want = expected(conv=r["routed"])
    if r["launches"] != want:
        raise AssertionError(f"CP GAN-VAE launches {r['launches']}, "
                             f"expected {want}")
    if not all(fronts) or nonzero != (0 if rank == 0 else len(fronts)):
        raise AssertionError(f"CP conv front frames: {len(fronts)} calls, "
                             f"{sum(fronts)} with front, {nonzero} nonzero")
    if not (r["metrics"]["vae/d_weight"] > 0
            and all(math.isfinite(v) for v in r["metrics"].values())):
        raise AssertionError(f"CP GAN-VAE metrics: {r['metrics']}")
    if rank == 0 and not (
            res["fp32_cp_vs_fp32_cp1"] <= CP_FP32_REL_L2
            and res["bf16_cp_vs_fp32_cp1"]
            <= 1.1 * res["bf16_cp1_vs_fp32_cp1"]):
        raise AssertionError(f"CP gradient off the cp=1 gradient: {res}")
    shapes = sorted({c[0] for c in r["calls"]})
    return {"result": res, "launches": r["launches"],
            "conv_shapes": [list(s) for s in shapes]}


def write_latent_anno(directory: str) -> str:
    """Four seeded latent clips at the CLI's default shape (16 frames of
    48x80, 16 channels) and their jsonl, for the training CLI."""
    rng = np.random.default_rng(SEED)
    lines = []
    for i in range(TRAIN_BATCH):
        path = os.path.join(directory, f"latent{i}.npy")
        np.save(path, rng.standard_normal((TRAIN_FRAMES, 48, 80, 16))
                .astype(np.float32))
        lines.append(json.dumps({"latent": os.path.abspath(path)}))
    anno = os.path.join(directory, "latents.jsonl")
    with open(anno, "w") as f:
        f.write("\n".join(lines) + "\n")
    return anno


def cli_train_phase(dev) -> dict:
    """One step of the training CLI at full depth on a world of one
    (NCCL, ``--fsdp 1``) with ``--classic_softmax``: FSDP2's DTensor route
    end to end on the real backend, every attention on K2 and the backward
    kernels after K2's ``lse``. The whole run's seconds, and the step's
    own (``make_train_step``'s step timed where the CLI calls it)."""
    from pyramid_flow_tpu_torch.tools import train_pyramid_flow
    from pyramid_flow_tpu_torch.training import trainer

    step_s = []  # the step's own seconds, synchronised
    make = trainer.make_train_step

    def timed_make_train_step(*args, **kw):
        step_fn = make(*args, **kw)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*a, **k)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return timed

    anno = os.path.join(PAR_DIR, "latents.jsonl")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer, "make_train_step", timed_make_train_step):
        code = train_pyramid_flow.main([
            "--anno_file", anno, "--fsdp", "1", "--epochs", "1",
            "--steps_per_epoch", "1", "--gradient_checkpointing",
            "--bound_probe_freq", "0", "--save_ckpt_freq", "1000",
            "--print_freq", "1", "--classic_softmax", "--output_dir",
            os.path.join(PAR_DIR, "cli_run")])
    torch.cuda.synchronize()
    launched = launch_counts()
    res = dict(card=card_line(), exit=code,
               seconds=time.perf_counter() - t0, step_s=step_s,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               launches=launched)
    log("[rank 0] training CLI, one rank on NCCL, --classic_softmax "
        + json.dumps(res))
    attentions = FluxConfig().num_layers + FluxConfig().num_single_layers
    if code != 0 or launched != expected(bwd=3 * attentions,
                                         classic=2 * 3 * attentions):
        raise AssertionError(f"training CLI step: {res}")
    return {"result": res, "launches": launched}


def child_main(name: str, backend: str) -> int:
    """A rank of phase ``name``: joins the group the environment names on
    ``backend``, runs the phase and writes its result to PAR_DIR."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    if name == "cli_train":  # the CLI joins the group itself
        out = cli_train_phase(dev)
        rank = 0
    else:
        dist.init_process_group(backend, init_method="env://")
        rank, world = dist.get_rank(), dist.get_world_size()
        if name == "gloo":
            out = gloo_question(dev)
        else:
            with open(os.path.join(PAR_DIR, "plan.json")) as f:
                plan = json.load(f)
            sp_mesh = make_mesh(MeshConfig(sp=world), "cuda")
            out = {"sp_attention": sp_attention_phase(dev, sp_mesh),
                   "sp_serving": sp_serving_phase(dev, sp_mesh)}
            for key, (shape, n) in plan["train_meshes"].items():
                out[key] = sharded_train_phase(dev, shape, n,
                                               plan["train_reference"])
            out["cp_gan"] = cp_gan_phase(dev, world, plan["cp_reference"])
            out["accum_dcp"] = accum_dcp_phase(dev, world,
                                               plan["accum_reference"])
        dist.barrier()
        dist.destroy_process_group()
    with open(os.path.join(PAR_DIR, f"{name}-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def parallel_phases(dev, paths: dict, conv_shapes: set) -> dict:
    """Phase 13, with the parent's models freed: the gloo question, then
    SP attention, SP serving, the sharded train steps (fsdp=2, then sp=2)
    and the CP GAN-VAE step on two ranks sharing the card where the card's
    gloo carries them (one rank on NCCL where it does not), then the
    training CLI on one NCCL rank at full depth. Adds every rank's launches
    to ``paths`` and the CP step's conv shapes to ``conv_shapes``."""
    t0 = time.perf_counter()
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    probe = run_children("gloo", PAR_WORLD, "gloo")
    failed = {k: v for r in probe for k, v in r["ops"].items() if v != "ok"}
    world, backend = ((PAR_WORLD, "gloo") if not failed else (1, "nccl"))
    log(f"gloo on CUDA tensors, two ranks on one card: "
        f"{'carries every collective' if not failed else failed}; the "
        f"multi-rank paths run on {world} rank(s) over {backend}")
    reference = par_train_reference(dev)
    accum_ref = par_train_reference(dev, PAR_ACCUM_STEPS)
    cp_ref = cp_reference(dev)
    # FSDP2's per-block gathers go through host memory over gloo (about
    # 30 s a step here): one step on that mesh
    meshes = {"train fsdp": [[1, world, 1], 1],
              "train sp": [[1, 1, world], PAR_TRAIN_STEPS]}
    with open(os.path.join(PAR_DIR, "plan.json"), "w") as f:
        json.dump({"train_meshes": meshes, "train_reference": reference,
                   "accum_reference": accum_ref, "cp_reference": cp_ref}, f)
    ranks = run_children("paths", world, backend)
    names = {"sp_attention": "SP attention", "sp_serving": "SP serving",
             "train fsdp": "sharded train (fsdp)",
             "train sp": "sharded train (sp)", "cp_gan": "CP GAN-VAE step",
             "accum_dcp": "accumulated sharded train (fsdp, accum 2)"}
    for key, label in names.items():
        paths[label] = {k: sum(r[key]["launches"][k] for r in ranks)
                        for k in launch_counts()}
    for r in ranks:
        conv_shapes.update(tuple(s) for s in r["cp_gan"]["conv_shapes"])
    write_latent_anno(PAR_DIR)
    cli = run_children("cli_train", 1, "nccl")
    paths["training CLI, classic softmax (one NCCL rank)"] = \
        cli[0]["launches"]
    log(f"multi-rank phases: {time.perf_counter() - t0:.1f} s "
        f"({card_line()})")
    return {"world": world, "backend": backend, "ranks": ranks,
            "cli": cli[0]}


# ---------------------------------------------------------- the 768p phase
# Phase 14: the release models at 768x1280 (depth not cut), the 16 GB
# class's strip decode, and the 768p tools in this process.
P768 = (768, 1280)
P768_TEMP = 2
P768_SEED = SEED + 9
# the plan of a 16 GB card with the DiT released: full-height window-2
# strips as wide as the 9216 budget allows (4 strips of 46 latent pixels)
P768_PLAN = decode_settings(True, 16.0, dit_resident=False)
P768_CLASS_GB = 16.0
TILING_ITERS = 1         # exp_vae_tiling --iters 1
DECODE_SCAN_ITERS = 3    # exp_decode_scan's default
CONV_STACK_ITERS = 6     # exp_conv_stack's default
# the largest input the fp32 plain conv takes in one call in the 768p
# phase's shape checks (elements of the widest side, front frames included)
PLAIN_CONV_ELEMENTS = 2 ** 28
# the tiling experiment's plans: (tiles, window) at the 96 x 160 latent
TILING_TILES = {"current_384px_ov8": (12, 2), "planned_48x48": (12, 2),
                "strip_h96_w46": (4, 2), "strip_h96_w58": (3, 2),
                "strip_h96_w83": (2, 2), "untiled_w2": (1, 2),
                "untiled_w1": (1, 1), "strip_w83_w1": (2, 1),
                "strip_w58_w1": (3, 1), "strip_w46_w2": (4, 2)}


def decode_launches(vae, frames: int, window: int, tiles: int = 1) -> int:
    """K5 launches of a windowed decode of ``frames`` latent frames in
    ``tiles`` tiles: one per admitted decoder conv, window and tile."""
    return (kernel_conv_count(vae.decoder) * tiles
            * len(vae_model._window_starts(frames, window, 1)))


@torch.no_grad()
def request_768p(dit, vae, dev, gen) -> dict:
    """One T2V request at 768x1280, temp 2, steps [20,20,20]/[10,10,10],
    guidance 7/5, the DiT released before a decode on ``P768_PLAN``: exact
    launches, its decode's peak memory against the 16 GB class; then the
    request's latents decoded in the plan's strips through the conv kernel,
    the plain version and fp32 (each bf16 route's distance to fp32; the
    kernel route within 1.1x of the plain route's), and untiled (the strips'
    relative L2 to it, reported)."""
    height, width = P768
    pipe = PyramidFlowPipeline(dit, vae, dtype=torch.bfloat16, device=dev)
    cfg = dit.config
    emb = torch.randn((1, TEXT_LEN, cfg.joint_attention_dim), generator=gen,
                      device=dev).bfloat16()
    mask = (text_time(dev) == 0)[None]
    pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen,
                         device=dev).bfloat16()
    seen, mem = [], {}
    decode = pipe.decode_latent

    def spy(latents, **kw):
        seen.append(latents)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mem["base"] = torch.cuda.memory_allocated(dev)
        out = decode(latents, **kw)
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated(dev)
        return out

    forwards, _ = request_shape(pipe, P768_TEMP)
    reset_launch_counts()
    with mock.patch.object(pipe, "decode_latent", spy):
        t0 = time.perf_counter()
        frames = pipe.generate(
            torch.Generator(dev).manual_seed(P768_SEED), emb, mask, pooled,
            emb * 0, mask, pooled * 0, height=height, width=width,
            temp=P768_TEMP, num_inference_steps=STEPS,
            video_num_inference_steps=VIDEO_STEPS, guidance_scale=7.0,
            video_guidance_scale=5.0, output_type="pixels",
            release_dit_before_decode=True, decode_plan=P768_PLAN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = launch_counts()
    hl, wl = height // 8, width // 8
    strip_w = P768_PLAN.px_window_budget // (2 * hl)
    tile_w, wpos = vae_model.plan_axis(wl, strip_w)
    want = expected(**route_launches(True, dit.num_attention_calls
                                     * forwards,
                                     norms=dit.num_norm_calls * forwards),
                    conv=decode_launches(vae, P768_TEMP, 2, len(wpos)))
    expect = (1, 1 + 8 * (P768_TEMP - 1), height, width, 3)
    if tuple(frames.shape) != expect or frames.dtype != torch.uint8:
        raise AssertionError(f"768p frames {tuple(frames.shape)}")
    if not torch.isfinite(seen[0]).all() or frames.min() == frames.max():
        raise AssertionError("768p request: non-finite latents or constant "
                             "frames")
    if launched != want:
        raise AssertionError(f"768p launches {launched}, expected {want}")
    vae_gb = sum(p.numel() * p.element_size()
                 for p in vae.parameters()) / 1e9
    decode_gb = (mem["peak"] - mem["base"]) / 1e9
    r = dict(request="768p", temp=P768_TEMP, plan=repr(P768_PLAN),
             strips=len(wpos), strip_latent_width=tile_w,
             dit_forwards=forwards, launches=launched, wall_s=wall,
             dit_s=pipe.last_dit_seconds, decode_s=pipe.last_decode_seconds,
             decode_working_gb=decode_gb,
             decode_with_vae_gb=decode_gb + vae_gb, class_gb=P768_CLASS_GB,
             fits_class=decode_gb + vae_gb <= P768_CLASS_GB,
             frame_std=frames.float().std().item())
    log("768p request " + json.dumps(r))
    del frames

    # the strip decode's routes, on the request's latents
    z = pipe.denormalize_latent(seen[0]).float()

    def strips(model):
        out = vae_model.tiled_decode_planned(model, z, tile_h=hl,
                                             tile_w=strip_w, window_size=2)
        torch.cuda.synchronize()
        return out

    out_k = strips(vae)
    with mock.patch.object(vae_layers, "causal_conv3d",
                           cc.causal_conv3d_reference):
        out_p = strips(vae)
    untiled = vae_model.chunk_decode(vae, z, 2)
    vae32 = copy.deepcopy(vae).float()
    out_32 = strips(vae32)
    del vae32
    if not all(torch.isfinite(o).all() for o in (out_k, out_p, out_32)):
        raise AssertionError("non-finite 768p strip decode")
    c = dict(rel_l2=rel_l2(out_k, out_p), kernel_vs_fp32=rel_l2(out_k, out_32),
             plain_vs_fp32=rel_l2(out_p, out_32),
             strips_vs_untiled=rel_l2(out_k, untiled))
    log("768p strip decode, kernel vs plain vs fp32 " + json.dumps(c))
    if not c["kernel_vs_fp32"] <= 1.1 * c["plain_vs_fp32"]:
        raise AssertionError(f"768p strip decode kernel route off: {c}")
    r.update(c)
    return r


def k1_768p_check(dit, dev, gen) -> dict:
    """K1 at profile_768p's stage-2 layout (its time ids: L plus 128 text
    tokens) against the plain fp32 version, on phase 3's inputs (q and k
    rows of RMS 1, as the qk-norm makes them; v standard normal): valid
    rows within ``O_ATOL`` and ``LSE_ATOL``. The tool's own q = k = v
    (standard normal, so each row attends mostly to itself and |o| reaches
    about 5, where one bf16 step is 0.03) is held too, to ``exp_flash_h2``'s
    limits for q = k = v at this layout (``O_TOL``, ``LSE_TOL``), and its
    error printed beside max|o|."""
    height, width = P768
    _, lat_time = profile_768p.stage_inputs(dit, height, width, 15, 2, gen)
    cfg = dit.config
    q_tool, t = profile_768p.attention_inputs(
        lat_time, cfg.num_attention_heads, cfg.attention_head_dim, gen)
    shape = tuple(q_tool.shape)
    q, k = rms_normal(shape, gen, dev), rms_normal(shape, gen, dev)
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    valid = t[0] != fa.INVALID_TIME
    errs = {}
    for name, (qq, kk, vv) in (("rms", (q, k, v)),
                               ("tool", (q_tool, q_tool, q_tool))):
        o, lse = fa.flash_fwd_cuda(qq, kk, vv, t, t, causal=True,
                                   sm_scale=cfg.attention_head_dim ** -0.5,
                                   bounded=True)
        o_ref, lse_ref = plain_attention(qq, kk, vv, t, True)
        errs[name] = ((o.float() - o_ref.float())[:, :, valid].abs()
                      .max().item(),
                      (lse - lse_ref)[:, :, valid].abs().max().item(),
                      o_ref[:, :, valid].abs().max().item())
        del o, lse, o_ref, lse_ref
    r = dict(check="K1 at profile_768p's stage-2 layout", L=t.shape[1],
             max_abs_err_o=errs["rms"][0], max_abs_err_lse=errs["rms"][1],
             tool_inputs_max_abs_err_o=errs["tool"][0],
             tool_inputs_max_abs_err_lse=errs["tool"][1],
             tool_inputs_max_abs_o=errs["tool"][2])
    log("kernel vs plain " + json.dumps(r))
    if not (r["max_abs_err_o"] <= O_ATOL
            and r["max_abs_err_lse"] <= LSE_ATOL
            and r["tool_inputs_max_abs_err_o"] < exp_flash_h2.O_TOL
            and r["tool_inputs_max_abs_err_lse"] < exp_flash_h2.LSE_TOL):
        raise AssertionError(f"K1 disagrees at the 768p layout: {r}")
    return r


def conv_shape_checks(shapes, dev, gen) -> list:
    """K5 against the fp32 plain version at each (B, T, H, W, C, Co) of
    ``shapes``, with zero and with carried front frames: finite, max|err|
    <= ``CONV_REL`` * max|ref| (not timed)."""
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
        # the plain version a few output frames at a time (frame i reads
        # input frames i - 2 .. i): at 768x1280 a whole fp32 plain conv
        # holds several 16-18 GB tensors
        step = max(1, int(PLAIN_CONV_ELEMENTS // (b * h * w * max(c, co))))
        for front in (False, True):
            y = cc.causal_conv3d_cuda(x, weight, bias,
                                      carried if front else None)
            torch.cuda.synchronize()
            xp = torch.cat([carried if front else torch.zeros_like(carried),
                            x], dim=1)
            err = scale = 0.0
            for i in range(0, t, step):
                j = min(t, i + step)
                ref = cc.causal_conv3d_reference(
                    xp[:, i + 2:j + 2].float(), weight.float(), bias.float(),
                    xp[:, i:i + 2].float())
                err = max(err, (y[:, i:j].float() - ref).abs().max().item())
                scale = max(scale, ref.abs().max().item())
                del ref
            r = dict(shape=f"{c}->{co} {h}x{w}", b=b, t=t, front=front,
                     max_abs_err=err, max_abs_ref=scale)
            del xp, y
            if not r["max_abs_err"] <= CONV_REL * r["max_abs_ref"]:
                raise AssertionError(f"conv kernel disagrees at 768p: {r}")
            results.append(r)
        del x, carried, weight, bias
        torch.cuda.empty_cache()
    log(f"conv kernel vs plain at the 768p phase's {len(results) // 2} "
        f"shapes, both front modes: largest max|err|/max|ref| "
        f"{max(r['max_abs_err'] / r['max_abs_ref'] for r in results):.3e} "
        f"(limit {CONV_REL})")
    return results


@torch.no_grad()
def vae_2d_twin(dev, gen) -> dict:
    """A release-width VAE whose blocks are all the 2D twins (bf16, random
    weights): one encode of a smooth 9-frame 256x256 clip and one decode of
    its posterior mode; finite, the expected shapes, and no K5 launch (the
    twins' convs and the 3-, 16- and 32-channel ends are library convs)."""
    cfg = VAEConfig(down_block_types=("DownEncoderBlock2D",) * 4,
                    up_block_types=("UpDecoderBlock2D",) * 4,
                    mid_block_type="UNetMidBlock2D")
    vae = CausalVideoVAE(cfg, dtype=torch.bfloat16, device=dev)
    randomize_(vae, gen)
    clip = smooth_video(gen, dev, 9, 256, 256)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moments = vae.encode(clip)
    frames = vae.decode(vae_model.gaussian_mode(moments))
    torch.cuda.synchronize()
    r = dict(params_m=sum(p.numel() for p in vae.parameters()) / 1e6,
             clip=list(clip.shape), moments=list(moments.shape),
             frames=list(frames.shape), seconds=time.perf_counter() - t0,
             launches=launch_counts())
    log("2D-twin VAE encode/decode " + json.dumps(r))
    if not (torch.isfinite(moments).all() and torch.isfinite(frames).all()):
        raise AssertionError("non-finite 2D-twin VAE output")
    # the twins' temporal convs are not causal: 9 frames -> 4 -> 2 -> 1
    # latent frame, and the decoder repeats each frame 2x three times
    if tuple(moments.shape) != (1, 1, 32, 32, 32) or \
            tuple(frames.shape) != (1, 8, 256, 256, 3):
        raise AssertionError(f"2D-twin VAE shapes {r}")
    if r["launches"] != expected():
        raise AssertionError(f"2D-twin VAE launched kernels: {r}")
    return r


def decode_scan_check(vae, dev, gen):
    """``exp_decode_scan`` on a random 17-frame 48x48 latent: the graph
    captured, its frames equal to the loop's bit for bit, and exact
    launches. Returns (the tool's result, the launches)."""
    reset_launch_counts()
    z48 = torch.randn((1, 17, 48, 48, 16), generator=gen,
                      device=dev).bfloat16() * 2.0
    scan = exp_decode_scan.run(vae, z48, DECODE_SCAN_ITERS)
    launched = launch_counts()
    if "graph" not in scan or not scan["graph"]["bit_equal"]:
        raise AssertionError(f"graph_w2 not captured, or its frames differ "
                             f"from loop_w2's: {scan}")
    # each timed form's calls decode every window (the graph's continuation
    # windows as replays), and building the graph decodes a first and a
    # continuation window eagerly; the capture launches none
    calls = 1 + DECODE_SCAN_ITERS
    per_window = kernel_conv_count(vae.decoder)
    windows = len(vae_model._window_starts(17, 2, 1))
    want = expected(conv=2 * calls * decode_launches(vae, 17, 2)
                    + 2 * per_window)
    graph = scan["graph"]
    if launched != want or graph["replays"] != calls * (windows - 1) \
            or graph["graph_conv_launches"] != per_window:
        raise AssertionError(f"exp_decode_scan launches {launched} "
                             f"(expected {want}), {graph}")
    return scan, launched


def conv_stack_check(dev, gen):
    """``exp_conv_stack`` at its shapes, with exact launches: K5 at each
    shape for its check, the timer's warm-up and the timed calls. Returns
    (the tool's rows, the launches)."""
    reset_launch_counts()
    stack = exp_conv_stack.run(dev, CONV_STACK_ITERS, gen)
    launched = launch_counts()
    want = expected(conv=len(exp_conv_stack.SHAPES) * (
        1 + exp_flash_h2.WARMUP + CONV_STACK_ITERS))
    if launched != want:
        raise AssertionError(f"exp_conv_stack launches {launched}, "
                             f"expected {want}")
    return stack, launched


def phase_768p(dev, meta_pipe, paths: dict, kgen) -> dict:
    """Phase 14, with every earlier model freed: the release miniFLUX and
    VAE (``profile_768p.build_models``) serve one 768p request on the 16 GB
    class's strip plan; ``profile_768p`` at its defaults (no sweep, K2
    timed beside K1) with K1
    held to the plain version at its stage-2 layout; ``exp_vae_tiling
    --iters 1``, ``exp_conv_stack`` and ``exp_decode_scan`` (frames bit for
    bit); the guidance-embedded miniFLUX's forward anchored to fp32; a
    release-width 2D-twin VAE. Every K5 shape of these paths is held to the
    plain version. Adds each path's launches to ``paths``."""
    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(P768_SEED)
    dit, vae = profile_768p.build_models(dev, P768_SEED)
    shapes = set()
    out = {}
    with record_conv_shapes(shapes):
        out["request"] = request_768p(dit, vae, dev, gen)
        paths["768p text-to-video (strips)"] = out["request"]["launches"]
        height, width = P768

        reset_launch_counts()
        t0 = time.perf_counter()
        fwd = profile_768p.profile_forwards(dit, height, width, 15,
                                            profile_768p.ITERS, gen)
        dec = profile_768p.profile_decode(vae, height, width,
                                          profile_768p.FRAMES, gen, dit)
        launched = launch_counts()
        calls = (exp_flash_h2.WARMUP + profile_768p.ITERS) * 3
        # the decode on this card's plan with the DiT resident: untiled at
        # 96 x 160 on a card of 48 GB or more, in the plan's windows; K2
        # timed beside K1 at each stage
        plan = decode_settings(True, device_memory_gb(dev))
        want = expected(
            calls * (dit.num_attention_calls + 1), classic=calls,
            conv=2 * decode_launches(vae, profile_768p.FRAMES,
                                     plan.untiled_window),
            qk=calls * dit.num_attention_calls,
            norm=calls * dit.num_norm_calls)
        if launched != want:
            raise AssertionError(f"profile_768p launches {launched}, "
                                 f"expected {want}")
        paths["profile_768p tool"] = launched
        out["profile"] = dict(forwards=fwd, decode=dec,
                              seconds=time.perf_counter() - t0)
        log("profile_768p " + json.dumps(out["profile"]))
        out["k1_check"] = k1_768p_check(dit, dev, kgen)
        del dit
        gc.collect()
        torch.cuda.empty_cache()

        reset_launch_counts()
        t0 = time.perf_counter()
        ballast = torch.empty(exp_vae_tiling.dit_bytes(), dtype=torch.uint8,
                              device=dev)
        z = torch.randn((1, 17) + exp_vae_tiling.LATENT + (16,),
                        generator=gen, device=dev).bfloat16() * 2.0
        tiling = exp_vae_tiling.run(vae, z, TILING_ITERS)
        del ballast
        launched = launch_counts()
        want = expected(conv=TILING_ITERS * sum(
            decode_launches(vae, 17, wnd, tiles)
            for tiles, wnd in TILING_TILES.values()))
        if launched != want or None in tiling.values():
            raise AssertionError(f"exp_vae_tiling launches {launched} "
                                 f"(expected {want}), results {tiling}")
        paths["exp_vae_tiling tool"] = launched
        out["tiling"] = dict(plans=tiling, seconds=time.perf_counter() - t0)

        out["decode_scan"], paths["exp_decode_scan tool"] = \
            decode_scan_check(vae, dev, gen)
    del vae
    gc.collect()
    torch.cuda.empty_cache()

    out["conv_stack"], paths["exp_conv_stack tool"] = conv_stack_check(
        dev, gen)
    shapes |= {(1, t, h, w, c, c, True)
               for _, t, h, w, c in exp_conv_stack.SHAPES}
    out["conv_checks"] = conv_shape_checks(shapes, dev, kgen)

    gdit = PyramidFluxTransformer(FluxConfig(guidance_embeds=True),
                                  dtype=torch.bfloat16, device=dev)
    randomize_(gdit, gen)
    guidance = torch.full((B,), 4.5, device=dev)
    out["guidance_dit"] = dit_check(gdit, meta_pipe, dev, gen,
                                    guidance=guidance)
    del gdit
    gc.collect()
    torch.cuda.empty_cache()
    out["vae_2d"] = vae_2d_twin(dev, gen)
    log(f"768p phase: {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return out


def build_libraries():
    """The six kernel libraries, one nvcc each, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        libs = {"flash_fwd": pool.submit(fa.kernel_library),
                "flash_bwd": pool.submit(fa.bwd_kernel_library),
                "causal_conv3d": pool.submit(cc.kernel_library),
                "flash_fwd_hn": pool.submit(fa.hn_kernel_library),
                "qk_norm_rope": pool.submit(qkr.kernel_library),
                "residual_norm": pool.submit(rn.kernel_library)}
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
    if "--child" in sys.argv:  # a rank of a multi-rank phase
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return child_main(args["--child"], args["--backend"])
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
    qk_checks = qk_vs_plain(dev)
    norm_checks = norm_vs_plain(dev)
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
    envelope_check(meta_pipe, dev)
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
        serve(pipe, dev, gen, "a", T2V_TEMP)
        paths["text-to-video"] = launch_counts()
        # the same request on the classic route (its features from a
        # generator of their own)
        dit.bounded_softmax = False
        reset_launch_counts()
        serve(pipe, dev, torch.Generator(dev).manual_seed(SEED + 13),
              "a, classic softmax", T2V_TEMP)
        paths["text-to-video, classic softmax"] = launch_counts()
        dit.bounded_softmax = True
        # two latent frames per unit: a second pipeline over the same models
        two_frame_units(dit, vae, dev, paths)
        image = i2v_image(gen, dev)
        reset_launch_counts()
        serve_i2v(pipe, dev, image)
        paths["image-to-video"] = launch_counts()
        # a string prompt through from_pretrained, from a checkpoint of the
        # serving models and full-width text encoders
        checkpoint_path(pipe, dev, paths)
        # the JAX bench's request last: the pipeline is then the serving
        # DiT's only holder, so that releasing it before the decode frees
        # its memory, as in bench.py
        del dit
        reset_launch_counts()
        serve(pipe, dev, gen, "b", BENCH_TEMP, bench=True)
        paths["text-to-video, the bench's request"] = launch_counts()

        # training: the serving DiT is gone; the VAE stays for raw pixels
        del pipe
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
        ema_evaluation(state, vae, dev, paths)
        _, paths["train (raw pixels)"], _ = train_raw_pixels(
            tdit, vae, state, dev, gen)
        # the full-sequence recipe on the same DiT and state
        full = full_sequence_paths(tdit, state, dev, paths)

        # the MMDiT at full width and depth, after the flux training state
        # is freed: a forward check, one request, the gradient, two steps
        del tdit, state
        gc.collect()
        torch.cuda.empty_cache()
        mmdit_paths(vae, meta_pipe, dev, gen, paths, image)
        # GAN-VAE training: an fp32-master VAE of its own under bf16 autocast
        gan_vae_paths(dev, paths)

    # the multi-rank paths, in child processes, with the models freed
    del vae
    gc.collect()
    torch.cuda.empty_cache()
    parallel_phases(dev, paths, conv_shapes)
    # the 768p phase: the release models and the 768p tools
    p768 = phase_768p(dev, meta_pipe, paths, kgen)
    log("launches by path " + json.dumps(paths))
    total = {k: sum(p[k] for p in paths.values()) for k in launch_counts()}
    unused = [k for k, n in total.items() if n == 0]
    if unused:
        raise AssertionError(f"kernels no path launched: {unused}")

    # the conv kernel at every shape the paths gave it
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
    qk_timed = next(r for r in qk_checks if r["site"] == QK_TIMED_SITE)
    norm_timed = next(r for r in norm_checks
                      if r["site"] == NORM_TIMED_SITE and "ms" in r)
    # operations of each timed call, for the rate
    conv_flops = conv_bound(*TIMED_CONV)[0]
    flops = {"flash_fwd": timed["flops"], "flash_fwd_classic": classic["flops"],
             "flash_bwd_dkv": btimed["flops_dkv"],
             "flash_bwd_dq": btimed["flops_dq"], "causal_conv3d": conv_flops,
             "flash_fwd_hn": timed["flops"]}
    def own_ms(e):
        # K3 and K4 share one ``ms``, the whole backward as the path calls
        # it; their rate and share of the bound are of their own time, and
        # so are K7's and K8's, whose wrapper calls back to back the host
        # paces
        own = (e["name"].startswith("flash_bwd")
               or e["name"] in ("qk_norm_rope", "residual_norm"))
        return e["kernel_ms"] if own and e["kernel_ms"] else e["ms"]

    log(json.dumps({"kernels": [dict(
        e, tflops=(flops[e["name"]] / own_ms(e) / 1e9 if e["name"] in flops
                   else None),
        bound_share=e["bound_ms"] / own_ms(e),
        launches_by_path={path: p[e["name"]] for path, p in paths.items()
                          if p[e["name"]]}) for e in [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pyramid_flow_tpu/ops/flash_attention.py:207",
        "launches": total["flash_fwd"],
        "max_abs_err": max([r["max_abs_err_o"] for r in checks
                            if r["bounded"]]
                           + [p768["k1_check"]["max_abs_err_o"]]
                           + [r["max_abs_err_o"] for r in full["kernels"]
                              if r["route"] == "bounded"]),
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
        "max_abs_err": max([r["max_abs_err_o"] for r in checks
                            if not r["bounded"]]
                           + [r["max_abs_err_o"] for r in full["kernels"]
                              if r["route"] == "classic"]),
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
                           for r in bwd_checks + full["kernels"]),
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
        "max_abs_err": max(r["max_abs_err_dq"]
                           for r in bwd_checks + full["kernels"]),
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
        "max_abs_err": max(r["max_abs_err"]
                           for r in conv_checks + p768["conv_checks"]),
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
    }, {
        # no TPU kernel: XLA fuses the JAX blocks' qk norm, concatenation
        # and RoPE; ``composed_ms`` is the chain it replaced
        "name": "qk_norm_rope",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/qk_norm_rope.cu",
        "replaces": "pyramid_flow_tpu/models/flux/blocks.py:181",
        "launches": total["qk_norm_rope"],
        "max_pair_ulps": max(r["max_pair_ulps"] for r in qk_checks),
        "site": qk_timed["site"],
        "ms": qk_timed["ms"],
        "kernel_ms": qk_timed["kernel_ms"],
        "plain_ms": qk_timed["plain_ms"],
        "composed_ms": qk_timed["composed_ms"],
        "bound_ms": qk_timed["bound_ms"],
        "bound_by": qk_timed["bound_by"],
        "library_ms": None,
    }, {
        # no TPU kernel: XLA fuses the JAX blocks' gated residual,
        # LayerNorm and modulation; ``composed_ms`` is the chain it replaced
        "name": "residual_norm",
        "route": "cuda",
        "source": "pyramid_flow_tpu_torch/csrc/residual_norm.cu",
        "replaces": "pyramid_flow_tpu/models/flux/blocks.py:271",
        "launches": total["residual_norm"],
        "max_term_ulps": max(r["max_term_ulps"] for r in norm_checks
                             if r["max_term_ulps"] is not None),
        "site": norm_timed["site"],
        "ms": norm_timed["ms"],
        "kernel_ms": norm_timed["kernel_ms"],
        "plain_ms": norm_timed["plain_ms"],
        "composed_ms": norm_timed["composed_ms"],
        "bound_ms": norm_timed["bound_ms"],
        "bound_by": norm_timed["bound_by"],
        "library_ms": None,
    }]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
