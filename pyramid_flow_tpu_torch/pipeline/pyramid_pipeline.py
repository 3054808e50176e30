"""PyramidFlow text-to-video and image-to-video pipeline.

The autoregressive loop over temporal units runs, for each unit, a cascade of
pyramid stages (nearest-2x upsample and correlated block renoise between
stages), each stage a plain loop of CFG Euler steps through the DiT. Then the
causal VAE decodes the latents window by window (spatially tiled above a
size) to uint8 frames. Image-to-video fixes unit 0 to the VAE-encoded image.

Conditioning on earlier units is packed in front of the current clip and
padded to a per-stage token budget (zero tokens with INVALID time ids, placed
between the history and the current clip), so the token layout equals the
JAX package's exactly.

Text encoding is separate: ``generate`` takes precomputed (embeddings, mask,
pooled) for the positive and the negative prompt.

``generate`` opens spans (``utils.profiling.span``, recorded only inside
``profiling.recording()``) around the request, each unit, stage, device
sync and the decode, under the request's number as trace id.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.blocknoise import block_noise_from_normal
from ..ops.flash_attention import INVALID_TIME
from ..schedulers.flow_matching import PyramidFlowMatchEulerDiscreteScheduler
from ..utils.profiling import ALLOCATOR, span
from .noising import (FAMILY_LATENT_NORMS, VIDEO_NORM, dit_model_name,
                      down2, latent_pyramid, normalize_latent, up2_nearest)
from .packing import clip_metadata, patchify, unpatchify

__all__ = ["PyramidFlowPipeline", "DecodePlan", "GeneratorNoise",
           "decode_settings", "device_memory_gb"]


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How :meth:`PyramidFlowPipeline.decode_latent` decodes (the JAX
    package's decode settings as one object). Without ``px_window_budget``:
    untiled in windows of ``untiled_window`` latent frames for frames up to
    ``untiled_max_latent`` squared latent pixels, larger frames in spatial
    tiles of ``tile`` pixels that overlap by ``overlap``, in windows of
    ``window``. With it (latent pixels x window frames one decode may hold
    at once): the least redundant plan within that budget, rung by rung
    (:meth:`PyramidFlowPipeline.decode_latent`). The defaults are the plan
    for a device of 48 GB or more; :func:`decode_settings` picks one by
    the device's memory."""

    window: int = 2
    untiled_max_latent: int = 192
    tile: int = 512
    overlap: float = 0.125
    untiled_window: int = 2
    px_window_budget: Optional[int] = None


def decode_settings(save_memory: bool, memory_gb: float,
                    dit_resident: bool = True) -> DecodePlan:
    """The decode plan for a device of ``memory_gb`` GB, as the JAX
    package picks it (the same constants):

    * not ``save_memory``: 512-pixel tiles overlapping by 1/4, window 2,
      untiled up to a 192 x 192 latent on 48 GB or more, else 96 x 96;
    * 48 GB or more: 512-pixel tiles overlapping by 1/8, window 2, untiled
      up to a 192 x 192 latent;
    * below 48 GB with the DiT released: a budget of 9216 latent pixels x
      window frames (the least redundant plan within it; beyond it
      384-pixel tiles overlapping by 1/8 in windows of 2, or untiled in
      windows of 1 up to a 96 x 96 latent);
    * below 48 GB with the DiT resident: 384-pixel tiles overlapping by
      1/8, window 2; untiled in windows of 1 up to a 96 x 96 latent.

    The thresholds are the JAX package's, measured on a 16 GB TPU; the
    port takes them as they are."""
    big = memory_gb >= 48.0
    if not save_memory:
        return DecodePlan(tile=512, overlap=0.25, window=2, untiled_window=2,
                          untiled_max_latent=192 if big else 96)
    if big:
        return DecodePlan(tile=512, overlap=0.125, window=2,
                          untiled_window=2, untiled_max_latent=192)
    if not dit_resident:
        return DecodePlan(px_window_budget=9216, tile=384, overlap=0.125,
                          window=2, untiled_window=1, untiled_max_latent=96)
    return DecodePlan(tile=384, overlap=0.125, window=2, untiled_window=1,
                      untiled_max_latent=96)


def device_memory_gb(device) -> float:
    """The memory of ``device`` in GB: a CUDA device's total memory, and
    16.0 for any other (the JAX package's floor when it cannot read a
    device's)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 1e9
    return 16.0


class GeneratorNoise:
    """The pipeline's noise: standard normals from one ``torch.Generator``.

    ``initial(shape)`` is the full-size initial latent draw
    ``[B, temp, h, w, C]``; ``block(unit, stage, shape)`` the standard-normal
    ``z`` ``[B, T, h/2, w/2, C, 4]`` behind the block noise of a stage
    transition. Another object with these two methods replays given draws.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)

    def initial(self, shape):
        return self._normal(shape)

    def block(self, unit_index: int, stage: int, shape):
        return self._normal(shape)


class PyramidFlowPipeline:
    """Inference runner: AR unit loop -> per-stage CFG Euler loops -> causal
    VAE decode. The pyramid is its scheduler's (the stage count, timestep
    shift, stage windows and block-noise gamma) and ``frame_per_unit``; the
    defaults are the release settings: 3 stages (1/4, 1/2 and full
    resolution), one latent frame per temporal unit, timestep shift 1 and
    block-noise gamma 1/3.

    Unit 0 of a text-to-video request is one latent frame and every later
    unit ``frame_per_unit`` frames, so ``temp`` gives
    ``1 + ((temp - 1) // frame_per_unit) * frame_per_unit`` latent frames;
    image-to-video fixes unit 0 to the image and gives
    ``1 + (temp // frame_per_unit - 1) * frame_per_unit``. Each latent
    frame after the first decodes to 8 pixel frames.

    Args:
      dit: a ``PyramidFluxTransformer``, ``PyramidDiffusionMMDiT`` or
        ``WanDiT`` (packed-token API) with its weights. Its family
        (``dit.model_name``) selects the latent normalisation, and its
        ``stage_inputs`` give the forward's extra inputs per stage (the
        MMDiT's table crop origin).
      vae: a ``CausalVideoVAE``, or None for latent output only.
      scheduler: a ``PyramidFlowMatchEulerDiscreteScheduler``, whose
        ``stages`` is the pipeline's stage count (each stage doubles the
        one before); None builds the default one.
      frame_per_unit: latent frames per temporal unit after the first.
      latent_channels: the VAE latent's width.
      dtype: the DiT's compute dtype; tokens are cast to it at patchify,
        latents stay fp32.
      device: where the loop runs; defaults to the DiT's device.
      model_name: ``"pyramid_flux"``, ``"pyramid_mmdit"`` or
        ``"pyramid_wan"``, optional; when given it must name the DiT's
        family.
    """

    downsample = 8

    def __init__(self, dit, vae=None,
                 scheduler: Optional[
                     PyramidFlowMatchEulerDiscreteScheduler] = None,
                 frame_per_unit: int = 1, latent_channels: int = 16,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 model_name: Optional[str] = None):
        self.model_name = dit_model_name(dit, model_name)
        if getattr(getattr(dit, "config", None), "guidance_embeds", False):
            # the JAX pipeline never passes the DiT a guidance scale (its
            # apply would fail), so there is no step to port for one
            raise ValueError(
                "a guidance_embeds DiT needs a guidance scale in every "
                "forward, which the pyramid pipeline's CFG steps do not pass "
                "(nor do the JAX package's); call the DiT itself")
        self.dit = dit
        self.vae = vae
        self.scheduler = (scheduler if scheduler is not None
                          else PyramidFlowMatchEulerDiscreteScheduler())
        self.num_stages = self.scheduler.stages
        self.frame_per_unit = frame_per_unit
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None else next(dit.parameters()).device)
        self.vae_shift_factor, self.vae_scale_factor = FAMILY_LATENT_NORMS[
            self.model_name]
        self.vae_video_shift_factor, self.vae_video_scale_factor = VIDEO_NORM
        self.last_dit_seconds = None
        self.last_decode_seconds = None
        self.requests = 0  # generate's calls: the trace id of their spans

    @classmethod
    def from_pretrained(cls, model_path: str,
                        model_variant: str = "diffusion_transformer_768p",
                        model_name: str = "pyramid_flux",
                        load_vae: bool = True,
                        dtype: torch.dtype = torch.bfloat16, device="cuda",
                        components: Optional[dict] = None, mesh=None,
                        bounded_softmax: bool = True, **kwargs):
        """A pipeline from a released checkpoint directory
        (``utils.checkpoint``): the DiT from ``<model_variant>/`` and the
        VAE from ``causal_video_vae/``, each built on ``device`` in
        ``dtype`` from its ``config.json`` and loaded by copy with
        ``strict=True`` (so the VAE's conv weights keep their
        ``channels_last_3d`` layout). The latent width comes from the VAE's
        config. ``components``: state dicts already read by
        ``load_pretrained_components``. ``cpu_offloading`` is accepted and
        ignored (the card holds the whole pipeline); text encoding is
        separate (``PyramidFlowRunner.from_pretrained``). ``mesh``: a
        (dp, fsdp, sp) mesh whose sp dim shards every DiT forward's tokens
        (the DiT's sequence parallelism, JAX's ``mesh=``): each sp rank runs
        the same denoising loop on the same draws and gets the whole
        frames. ``bounded_softmax=False`` builds the DiT on the classic
        online softmax (the DiT's ``bounded_softmax``; JAX's
        ``PF_BOUNDED_SOFTMAX=0``). Other ``kwargs`` go to the constructor:
        the pyramid's (``scheduler``, ``frame_per_unit``) and
        ``latent_channels``."""
        from ..utils.checkpoint import (build_dit, build_vae,
                                        load_pretrained_components,
                                        require_components)

        kwargs.pop("cpu_offloading", None)
        if components is None:
            components = load_pretrained_components(
                model_path, model_variant, model_name, load_vae=load_vae,
                load_text_encoders=False)
        require_components(components, ["dit"] + ["vae"] * load_vae,
                           model_path)
        dit = build_dit(model_path, model_variant, model_name,
                        components["dit"], dtype=dtype, device=device,
                        mesh=mesh, bounded_softmax=bounded_softmax)
        vae = None
        if load_vae:
            vae = build_vae(model_path, components["vae"], dtype=dtype,
                            device=device).eval()
            # the latent width is a property of the checkpoint, not a knob
            kwargs.setdefault("latent_channels", vae.config.latent_channels)
        return cls(dit.eval(), vae, dtype=dtype, device=device,
                   model_name=model_name, **kwargs)

    @classmethod
    def from_train_state(cls, dit, train_state, vae=None,
                         use_ema: bool = False,
                         dtype: torch.dtype = torch.bfloat16, device=None,
                         **kwargs):
        """A pipeline from a live or restored ``TrainState``: a new DiT of
        ``dit``'s class and config in ``dtype`` (on ``device``, by default
        the state's), holding the state's parameters or, with
        ``use_ema=True``, their EMA (the reference trains with an EMA copy
        and ships it for inference), cast, and the model's persistent
        buffers. A sharded state is gathered, a collective that every rank
        calls; each rank gets the whole DiT. The training model and its EMA stay as they were, so a
        later train step is the one it would have been. The new DiT takes
        ``dit``'s softmax route (``bounded_softmax``). ``kwargs`` go to the
        constructor (the pyramid's ``scheduler`` and ``frame_per_unit``
        among them)."""
        if device is None:
            p = next(train_state.model.parameters())
            device = (p.to_local() if hasattr(p, "to_local") else p).device
        infer = type(dit)(dit.config, dtype=dtype, device=device,
                          bounded_softmax=dit.bounded_softmax)
        target = infer.state_dict()
        seen = set()
        with torch.no_grad():
            for name, t in train_state.inference_tensors(use_ema):
                target[name].copy_(t)
                seen.add(name)
        missing = set(target) - seen
        if missing:
            raise KeyError(f"the train state holds no {sorted(missing)}")
        return cls(infer.eval(), vae, dtype=dtype, device=device, **kwargs)

    # ------------------------------------------------------------ helpers
    def enable_sequential_cpu_offload(self):
        """A no-op kept for the API (the reference moves modules to host
        memory to fit small cards; the JAX package's is a no-op too).
        Returns the pipeline."""
        return self

    def normalize_latent(self, x):
        """VAE latent -> model space; frame 0 uses the image statistics."""
        return normalize_latent(x, self.model_name)

    def denormalize_latent(self, x):
        """Model space -> VAE latent space."""
        first = x[:, :1] / self.vae_scale_factor + self.vae_shift_factor
        if x.shape[1] == 1:
            return first
        rest = (x[:, 1:] / self.vae_video_scale_factor
                + self.vae_video_shift_factor)
        return torch.cat([first, rest], dim=1)

    def _sync(self):
        with span("pipeline.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _pack_cond(self, clips, *, budget: int):
        """Patchify and concat the conditioning clips, right-pad with zero
        tokens to ``budget``, CFG-double. The pad sits between the history
        and the current clip, which keeps pad keys out of the first k-tiles
        of every row."""
        tokens = torch.cat([patchify(c.to(self.dtype)) for c in clips], dim=1)
        pad = budget - tokens.shape[1]
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, 0, 0, pad))
        return torch.cat([tokens, tokens], dim=0)

    # ---------------------------------------------------------- denoising
    def _denoise_stage_loop(self, latents, cond_tokens, positions, time_ids,
                            prompt_embeds, prompt_mask, pooled, timesteps,
                            sigmas, guidance: float, ab, block_z, *,
                            trainable_tokens: int, temp: int, height: int,
                            width: int):
        """The CFG Euler loop of one stage, after the stage transition
        (nearest-2x upsample and block renoise) when ``block_z`` is given."""
        if block_z is not None:
            noise = block_noise_from_normal(block_z, self.scheduler.gamma)
            latents = ab[0] * up2_nearest(latents) + ab[1] * noise

        b = latents.shape[0]
        pos2 = positions.expand(2 * b, -1, -1)
        time2 = time_ids.expand(2 * b, -1)
        extra = self.dit.stage_inputs(2 * b, height, width, self.device)
        for i in range(len(timesteps)):
            lat_tokens = patchify(latents.to(self.dtype))
            tokens = torch.cat(
                [cond_tokens, torch.cat([lat_tokens, lat_tokens])], dim=1)
            t = torch.full((2 * b,), float(timesteps[i]), dtype=torch.float32,
                           device=self.device)
            v = self.dit(tokens, pos2, time2, prompt_embeds, prompt_mask,
                         pooled, t, *extra)
            v_uncond, v_cond = v[:, -trainable_tokens:].float().chunk(2)
            v = v_uncond + guidance * (v_cond - v_uncond)
            v_lat = unpatchify(v, temp, height, width)
            # Euler step in fp32 (the latents are fp32)
            dt = float(np.float32(sigmas[i + 1]) - np.float32(sigmas[i]))
            latents = (latents.float() + dt * v_lat).to(latents.dtype)
        return latents

    def _cond_clip_plan(self, unit_index, stage):
        """``[(s, lo, hi)]`` oldest first: each conditioning clip takes
        history frames [lo, hi) at stage ``s``'s resolution. History unit 0
        is the single first frame; the newest history unit conditions at the
        current stage, older ones at lower stages, and everything older than
        stage 0 collapses into one lowest-resolution clip."""
        if unit_index == 0:
            return []
        fpu = self.frame_per_unit
        plan = []
        j, s = unit_index - 1, stage
        while j >= 0:
            if s == 0:
                plan.append((0, 0, 1 + j * fpu))
                break
            plan.append((s, 0, 1) if j == 0
                        else (s, 1 + (j - 1) * fpu, 1 + j * fpu))
            j -= 1
            s -= 1
        return list(reversed(plan))

    def _stage_clip_shapes(self, b, h_lat, w_lat, unit_index, stage):
        """Conditioning clip shapes (B, T, H, W, C) for (unit, stage)."""
        c = self.latent_channels

        def dims(s):
            return (h_lat >> (self.num_stages - 1 - s),
                    w_lat >> (self.num_stages - 1 - s))

        return [(b, hi - lo) + dims(s) + (c,)
                for (s, lo, hi) in self._cond_clip_plan(unit_index, stage)]

    def _prep_cond_from_history(self, history, *, unit_index: int,
                                stage: int, budget: int):
        """history [B, T_hist, H, W, C] -> conditioning tokens
        [2B, budget, 4C]."""
        clean_list = latent_pyramid(history, self.num_stages)
        clips = [clean_list[s][:, lo:hi]
                 for (s, lo, hi) in self._cond_clip_plan(unit_index, stage)]
        return self._pack_cond(clips, budget=budget)

    def _stage_metadata(self, b: int, fpu: int, h_lat: int, w_lat: int,
                        unit_index: int, stage: int, budget: int):
        """Host-side (positions, time_ids, trainable) of one (unit, stage),
        padded to ``budget`` conditioning tokens between the history and the
        current clip."""
        h = h_lat >> (self.num_stages - 1 - stage)
        w = w_lat >> (self.num_stages - 1 - stage)
        shapes = self._stage_clip_shapes(b, h_lat, w_lat, unit_index, stage)
        shapes.append((b, fpu, h, w, self.latent_channels))
        positions, time_ids, trainable = clip_metadata(shapes)
        lc = positions.shape[0] - trainable
        if lc > budget:
            raise ValueError(f"{lc} conditioning tokens exceed budget {budget}")
        pad = budget - lc
        if pad:
            positions = np.concatenate(
                [positions[:lc], np.zeros((pad, 3), np.float32),
                 positions[lc:]], axis=0)
            time_ids = np.concatenate(
                [time_ids[:lc], np.full((pad,), INVALID_TIME, np.int32),
                 time_ids[lc:]], axis=0)
        return positions, time_ids, trainable

    def _cond_token_budget(self, unit_index: int, h_lat: int, w_lat: int):
        """Per-stage conditioning-token budget: the history's token count,
        rounded so that text (128) + history + current clip lands on a
        multiple of 512 (of 128 for sequences up to 512)."""
        fpu = self.frame_per_unit
        budgets = []
        for i_s in range(self.num_stages):
            shapes = self._stage_clip_shapes(1, h_lat, w_lat, unit_index, i_s)
            toks = sum(t * (h // 2) * (w // 2) for (_, t, h, w, _) in shapes)
            h = h_lat >> (self.num_stages - 1 - i_s)
            w = w_lat >> (self.num_stages - 1 - i_s)
            total = 128 + toks + fpu * (h // 2) * (w // 2)
            toks += (-total) % (512 if total > 512 else 128)
            budgets.append(toks)
        return budgets

    def generate_one_unit(self, latents, cond_tokens_per_stage, prompt_embeds,
                          prompt_mask, pooled,
                          num_inference_steps: Sequence[int], guidance: float,
                          unit_index: int, budgets: Sequence[int], h_lat: int,
                          w_lat: int, noise):
        """The stage cascade of one temporal unit; ``latents`` [B, T, h0, w0,
        C] at the lowest stage's resolution. Returns each stage's latents."""
        b, fpu = latents.shape[:2]
        c = self.latent_channels
        intermed = []
        for i_s in range(self.num_stages):
            with span("pipeline.stage", stage=i_s,
                      steps=num_inference_steps[i_s]) as stage:
                timesteps, sigmas = self.scheduler.inference_tables(
                    num_inference_steps[i_s], i_s)
                h = h_lat >> (self.num_stages - 1 - i_s)
                w = w_lat >> (self.num_stages - 1 - i_s)
                if i_s > 0:
                    ab = self.scheduler.transition_coefficients(i_s)
                    block_z = noise.block(unit_index, i_s,
                                          (b, fpu, h // 2, w // 2, c, 4))
                    block_z = block_z.to(self.device, torch.float32)
                else:
                    ab, block_z = None, None
                positions, time_ids, trainable = self._stage_metadata(
                    b, fpu, h_lat, w_lat, unit_index, i_s, budgets[i_s])
                stage.set(tokens=budgets[i_s] + trainable)
                cond_tokens = (cond_tokens_per_stage[i_s]
                               if cond_tokens_per_stage is not None else
                               torch.zeros((2 * b, budgets[i_s], 4 * c),
                                           dtype=self.dtype,
                                           device=self.device))
                latents = self._denoise_stage_loop(
                    latents, cond_tokens,
                    torch.as_tensor(positions, device=self.device)[None],
                    torch.as_tensor(time_ids, device=self.device)[None],
                    prompt_embeds, prompt_mask, pooled, timesteps, sigmas,
                    guidance, ab, block_z, trainable_tokens=trainable,
                    temp=fpu, height=h, width=w)
                intermed.append(latents)
        return intermed

    @torch.no_grad()
    def generate(self, generator: Optional[torch.Generator],
                 prompt_embeds, prompt_mask, pooled_embeds,
                 negative_embeds, negative_mask, negative_pooled,
                 height: int, width: int, temp: int = 1,
                 num_inference_steps: Sequence[int] | int = 20,
                 video_num_inference_steps: Sequence[int] | int = 10,
                 guidance_scale: float = 7.0,
                 video_guidance_scale: float = 5.0,
                 use_linear_guidance: bool = False, alpha: float = 0.5,
                 min_guidance_scale: float = 2.0,
                 output_type: str = "latent",
                 save_memory: bool = True,
                 decode_plan: Optional[DecodePlan] = None,
                 input_image_latent: Optional[torch.Tensor] = None,
                 progress_callback: Optional[Callable[[dict], None]] = None,
                 release_dit_before_decode: bool = False,
                 noise=None):
        """Text-to-video, or image-to-video with ``input_image_latent``
        ([B, 1, h, w, C], normalised): unit 0 is then the image and units
        1 .. temp - 1 are generated. Returns latents
        [B, temp, h, w, C] (fp32) for ``output_type="latent"``, else uint8
        frames [B, 1 + 8 (temp - 1), height, width, 3].

        ``generator`` draws the noise; ``noise`` (an object with the methods
        of :class:`GeneratorNoise`) replaces it to replay given draws.
        ``progress_callback(info)`` is called after each unit and before the
        decode. ``release_dit_before_decode`` drops the DiT before decoding
        to hand its memory to the VAE; the pipeline then cannot generate
        again until ``pipeline.dit`` is set. ``save_memory`` and
        ``decode_plan`` go to :meth:`decode_latent`."""
        if self.dit is None:
            raise RuntimeError(
                "the DiT was released by generate(release_dit_before_decode="
                "True); set pipeline.dit to generate again")
        if noise is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or a noise source")
            noise = GeneratorNoise(generator)
        if isinstance(num_inference_steps, int):
            num_inference_steps = [num_inference_steps] * self.num_stages
        if isinstance(video_num_inference_steps, int):
            video_num_inference_steps = ([video_num_inference_steps]
                                         * self.num_stages)
        self.requests += 1
        with span("pipeline.request", trace_id=self.requests,
                  temp=temp) as request:
            t_start = time.perf_counter()
            dev = self.device
            # CFG batch: [negative, positive]
            pe = torch.cat([negative_embeds, prompt_embeds]).to(dev,
                                                                self.dtype)
            pm = torch.cat([negative_mask, prompt_mask]).to(dev)
            pp = torch.cat([negative_pooled, pooled_embeds]).to(dev,
                                                                self.dtype)

            b = prompt_embeds.shape[0]
            h_lat = height // self.downsample
            w_lat = width // self.downsample
            min_div = self.downsample * 2 * (2 ** (self.num_stages - 1))
            if height % min_div or width % min_div:
                raise ValueError(
                    f"height/width must be divisible by {min_div} (8x VAE x "
                    f"2 patch x {2 ** (self.num_stages - 1)} pyramid)")
            latents = noise.initial(
                (b, temp, h_lat, w_lat, self.latent_channels))
            latents = latents.to(dev, torch.float32)
            # start from the lowest stage: bilinear down with the x2 noise
            # scale
            for _ in range(self.num_stages - 1):
                latents = down2(latents) * 2

            fpu = self.frame_per_unit
            generated: List[torch.Tensor] = []
            if input_image_latent is not None:
                # unit 0 is the image; unit u > 0 denoises the initial draw's
                # frames [(u - 1) fpu, u fpu)
                generated.append(input_image_latent.to(dev, torch.float32))
                unit_range = range(1, temp // fpu)
            else:
                # unit 0 is the first frame; unit u > 0 takes frames
                # [1 + (u - 1) fpu, 1 + u fpu)
                unit_range = range(1 + (temp - 1) // fpu)
            request.set(units=len(unit_range))
            if use_linear_guidance:
                g_list = [max(guidance_scale - alpha * t_, min_guidance_scale)
                          for t_ in range(temp)]
            for done, unit_index in enumerate(unit_range, start=1):
                with span("pipeline.unit", counters=ALLOCATOR,
                          unit=unit_index):
                    budgets = self._cond_token_budget(unit_index, h_lat,
                                                      w_lat)
                    if unit_index == 0:
                        g = (g_list[0] if use_linear_guidance
                             else guidance_scale)
                        intermed = self.generate_one_unit(
                            latents[:, :1], None, pe, pm, pp,
                            num_inference_steps, g, 0, budgets, h_lat, w_lat,
                            noise)
                    else:
                        vg = (g_list[unit_index] if use_linear_guidance
                              else video_guidance_scale)
                        history = torch.cat(generated, dim=1)
                        cond = [self._prep_cond_from_history(
                            history, unit_index=unit_index, stage=i_s,
                            budget=budgets[i_s])
                            for i_s in range(self.num_stages)]
                        start = (unit_index - 1) * fpu
                        if input_image_latent is None:
                            start += 1  # frame 0 was unit 0's
                        intermed = self.generate_one_unit(
                            latents[:, start:start + fpu], cond, pe, pm, pp,
                            video_num_inference_steps, vg, unit_index,
                            budgets, h_lat, w_lat, noise)
                    generated.append(intermed[-1].float())
                    if progress_callback is not None:
                        self._sync()
                if progress_callback is not None:
                    progress_callback({"phase": "denoise", "unit": done,
                                       "units": len(unit_range)})

            latents_full = torch.cat(generated, dim=1)
            self._sync()
            t_dit = time.perf_counter()
            self.last_dit_seconds = t_dit - t_start
            if output_type == "latent":
                return latents_full
            if release_dit_before_decode:
                self.dit = None
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            if progress_callback is not None:
                progress_callback({"phase": "decode",
                                   "unit": len(unit_range),
                                   "units": len(unit_range)})
            with span("pipeline.decode"):
                out = self.decode_latent(latents_full,
                                         save_memory=save_memory,
                                         plan=decode_plan)
            self._sync()
            self.last_decode_seconds = time.perf_counter() - t_dit
            return out

    def generate_i2v(self, generator: Optional[torch.Generator],
                     image_latent_raw: torch.Tensor, *args, **kwargs):
        """Image-to-video: ``image_latent_raw`` is the VAE's latent of the
        image ([B, 1, h, w, C], not normalised); it is normalised with the
        image statistics and fixed as unit 0. The other arguments are
        :meth:`generate`'s."""
        img = ((image_latent_raw.float() - self.vae_shift_factor)
               * self.vae_scale_factor)
        return self.generate(generator, *args, input_image_latent=img,
                             **kwargs)

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_latent(self, latents, *, save_memory: bool = True,
                      plan: Optional[DecodePlan] = None):
        """Un-normalise and decode to uint8 frames [B, F, H, W, 3].

        ``plan`` None takes :func:`decode_settings` for this device's memory
        (:func:`device_memory_gb`) and whether the DiT is still held. With a
        ``px_window_budget`` the decode takes the first rung that fits, in
        the JAX package's order: untiled in windows of 2, then of 1, then
        full-height column strips (as wide as the budget allows, at least 32
        latent pixels) in windows of 2; a frame too tall for that takes the
        plan's tiled walk. Without a budget, frames above
        ``untiled_max_latent`` squared latent pixels decode in the plan's
        spatial tiles, others untiled."""
        from ..models.vae.model import (chunk_decode, tiled_decode,
                                        tiled_decode_planned)

        if self.vae is None:
            raise ValueError("pipeline built without a VAE")
        if plan is None:
            plan = decode_settings(save_memory, device_memory_gb(self.device),
                                   dit_resident=self.dit is not None)
        z = self.denormalize_latent(latents).float()
        hl, wl = z.shape[2], z.shape[3]
        budget = plan.px_window_budget
        # the JAX package's window-1 strip rung is left out: budget // hl
        # >= 64 implies budget // (2 hl) >= 32, so the window-2 rung wins
        if budget is not None and hl * wl * 2 <= budget:
            img = chunk_decode(self.vae, z, window_size=2)
        elif budget is not None and hl * wl <= budget:
            img = chunk_decode(self.vae, z, window_size=1)
        elif budget is not None and budget // (hl * 2) >= 32:
            img = tiled_decode_planned(self.vae, z, tile_h=hl,
                                       tile_w=budget // (hl * 2),
                                       window_size=2)
        elif hl * wl > plan.untiled_max_latent ** 2:
            img = tiled_decode(self.vae, z, tile_sample_min_size=plan.tile,
                               temporal_chunk=True, window_size=plan.window,
                               overlap_factor=plan.overlap)
        else:
            img = chunk_decode(self.vae, z, window_size=plan.untiled_window)
        return (img.float() * 127.5 + 127.5).clamp(0, 255).to(torch.uint8)
