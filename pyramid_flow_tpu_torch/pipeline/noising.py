"""Pyramid noising for training, latent normalisation and the latent pyramid.

The counterpart of the JAX package's ``pipeline/noising.py`` in the
``[B, T, H, W, C]`` layout:

* :func:`noise_pyramid`: white noise downsampled 2x per level with the x2
  variance correction;
* :func:`stage_endpoints`: the (start, end) of a stage's flow segment; start
  mixes noise with the nearest-2x-upsampled previous stage's clean latent,
  end mixes noise with this stage's clean latent; the velocity target is
  start - end;
* :func:`add_pyramid_noise_stage`: full-sequence noising of one stage's
  sub-batch;
* :func:`add_ar_noise_stage`: AR noising; only the last ``frame_per_unit``
  frames train, the prefix is [lower-res clean history ..., corrupted last
  clip] with corruption sigma ~ U(0, corrupt_ratio);
* :func:`sample_stage_length`: the per-rank AR-position allocator.

Random draws come from a draw source (:class:`GeneratorDraws` by default)
whose ``split``/``fold_in`` calls sit where the JAX code splits its keys, so a
source that wraps JAX keys replays JAX's draws exactly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..ops.resample import avg_pool_2x, nearest_up_2x

__all__ = [
    "LATENT_NORMS",
    "FAMILY_LATENT_NORMS",
    "VIDEO_NORM",
    "GeneratorDraws",
    "StageBatch",
    "dit_model_name",
    "normalize_latent",
    "noise_pyramid",
    "latent_pyramid",
    "stage_endpoints",
    "add_pyramid_noise_stage",
    "add_ar_noise_stage",
    "sample_stage_length",
]

# (shift, scale) of frame 0 per model, and of the later frames
LATENT_NORMS = {
    "pyramid_flux": (-0.04, 1 / 1.8726),
    "pyramid_mmdit": (0.1490, 1 / 1.8415),
}
# every family of the port: the JAX package's two, and the Wan DiT, which
# runs on this repo's VAE and takes its latents with miniFLUX's norms
FAMILY_LATENT_NORMS = {**LATENT_NORMS,
                       "pyramid_wan": LATENT_NORMS["pyramid_flux"]}
VIDEO_NORM = (-0.2343, 1 / 3.0986)


class GeneratorDraws:
    """Training draws from one ``torch.Generator``.

    ``normal(shape)`` and ``uniform(shape)`` draw fp32 on the generator's
    device. ``split(n)`` returns ``n`` sources that share the generator, so
    draws follow call order; ``fold_in(data)`` returns a source with a fresh
    generator seeded from this one's seed and ``data``, so a training step's
    draws depend on (seed, step) alone and a resumed run repeats them.
    Another object with these four methods (one wrapping JAX keys, say)
    replays given draws.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device, dtype=torch.float32)

    def split(self, n: int) -> List["GeneratorDraws"]:
        return [self] * n

    def fold_in(self, data: int) -> "GeneratorDraws":
        seed = hash((self.generator.initial_seed(), int(data))) % 2**63
        return GeneratorDraws(torch.Generator(self.generator.device)
                              .manual_seed(seed))


def dit_model_name(dit, model_name: Optional[str] = None) -> str:
    """The DiT's family, its class's ``model_name`` (``"pyramid_flux"``
    without a DiT). A ``model_name`` given as well must name that family."""
    if model_name is not None and model_name not in FAMILY_LATENT_NORMS:
        raise ValueError(f"unknown model_name {model_name!r}; one of "
                         f"{sorted(FAMILY_LATENT_NORMS)}")
    if dit is None:
        return model_name or "pyramid_flux"
    if model_name not in (None, dit.model_name):
        raise ValueError(f"model_name {model_name!r} does not name the "
                         f"DiT's family: a {type(dit).__name__} is "
                         f"{dit.model_name!r}")
    return dit.model_name


def normalize_latent(x: torch.Tensor, model_name: str = "pyramid_flux"
                     ) -> torch.Tensor:
    """Raw VAE latent ``[B, T, H, W, C]`` -> model space; frame 0 uses the
    image statistics."""
    shift, scale = FAMILY_LATENT_NORMS[model_name]
    vshift, vscale = VIDEO_NORM
    first = (x[:, :1] - shift) * scale
    if x.shape[1] == 1:
        return first
    return torch.cat([first, (x[:, 1:] - vshift) * vscale], dim=1)


class StageBatch(NamedTuple):
    """One stage's training inputs: clips (history ..., noisy current),
    timesteps, ratios (sigma within the stage, 1 at its start) and velocity
    targets of the trainable clip."""

    clips: List[torch.Tensor]   # each [B, T_i, H_i, W_i, C]; last = noisy
    timesteps: torch.Tensor     # [B]
    ratios: torch.Tensor        # [B]
    targets: torch.Tensor       # [B, T_train, H, W, C]


def down2(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 1/2 downsample over H, W of [B, T, H, W, C]."""
    return avg_pool_2x(x.movedim(-1, -3)).movedim(-3, -1)


def up2_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample over H, W of [B, T, H, W, C]."""
    return nearest_up_2x(x.movedim(-1, -3)).movedim(-3, -1)


def latent_pyramid(x: torch.Tensor, num_stages: int):
    """[lowest .. full] clean-latent pyramid, no scaling."""
    out = [x]
    cur = x
    for _ in range(num_stages - 1):
        cur = down2(cur)
        out.append(cur)
    return list(reversed(out))


def noise_pyramid(draws, shape, num_stages: int):
    """[lowest .. full] noise pyramid with x2 variance correction per level."""
    noise = draws.normal(shape)
    out = [noise]
    cur = noise
    for _ in range(num_stages - 1):
        cur = down2(cur) * 2
        out.append(cur)
    return list(reversed(out))


def stage_endpoints(scheduler, stage: int, num_stages: int,
                    clean_latents: Sequence[torch.Tensor],
                    noise_list: Sequence[torch.Tensor]):
    """(start_point, end_point) of stage ``stage``'s flow segment."""
    start_sigma = scheduler.start_sigmas[stage]
    end_sigma = scheduler.end_sigmas[stage]
    clean = clean_latents[stage]
    noise = noise_list[stage]
    if stage == 0:
        start = noise
    else:
        up_prev = up2_nearest(clean_latents[stage - 1])
        start = start_sigma * noise + (1 - start_sigma) * up_prev
    if stage == num_stages - 1:
        end = clean
    else:
        end = end_sigma * noise + (1 - end_sigma) * clean
    return start, end


def _noised(scheduler, draws_t, start, end, stage):
    """(noisy, timesteps, ratios): a uniform timestep per row of the stage."""
    u = draws_t.uniform((start.shape[0],)).to(start.device)
    timesteps, ratios = scheduler.sample_stage_timesteps(u, stage)
    r = ratios.to(start.dtype)[:, None, None, None, None]
    return r * start + (1 - r) * end, timesteps, ratios


def add_pyramid_noise_stage(draws, scheduler, clean_latents, stage: int,
                            num_stages: int) -> StageBatch:
    """Full-sequence noising of one stage's sub-batch."""
    draws_noise, draws_t = draws.split(2)
    full = clean_latents[-1]
    noise_list = [n.to(full.device, full.dtype) for n in
                  noise_pyramid(draws_noise, full.shape, num_stages)]
    start, end = stage_endpoints(scheduler, stage, num_stages, clean_latents,
                                 noise_list)
    noisy, timesteps, ratios = _noised(scheduler, draws_t, start, end, stage)
    return StageBatch([noisy], timesteps, ratios, start - end)


def add_ar_noise_stage(draws, scheduler, clean_latents, stage: int,
                       num_stages: int, num_units: int,
                       frame_per_unit: int = 1,
                       corrupt_ratio: float = 1.0 / 3) -> StageBatch:
    """AR temporal-pyramid noising of one stage's sub-batch.

    ``num_units`` is clamped to the units the clip holds. The clip list runs
    oldest -> newest; the last clip is the trainable noisy unit."""
    draws_noise, draws_t, draws_sigma, draws_c = draws.split(4)
    full = clean_latents[-1]
    t_full = full.shape[1]
    num_units = min(num_units, 1 + (t_full - 1) // frame_per_unit)
    actual_frames = 1 + (num_units - 1) * frame_per_unit

    noise_list = [n.to(full.device, full.dtype) for n in
                  noise_pyramid(draws_noise, full.shape, num_stages)]
    start, end = stage_endpoints(scheduler, stage, num_stages, clean_latents,
                                 noise_list)
    noisy, timesteps, ratios = _noised(scheduler, draws_t, start, end, stage)
    # only the last unit trains
    noisy = noisy[:, :actual_frames][:, -frame_per_unit:]
    target = (start - end)[:, :actual_frames][:, -frame_per_unit:]

    clean = clean_latents[stage][:, :actual_frames]
    b = start.shape[0]
    sigma_c = (draws_sigma.uniform((b,)).to(full.device) * corrupt_ratio).to(
        clean.dtype)[:, None, None, None, None]

    def corrupt(x, source):
        z = source.normal(x.shape).to(x.device, x.dtype)
        return sigma_c * z + (1 - sigma_c) * x

    if num_units == 1:
        return StageBatch([noisy], timesteps, ratios, target)

    keys = draws_c.split(num_units)
    # newest-to-oldest construction, reversed at the end
    clips = [noisy]
    last_cond = clean[:, -(2 * frame_per_unit): -frame_per_unit]
    clips.append(corrupt(last_cond, keys[0]))

    cur_unit, cur_stage = 2, stage
    while cur_unit < num_units:
        cur_stage = max(cur_stage - 1, 0)
        if cur_stage == 0:
            break
        cur_unit += 1
        cond = clean_latents[cur_stage][:, :actual_frames]
        cond = cond[:, -(cur_unit * frame_per_unit):
                    -((cur_unit - 1) * frame_per_unit)]
        clips.append(corrupt(cond, keys[cur_unit - 1]))

    if cur_stage == 0 and cur_unit < num_units:
        cond = clean_latents[0][:, :actual_frames]
        cond = cond[:, : -(cur_unit * frame_per_unit)]
        clips.append(corrupt(cond, keys[-1]))

    return StageBatch(list(reversed(clips)), timesteps, ratios, target)


def sample_stage_length(rank: int, step: int, num_stages: int = 3,
                        max_temporal_length: int = 31,
                        frame_per_unit: int = 1, video_sync_group: int = 8,
                        max_units: Optional[int] = None) -> List[int]:
    """Deterministic per-rank AR-position allocation: ranks of a sync group
    cover different AR positions of the same video, rotating with ``step``.
    Returns the unit count of each stage, lowest resolution first."""
    max_units_in_training = 1 + (max_temporal_length - 1) // frame_per_unit
    # fewer units than the sync group: one turn covers every position
    total_turns = max(1, max_units_in_training // video_sync_group)
    update_turn = step % total_turns
    high = max(int((rank % video_sync_group + 1)
                   + update_turn * video_sync_group), 1)
    mid = max(1 + max_units_in_training - high, 1)
    low = mid
    if max_units is not None:
        high, mid, low = (min(x, max_units) for x in (high, mid, low))
    if num_stages != 3:
        raise ValueError(f"the allocator covers 3 stages, got {num_stages}")
    return [low, mid, high]
