"""Temporal context parallelism for the causal VAE (the halo exchange).

The counterpart of the JAX package's ``parallel/cp.py``. The time axis is
sharded over the ranks of a cp process group, each holding ``T / cp``
frames. Inside :func:`cp_context`, every causal conv with ``k_t > 1`` takes
the previous rank's last ``k_t - 1 = 2`` input frames as its front frames
(:func:`previous_frames`; the first rank's are zeros, the causal zero
padding), so the conv computes what it would on the whole clip. The conv
kernel reads them as its ``front`` operand.

The exchange is a differentiable all_gather (``comm.all_gather``) of every
rank's last frames: its backward sums each rank's gradient of a rank's frames, which
returns the next rank's gradient of the halo to the rank it came from. It
runs on NCCL, and on gloo with CPU tensors.

As in JAX the shards are uniform: ``T % cp == 0``, and a clip decoded with
``is_init`` drops the temporal upsamplers' duplicated frame globally (a
shift left by one frame across the ranks) and trims the junk frames that
shift leaves at the global tail.
"""

from __future__ import annotations

import contextlib
import threading
import torch
import torch.distributed as dist

from .comm import all_gather, slot

__all__ = ["make_cp_mesh", "cp_context", "current_cp_axis", "previous_frames",
           "next_first_frame", "halo_exchange", "cp_vae_apply",
           "cp_vae_decode", "time_shard", "gather_time"]

_STATE = threading.local()


def make_cp_mesh(dp: int, cp: int, device_type: str = "cuda"):
    """The ("dp", "cp") mesh of VAE training over the default group's
    ranks: rank ``r`` at ``(r // cp, r % cp)``, JAX's device order."""
    from torch.distributed.device_mesh import init_device_mesh

    if dp * cp != dist.get_world_size():
        raise ValueError(f"dp {dp} x cp {cp} needs {dp * cp} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (dp, cp),
                            mesh_dim_names=("dp", "cp"))


@contextlib.contextmanager
def cp_context(group):
    """Within the block the causal convs exchange halos over ``group``
    (None turns context parallelism off)."""
    prev = getattr(_STATE, "group", None)
    _STATE.group = group
    try:
        yield
    finally:
        _STATE.group = prev


def current_cp_axis():
    """The cp group of the innermost :func:`cp_context`, or None."""
    return getattr(_STATE, "group", None)


def previous_frames(x: torch.Tensor, halo_frames: int, group
                    ) -> torch.Tensor:
    """``x`` ``[B, T, ...]`` -> the previous rank's last ``halo_frames``
    frames ``[B, halo_frames, ...]`` (zeros on the first rank);
    differentiable: the gradient goes back to the rank they came from."""
    if x.shape[1] < halo_frames:
        raise ValueError(
            f"per-rank clip ({x.shape[1]} frames) smaller than the halo "
            f"({halo_frames}); use fewer cp ranks or longer clips")
    tails = all_gather(x[:, -halo_frames:], group)
    return slot(tails, dist.get_rank(group) - 1)


def next_first_frame(y: torch.Tensor, group) -> torch.Tensor:
    """``y`` ``[B, T, ...]`` -> the next rank's first frame ``[B, 1, ...]``
    (zeros on the last rank); differentiable."""
    return slot(all_gather(y[:, :1], group), dist.get_rank(group) + 1)


def halo_exchange(x: torch.Tensor, halo_frames: int, group) -> torch.Tensor:
    """Prepend the previous rank's last ``halo_frames`` frames along time
    (axis 1); the first rank prepends zeros. JAX's ``halo_exchange``."""
    return torch.cat([previous_frames(x, halo_frames, group), x], dim=1)


def time_shard(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``T / cp`` frames of ``x`` ``[B, T, ...]``."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} frames do not shard over {n} cp "
                         "ranks")
    t = x.shape[1] // n
    return x[:, rank * t:(rank + 1) * t]


def gather_time(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``[B, t, ...]`` concatenated along time (rank order);
    differentiable."""
    return torch.cat(all_gather(x, group).unbind(0), dim=1)


def cp_vae_apply(method_fn, x: torch.Tensor, group) -> torch.Tensor:
    """Run a VAE method with the time axis sharded over ``group``.

    ``method_fn``: x_shard -> y_shard (a closure over ``vae.encode``, say).
    ``x``: the whole ``[B, T, H, W, C]`` (the same on every rank), ``T``
    divisible by cp; each rank must keep at least 2 frames through every
    temporal downsample, so ``T / cp >= 16`` for 8x temporal compression.
    Returns the whole output on every rank."""
    with cp_context(group):
        y = method_fn(time_shard(x, group))
    return gather_time(y, group)


def cp_vae_decode(vae, z: torch.Tensor, group) -> torch.Tensor:
    """Context-parallel decode of the whole latent ``z`` ``[B, T', h, w,
    Zc]`` (the same on every rank) with ``is_init``: each rank decodes
    ``T' / cp`` latent frames, every temporal upsampler shifts the sharded
    sequence left one frame, and the ``downsample_scale - 1`` junk frames
    the shift leaves at the global tail are trimmed. Returns the
    monolithic decode's ``[B, 1 + 8 (T' - 1), 8h, 8w, 3]`` on every rank.
    ``T'`` must divide by cp with at least 2 latent frames per rank."""
    n = dist.get_world_size(group)
    if z.shape[1] % n:
        raise ValueError(f"{z.shape[1]} latent frames do not shard over {n} "
                         "cp ranks")
    if z.shape[1] // n < 2:
        raise ValueError("need >= 2 latent frames per cp rank")
    out = cp_vae_apply(lambda zs: vae.decode(zs, is_init=True), z, group)
    drop = vae.config.downsample_scale - 1  # junk frames at the global tail
    return out[:, :out.shape[1] - drop]

