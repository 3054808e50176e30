"""Ulysses sequence parallelism for the DiTs' attention.

The counterpart of the JAX package's ``parallel/sp.py``. The port runs one
process per rank, so each sp rank holds a contiguous shard of the packed
joint sequence: around every attention, one all_to_all re-shards ``[B, H,
L/sp, D]`` (every head, a slice of the sequence) into ``[B, H/sp, L, D]``
(a slice of the heads, the whole sequence), the attention runs on the whole
sequence, and a second all_to_all shards it back. Both are the
differentiable ``torch.distributed.nn.functional.all_to_all_single``
(``comm.all_to_all``), so the backward re-shards the gradients the same
way.

:class:`SeqShard` is how a DiT shards its joint sequence (text, then the
pyramid tokens) over the sp ranks at entry and gathers it at exit: the
sequence is padded at its tail to a multiple of ``sp * 128`` with
``INVALID_TIME`` tokens, which no valid query sees, as JAX pads it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.flash_attention import INVALID_TIME, flash_attention
from .comm import all_gather, all_to_all

__all__ = ["sp_flash_attention", "ulysses_attention_core", "SeqShard",
           "SP_BLOCK", "gather_seq", "a2a_bytes"]

# the padded sequence is a multiple of sp * SP_BLOCK tokens, JAX's rule
SP_BLOCK = 128


def a2a_bytes(x: torch.Tensor, group) -> int:
    """Bytes one all_to_all of ``x`` sends from this rank to the others."""
    n = dist.get_world_size(group)
    return x.numel() * x.element_size() * (n - 1) // n


def ulysses_attention_core(q, k, v, time_ids, *, group, causal: bool,
                           sm_scale: Optional[float],
                           bounded: Optional[bool] = None) -> torch.Tensor:
    """One sp rank: q, k, v ``[B, H, L/sp, D]``, ``time_ids`` ``[B, L]``
    whole. all_to_all #1 gathers the sequence and scatters the heads, the
    attention runs on ``[B, H/sp, L, D]`` (padded at its tail to a multiple
    of ``sp * 128`` with ``INVALID_TIME`` keys, as JAX pads it), all_to_all
    #2 inverts #1."""
    l = time_ids.shape[1]
    n = dist.get_world_size(group) * SP_BLOCK
    pad = -l // n * -n - l
    qf, kf, vf = (all_to_all(t, group, 1, 2) for t in (q, k, v))
    if pad:
        qf, kf, vf = (F.pad(t, (0, 0, 0, pad)) for t in (qf, kf, vf))
        time_ids = F.pad(time_ids, (0, pad), value=INVALID_TIME)
    o = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                        time_ids, causal=causal, sm_scale=sm_scale,
                        bounded=bounded)
    return all_to_all(o[:, :, :l], group, 2, 1)


def sp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       time_ids: torch.Tensor, group=None, *,
                       causal: bool = True, sm_scale: Optional[float] = None,
                       bounded: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel flash attention.

    q, k, v: this rank's ``[B, H, L/sp, D]`` shard of the sequence (rank
    ``r`` holds tokens ``[r L/sp, (r + 1) L/sp)``); ``time_ids``: ``[B, L]``,
    the whole sequence's. ``group``: the sp process group (None or a group
    of one: the plain :func:`flash_attention`). Heads must divide by sp.
    Returns this rank's ``[B, H, L/sp, D]``."""
    sp = 1 if group is None else dist.get_world_size(group)
    if sp == 1:
        return flash_attention(q, k, v, time_ids, causal=causal,
                               sm_scale=sm_scale, bounded=bounded)
    if q.shape[1] % sp:
        raise ValueError(f"heads ({q.shape[1]}) must divide by the sp "
                         f"ranks ({sp})")
    if time_ids.shape[1] != sp * q.shape[2]:
        raise ValueError(f"time ids cover {time_ids.shape[1]} tokens, the "
                         f"shards {sp} x {q.shape[2]}")
    return ulysses_attention_core(q, k, v, time_ids, group=group,
                                  causal=causal, sm_scale=sm_scale,
                                  bounded=bounded)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """How one sp rank holds the DiT's joint sequence of ``text`` then
    ``image`` tokens, padded to ``padded`` (a multiple of ``sp * 128``):
    tokens ``[start, start + chunk)``, of which the first ``text_local``
    are text."""

    group: object
    sp: int
    rank: int
    text: int
    image: int

    @property
    def padded(self) -> int:
        n = self.sp * SP_BLOCK
        return -(self.text + self.image) // n * -n

    @property
    def chunk(self) -> int:
        return self.padded // self.sp

    @property
    def start(self) -> int:
        return self.rank * self.chunk

    @property
    def text_local(self) -> int:
        return min(max(self.text - self.start, 0), self.chunk)

    @classmethod
    def of(cls, group, text: int, image: int) -> Optional["SeqShard"]:
        """The shard of this rank in ``group`` (None without sp)."""
        if group is None or dist.get_world_size(group) == 1:
            return None
        return cls(group, dist.get_world_size(group), dist.get_rank(group),
                   text, image)

    def pad(self, joint: torch.Tensor, value=0) -> torch.Tensor:
        """``[B, text + image, ...]`` -> ``[B, padded, ...]``, the tail
        filled with ``value``."""
        extra = self.padded - joint.shape[1]
        tail = joint.new_full((joint.shape[0], extra) + joint.shape[2:],
                              value)
        return torch.cat([joint, tail], dim=1)

    def local(self, joint: torch.Tensor, value=0) -> torch.Tensor:
        """This rank's tokens of a joint ``[B, text + image, ...]``."""
        return self.pad(joint, value)[:, self.start:self.start + self.chunk]

    def split(self, ctx: torch.Tensor, x: torch.Tensor):
        """``(ctx_local, x_local)``: this rank's text and image tokens of
        the joint ``[ctx; x]``; either may be empty."""
        h = self.local(torch.cat([ctx, x], dim=1))
        return h[:, :self.text_local], h[:, self.text_local:]


def gather_seq(local: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The image tokens ``[B, image, ...]`` of the whole joint sequence from
    each rank's ``[B, chunk, ...]``: a differentiable all_gather (its
    backward sums every rank's gradient of a rank's piece)."""
    joint = torch.cat(all_gather(local, shard.group).unbind(0), dim=1)
    return joint[:, shard.text:shard.text + shard.image].contiguous()
