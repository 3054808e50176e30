"""An attention site of a DiT, and the state all sites of one DiT share.

Every attention module of the three DiT families subclasses
:class:`AttentionSite`. It keeps its projections and norms under the
released state-dict names, the ``Slot`` s that say how its q, k and v are
made, its output projection and ``attention``, the ``(module name, function
name)`` of the attention it calls. :meth:`AttentionSite.attend` runs the
rest: q, k and v through :func:`~..ops.qk_norm_rope.qkv_heads`,
``capture_qk``'s telemetry, the attention or the graph seam in its place
(``models.dit_graphs``), and the join of the heads. The function is looked
up by name at every call, and a seam records the name, so a wrapper set on
it later (a test's spy, the benchmark's profiler range) sees every call,
replayed ones included.

A DiT (``models.dit_base``) gives all of its sites one :class:`SiteState`;
a site built alone (a block in a test) has one of its own, idle.
"""

from __future__ import annotations

import contextlib
import sys
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.qk_norm_rope import Slot, qkv_heads
from ..parallel.comm import all_gather

__all__ = ["AttentionSite", "SiteState"]


class SiteState:
    """What every attention site of one DiT reads on each forward, None when
    idle: ``seam``, the graph capture in progress, called in place of the
    attention; ``capture``, the list ``capture_qk`` yields; ``sp_group``,
    the sp process group of the DiT's mesh (each site then holds this
    rank's shard of the joint sequence)."""

    def __init__(self):
        self.seam = None
        self.capture: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self.sp_group = None

    @contextlib.contextmanager
    def seamed(self, seam):
        """Within the block, every site calls ``seam(module, name, q, k, v,
        rest)`` in place of ``getattr(module, name)(q, k, v, *rest)``."""
        self.seam = seam
        try:
            yield
        finally:
            self.seam = None


class AttentionSite(nn.Module):
    """An attention module's shared tail; see the module docstring. A
    subclass sets ``num_heads`` and ``attention``."""

    attention: Tuple[str, str]  # (module name, function name)

    def __init__(self):
        super().__init__()
        self.state = SiteState()

    def attend(self, slots: Sequence[Slot], *rest, cos=None, sin=None
               ) -> torch.Tensor:
        """``attention(q, k, v, *rest)`` on the site's ``slots``, rotated by
        ``cos``/``sin`` where a slot asks for it, as ``[B, L, H * Dh]``."""
        q, k, v = qkv_heads(slots, self.num_heads, cos, sin)
        state = self.state
        if state.capture is not None:
            self._capture(q, k)
        module, name = sys.modules[self.attention[0]], self.attention[1]
        if state.seam is None:
            o = getattr(module, name)(q, k, v, *rest)
        else:
            o = state.seam(module, name, q, k, v, rest)
        b, h, l, d = o.shape
        return o.transpose(1, 2).reshape(b, l, h * d)

    def _capture(self, q, k) -> None:
        q, k = q[:1].detach(), k[:1].detach()
        group = self.state.sp_group
        if group is not None and dist.get_world_size(group) > 1:
            q, k = (torch.cat(all_gather(t, group).unbind(0), dim=2)
                    for t in (q, k))
        self.state.capture.append((q, k))
