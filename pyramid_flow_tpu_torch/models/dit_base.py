"""The shell of every DiT family (miniFLUX, the SD3 MMDiT, Wan2.1).

:class:`DiTBase` owns the ``forward`` (the family's ``_forward`` in a
``dit.forward`` span, eager or replayed from CUDA graphs,
``models.dit_graphs``), ``sites`` (the one
:class:`~.attention_site.SiteState` all of its attention sites share: the
graph seam, ``capture_qk``'s list and ``set_mesh``'s sp group), the list of
those sites, ``remat`` and the joint [text; latent] time ids and sp shard
of the two joint-attention families. A family keeps its config, embedders
and ``_forward``, builds its blocks after ``DiTBase.__init__`` and then
calls ``_share_sites``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import FORWARD_LAUNCHES, INVALID_TIME
from ..ops.qk_norm_rope import QK_LAUNCHES, composition
from ..parallel.mesh import SP_AXIS, mesh_dim
from ..parallel.sp import SeqShard
from ..utils.profiling import span
from .attention_site import AttentionSite, SiteState
from .dit_graphs import ForwardGraphs

__all__ = ["DiTBase", "DIT_COUNTERS"]

# a ``dit.forward`` span's counters: flash-forward and fused q/k/v launches
DIT_COUNTERS = {**FORWARD_LAUNCHES, **QK_LAUNCHES}


class DiTBase(nn.Module):
    """A DiT's shell; see the module docstring."""

    span_counters = DIT_COUNTERS

    def __init__(self, *, remat: bool, bounded_softmax: bool, mesh):
        super().__init__()
        self.remat = remat
        self.bounded_softmax = bounded_softmax
        self.sites = SiteState()
        self.graphs = ForwardGraphs()
        self.set_mesh(mesh)

    def _share_sites(self) -> None:
        """Give every attention site the DiT's state."""
        for site in self.attention_modules:
            site.state = self.sites

    @property
    def sp_group(self):
        """The sp process group of the mesh, None below sp 2."""
        return self.sites.sp_group

    def set_mesh(self, mesh) -> None:
        """Run on ``mesh`` (None: one device); with an sp dim above 1 every
        attention is Ulysses' over the mesh's sp group."""
        self.sites.sp_group = (mesh.get_group(SP_AXIS)
                               if mesh_dim(mesh, SP_AXIS) > 1 else None)

    @property
    def attention_modules(self) -> List[AttentionSite]:
        """Every attention site, in registration order."""
        return [m for m in self.modules() if isinstance(m, AttentionSite)]

    @property
    def num_attention_calls(self) -> int:
        """Attentions in one forward: one per site."""
        return len(self.attention_modules)

    @contextlib.contextmanager
    def capture_qk(self) -> Iterator[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Within the block, every attention appends batch row 0's post-RoPE
        ``(q, k)`` ``[1, H, L, D]`` to the yielded list, in call order.
        Capture without autograd: under ``remat`` a block's recompute in the
        backward would append again. The attentions run the composed q/k
        chain (``ops.qk_norm_rope.composition``), whatever the DiT's dtype
        (the telemetry probe also reads a training DiT's fp32 masters)."""
        self.sites.capture = captured = []
        try:
            with composition():
                yield captured
        finally:
            self.sites.capture = None

    def _run(self, block, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def _span_attrs(self) -> dict:
        """The ``dit.forward`` span's attributes after rows and tokens."""
        return {}

    def forward(self, *inputs):
        """``_forward(*inputs)`` in a ``dit.forward`` span, eager or
        replayed from the layout's graphs."""
        tokens = inputs[0]
        with span("dit.forward", counters=self.span_counters,
                  rows=tokens.shape[0], tokens=tokens.shape[1],
                  **self._span_attrs()) as record:
            return self.graphs(self, self._forward, inputs, record)

    def _joint(self, ctx, x, cos, sin, text_mask, latent_time):
        """The joint sequence's time ids (text t=0, masked-out text
        INVALID), and under sp this rank's shard of it: ``(ctx, x, cos,
        sin, time_ids, shard)``, ``shard`` None without sp."""
        text_time = torch.where(text_mask, 0, INVALID_TIME).to(torch.int32)
        time_ids = torch.cat([text_time, latent_time.to(torch.int32)], dim=1)
        shard = SeqShard.of(self.sp_group, ctx.shape[1], x.shape[1])
        if shard is not None:
            ctx, x = shard.split(ctx, x)
            cos, sin = shard.local(cos, 1), shard.local(sin)
            time_ids = shard.pad(time_ids, INVALID_TIME)
        return ctx, x, cos, sin, time_ids, shard
