"""Plain float32 forwards of the two DiTs: miniFLUX and the SD3 MMDiT.

Written from the published architectures (FLUX.1's dual and single
blocks; SD3's joint blocks with a 2D sincos position table), over the
packed-token interface the pyramid uses: ``[B, L, 4C]`` latent tokens with
(t, h, w) positions and per-token time ids, after ``Lt`` text tokens. Keys
follow the released checkpoints (``transformer_blocks.{i}.attn.to_q.weight``
and so on), so :func:`param_specs` lists what the benchmark draws and both
sides receive.

Every matrix product goes through ``Precision.mm``, which rounds its two
operands to the precision under test first (none for the reference), so
the same code is the control at a lower precision. Attention is the plain
masked softmax, a few heads at a time so that the float32 scores fit.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .pyramid import INVALID_TIME


class Precision:
    """How the reference computes its products: float32 (``fmt`` None), or
    with each operand of every product rounded to ``fmt`` (a float8 dtype)
    under one scale per tensor, as a per-tensor-scaled low-precision matmul
    would see it."""

    def __init__(self, fmt: Optional[torch.dtype] = None):
        self.fmt = fmt

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.fmt is None:
            return x
        top = torch.finfo(self.fmt).max
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(self.fmt).float() * scale

    def mm(self, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.round(x) @ self.round(w).T
        return y if b is None else y + b


def _lin(P, W, name, x):
    return P.mm(x, W[name + ".weight"], W.get(name + ".bias"))


def layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def rms(x, g):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * g


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def rope(pos: torch.Tensor, axes: Tuple[int, ...]):
    """(cos, sin) [B, L, D/2] of per-axis interleaved-pair rotations."""
    cos, sin = [], []
    for i, d in enumerate(axes):
        omega = 1.0 / 10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64,
                                               device=pos.device) / d)
        ang = pos[..., i:i + 1].float() * omega.float()
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x, cos, sin):
    """x [B, H, L, D]: rotate pairs (2i, 2i + 1)."""
    c, s = cos[:, None], sin[:, None]
    e, o = x[..., 0::2], x[..., 1::2]
    return torch.stack([c * e - s * o, s * e + c * o], -1).flatten(-2)


def attention(P: Precision, q, k, v, times, heads_per_chunk: int = 4):
    """Softmax over visible keys: key time != INVALID and key time <= query
    time; a row with no visible key gives zeros. q, k, v [B, H, L, D]."""
    tq, tk = times[:, None, :, None], times[:, None, None, :]
    visible = (tk != INVALID_TIME) & (tk <= tq)
    any_visible = visible.any(-1, keepdim=True)
    scale = q.shape[-1] ** -0.5
    out = []
    for h in range(0, q.shape[1], heads_per_chunk):
        qs, ks, vs = (t[:, h:h + heads_per_chunk] for t in (q, k, v))
        s = (P.round(qs) @ P.round(ks).transpose(-1, -2)) * scale
        s = s.masked_fill(~visible, float("-inf"))
        p = torch.softmax(s.masked_fill(~any_visible, 0.0), -1) * any_visible
        out.append(P.round(p) @ P.round(vs))
    return torch.cat(out, 1)


def _heads(x, n):
    b, l, d = x.shape
    return x.reshape(b, l, n, d // n).transpose(1, 2)


def _unheads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _mlp(P, W, name, x):
    return _lin(P, W, name + ".linear_2",
                F.silu(_lin(P, W, name + ".linear_1", x)))


def _ff(P, W, name, x):
    h = F.gelu(_lin(P, W, name + ".net.0.proj", x), approximate="tanh")
    return _lin(P, W, name + ".net.2", h)


def _joint_attention(P, W, a, x, ctx, cos, sin, times, n, added):
    q = rms(_heads(_lin(P, W, a + ".to_q", x), n), W[a + ".norm_q.weight"])
    k = rms(_heads(_lin(P, W, a + ".to_k", x), n), W[a + ".norm_k.weight"])
    v = _heads(_lin(P, W, a + ".to_v", x), n)
    cq = rms(_heads(_lin(P, W, a + ".add_q_proj", ctx), n),
             W[f"{a}.norm_{added}_q.weight"])
    ck = rms(_heads(_lin(P, W, a + ".add_k_proj", ctx), n),
             W[f"{a}.norm_{added}_k.weight"])
    cv = _heads(_lin(P, W, a + ".add_v_proj", ctx), n)
    q = apply_rope(torch.cat([cq, q], 2), cos, sin)
    k = apply_rope(torch.cat([ck, k], 2), cos, sin)
    o = _unheads(attention(P, q, k, torch.cat([cv, v], 2), times))
    return o[:, ctx.shape[1]:], o[:, :ctx.shape[1]]


def _modulated(x, shift, scale):
    return layer_norm(x) * (1 + scale) + shift


def _joint_block(P, W, blk, x, ctx, temb, cos, sin, times, n, added,
                 context_pre_only=False):
    st = F.silu(temb)
    m = _lin(P, W, blk + ".norm1.linear", st)[:, None].chunk(6, -1)
    mc = _lin(P, W, blk + ".norm1_context.linear", st)[:, None]
    if context_pre_only:
        c_scale, c_shift = mc.chunk(2, -1)
        nc = _modulated(ctx, c_shift, c_scale)
    else:
        mc = mc.chunk(6, -1)
        nc = _modulated(ctx, mc[0], mc[1])
    xa, ca = _joint_attention(P, W, blk + ".attn", _modulated(x, m[0], m[1]),
                              nc, cos, sin, times, n, added)
    x = x + m[2] * _lin(P, W, blk + ".attn.to_out.0", xa)
    x = x + m[5] * _ff(P, W, blk + ".ff", _modulated(x, m[3], m[4]))
    if context_pre_only:
        return x, ctx
    ctx = ctx + mc[2] * _lin(P, W, blk + ".attn.to_add_out", ca)
    ctx = ctx + mc[5] * _ff(P, W, blk + ".ff_context",
                            _modulated(ctx, mc[3], mc[4]))
    return x, ctx


def _single_block(P, W, blk, h, temb, cos, sin, times, n):
    shift, scale, gate = _lin(P, W, blk + ".norm.linear",
                              F.silu(temb))[:, None].chunk(3, -1)
    nh = _modulated(h, shift, scale)
    mlp = F.gelu(_lin(P, W, blk + ".proj_mlp", nh), approximate="tanh")
    a = blk + ".attn"
    q = apply_rope(rms(_heads(_lin(P, W, a + ".to_q", nh), n),
                       W[a + ".norm_q.weight"]), cos, sin)
    k = apply_rope(rms(_heads(_lin(P, W, a + ".to_k", nh), n),
                       W[a + ".norm_k.weight"]), cos, sin)
    v = _heads(_lin(P, W, a + ".to_v", nh), n)
    o = _unheads(attention(P, q, k, v, times))
    return h + gate * _lin(P, W, blk + ".proj_out", torch.cat([o, mlp], -1))


def _final(P, W, x, temb):
    scale, shift = _lin(P, W, "norm_out.linear",
                        F.silu(temb))[:, None].chunk(2, -1)
    return _lin(P, W, "proj_out", _modulated(x, shift, scale))


def _text_times(mask, times):
    text = torch.where(mask, 0, INVALID_TIME).to(times.dtype)
    return torch.cat([text, times], 1)


def _run(remat: bool, fn, *args):
    """A block, recomputed in the backward when ``remat`` and grad is on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def flux_forward(cfg: dict, W: Dict[str, torch.Tensor], tokens, pos, times,
                 text, mask, pooled, t, P: Precision = Precision(),
                 remat: bool = False):
    """miniFLUX: velocity tokens [B, L, in_channels]."""
    n = cfg["num_attention_heads"]
    temb = (_mlp(P, W, "time_text_embed.timestep_embedder",
                 timestep_embedding(t))
            + _mlp(P, W, "time_text_embed.text_embedder", pooled))
    ctx = _lin(P, W, "context_embedder", text)
    x = _lin(P, W, "x_embedder", tokens)
    b, lt = text.shape[:2]
    allpos = torch.cat([pos.new_zeros((b, lt, 3)), pos.float()], 1)
    cos, sin = rope(allpos, tuple(cfg["axes_dims_rope"]))
    tt = _text_times(mask, times)
    for i in range(cfg["num_layers"]):
        x, ctx = _run(remat, lambda x, ctx, i=i: _joint_block(
            P, W, f"transformer_blocks.{i}", x, ctx, temb, cos, sin, tt, n,
            "added"), x, ctx)
    h = torch.cat([ctx, x], 1)
    for i in range(cfg["num_single_layers"]):
        h = _run(remat, lambda h, i=i: _single_block(
            P, W, f"single_transformer_blocks.{i}", h, temb, cos, sin, tt, n),
            h)
    return _final(P, W, h[:, lt:], temb)


@functools.lru_cache(maxsize=2)
def sincos_table(d: int, grid: int, base: int) -> torch.Tensor:
    """SD3's 2D sincos table [grid, grid, d]: the first half of the
    channels encodes w, the second h (computed once per size; callers do
    not write to it)."""
    p = np.arange(grid, dtype=np.float32) / (grid / base)

    def emb(v):
        om = 1.0 / 10000 ** (np.arange(d // 4, dtype=np.float64) / (d / 4.0))
        out = np.einsum("m,d->md", v.astype(np.float64), om)
        return np.concatenate([np.sin(out), np.cos(out)], 1)

    w, h = np.meshgrid(p, p)
    tab = np.concatenate([emb(w.reshape(-1)), emb(h.reshape(-1))], 1)
    return torch.as_tensor(tab.reshape(grid, grid, d).astype(np.float32))


def _bilinear(tab, y, x):
    g = tab.shape[0]
    y, x = y.clamp(0, g - 1), x.clamp(0, g - 1)
    y0, x0 = y.floor().long(), x.floor().long()
    y1, x1 = (y0 + 1).clamp(max=g - 1), (x0 + 1).clamp(max=g - 1)
    fy, fx = (y - y0)[..., None], (x - x0)[..., None]
    return ((tab[y0, x0] * (1 - fx) + tab[y0, x1] * fx) * (1 - fy)
            + (tab[y1, x0] * (1 - fx) + tab[y1, x1] * fx) * fy)


def crop_origin(grid: int, h_lat: int, w_lat: int) -> Tuple[int, int]:
    """(top, left) of a latent h x w clip's patch grid centred in the
    table."""
    return (grid - h_lat // 2) // 2, (grid - w_lat // 2) // 2


def mmdit_forward(cfg: dict, W: Dict[str, torch.Tensor], tokens, pos, times,
                  text, mask, pooled, t, origin: Tuple[int, int],
                  P: Precision = Precision(), remat: bool = False):
    """SD3 MMDiT: velocity tokens [B, L, 4 in_channels]. ``origin`` is the
    current clip's crop of the sincos table."""
    n, d = cfg["num_attention_heads"], cfg["caption_projection_dim"]
    temb = (_mlp(P, W, "time_text_embed.timestep_embedder",
                 timestep_embedding(t))
            + _mlp(P, W, "time_text_embed.text_embedder", pooled))
    ctx = _lin(P, W, "context_embedder", text)
    pw = W["pos_embed.proj.weight"]
    x = P.mm(tokens, pw.permute(0, 2, 3, 1).reshape(pw.shape[0], -1),
             W["pos_embed.proj.bias"])
    grid = cfg["pos_embed_max_size"]
    tab = sincos_table(d, grid, cfg["sample_size"] // cfg["patch_size"]).to(
        tokens.device)
    x = x + _bilinear(tab, pos[..., 1].float() + origin[0],
                      pos[..., 2].float() + origin[1])
    b, lt = text.shape[:2]
    tpos = torch.cat([pos.new_zeros((b, lt, 1)), pos[..., :1].float()], 1)
    cos, sin = rope(tpos, (cfg["attention_head_dim"],))
    tt = _text_times(mask, times)
    last = cfg["num_layers"] - 1
    for i in range(cfg["num_layers"]):
        x, ctx = _run(remat, lambda x, ctx, i=i: _joint_block(
            P, W, f"transformer_blocks.{i}", x, ctx, temb, cos, sin, tt, n,
            "add", context_pre_only=i == last), x, ctx)
    return _final(P, W, x, temb)


def param_specs(family: str, cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the DiT, sorted by name."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    hd = cfg["attention_head_dim"]
    specs: List[Tuple[str, Tuple[int, ...]]] = []

    def lin(name, i, o, bias=True):
        specs.append((name + ".weight", (o, i)))
        if bias:
            specs.append((name + ".bias", (o,)))

    def mlp(name, i):
        lin(name + ".linear_1", i, d)
        lin(name + ".linear_2", d, d)

    def ff(name):
        lin(name + ".net.0.proj", d, 4 * d)
        lin(name + ".net.2", 4 * d, d)

    def joint(blk, added, pre_only=False):
        lin(blk + ".norm1.linear", d, 6 * d)
        lin(blk + ".norm1_context.linear", d, (2 if pre_only else 6) * d)
        a = blk + ".attn"
        for p in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                  "add_v_proj", "to_out.0"):
            lin(f"{a}.{p}", d, d)
        if not pre_only:
            lin(a + ".to_add_out", d, d)
        for p in ("norm_q", "norm_k", f"norm_{added}_q", f"norm_{added}_k"):
            specs.append((f"{a}.{p}.weight", (hd,)))
        ff(blk + ".ff")
        if not pre_only:
            ff(blk + ".ff_context")

    mlp("time_text_embed.timestep_embedder", 256)
    mlp("time_text_embed.text_embedder", cfg["pooled_projection_dim"])
    lin("context_embedder", cfg["joint_attention_dim"], d)
    lin("norm_out.linear", d, 2 * d)
    if family == "flux":
        lin("x_embedder", cfg["in_channels"], d)
        lin("proj_out", d, cfg["in_channels"])
        for i in range(cfg["num_layers"]):
            joint(f"transformer_blocks.{i}", "added")
        for i in range(cfg["num_single_layers"]):
            blk = f"single_transformer_blocks.{i}"
            lin(blk + ".norm.linear", d, 3 * d)
            lin(blk + ".proj_mlp", d, 4 * d)
            lin(blk + ".proj_out", 5 * d, d)
            for p in ("to_q", "to_k", "to_v"):
                lin(f"{blk}.attn.{p}", d, d)
            for p in ("norm_q", "norm_k"):
                specs.append((f"{blk}.attn.{p}.weight", (hd,)))
    else:
        p, c = cfg["patch_size"], cfg["in_channels"]
        specs.append(("pos_embed.proj.weight", (d, c, p, p)))
        specs.append(("pos_embed.proj.bias", (d,)))
        lin("proj_out", d, p * p * c)
        for i in range(cfg["num_layers"]):
            joint(f"transformer_blocks.{i}", "add",
                  pre_only=i == cfg["num_layers"] - 1)
    return sorted(specs)


def forward(family: str, cfg: dict, W, tokens, pos, times, text, mask,
            pooled, t, h_lat: int, w_lat: int, P: Precision = Precision(),
            remat: bool = False):
    """The family's forward at a current clip of latent size h x w;
    ``remat`` recomputes each block in the backward."""
    if family == "flux":
        return flux_forward(cfg, W, tokens, pos, times, text, mask, pooled, t,
                            P, remat)
    origin = crop_origin(cfg["pos_embed_max_size"], h_lat, w_lat)
    return mmdit_forward(cfg, W, tokens, pos, times, text, mask, pooled, t,
                         origin, P, remat)
