"""Plain float32 reference of Wan2.1's T2V DiT, and its request comparison.

Written from Wan2.1's ``wan/modules/model.py`` (``WanModel``, T2V
cross-attention, ``WanAttentionBlock``, ``Head``), over the packed-token
interface the pyramid uses: ``[B, L, 64]`` latent tokens (2x2 patches of 16
channels) with (t, h, w) positions and per-token time ids; text enters by
cross-attention only. Keys follow Wan's checkpoint
(``blocks.{i}.self_attn.q.weight`` and so on), so :func:`param_specs` lists
what the benchmark draws and both sides receive.

The weights may be held in bf16, as they are seeded: each matrix is cast to
float32 where it is used, so the 57 GB float32 model never exists, and
:func:`judge` and :func:`plain_request` turn TF32 off first, so a float32
product on the card is one. Every product goes through ``reference/dit.py``'s
``Precision``, as in the other families' reference, so the same code is the
float8 control. It reuses ``reference/dit.py``'s ``attention``, ``rope`` and
``timestep_embedding``.

Departures from Wan's code, each the pyramid pipeline's:

* self-attention masks by the pyramid's temporal-causal time ids (a key is
  visible when its time is valid and at most the query's); Wan attends
  both ways within one clip;
* RoPE angles come from the pipeline's positions, which are fractional for
  a lower-resolution history clip, in float32 (Wan: integer grid indices,
  float64);
* the timestep sinusoid is float32 (Wan: float64);
* the text is the T5 states with the mask's tokens kept and the rest zero,
  zero-padded to ``text_len``: Wan's trim and pad, for a prefix mask.

:func:`judge` and :func:`plain_request` are ``reference/t2v.py``'s, with
this forward in place of the two families' there.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .dit import (Precision, _heads, _unheads, apply_rope, attention,
                  layer_norm, rms, rope, timestep_embedding)
from .pyramid import (Layout, Tables, block_noise, initial_latent, patchify,
                      unpatchify, up2)
from .t2v import CHECKS, Noise, Request, Traffic, _units, rel

__all__ = ["param_specs", "forward", "judge", "plain_request"]


def _axes(cfg: dict) -> Tuple[int, int, int]:
    d = cfg["dim"] // cfg["num_heads"]
    return (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the DiT, sorted by name."""
    d, f = cfg["dim"], cfg["ffn_dim"]
    specs: List[Tuple[str, Tuple[int, ...]]] = []

    def lin(name, i, o):
        specs.extend([(name + ".weight", (o, i)), (name + ".bias", (o,))])

    pt, ph, pw = cfg["patch_size"]
    specs += [("patch_embedding.weight", (d, cfg["in_dim"], pt, ph, pw)),
              ("patch_embedding.bias", (d,))]
    lin("text_embedding.0", cfg["text_dim"], d)
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", cfg["freq_dim"], d)
    lin("time_embedding.2", d, d)
    lin("time_projection.1", d, 6 * d)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        for a in ("self_attn", "cross_attn"):
            for p in ("q", "k", "v", "o"):
                lin(f"{b}.{a}.{p}", d, d)
            specs += [(f"{b}.{a}.norm_q.weight", (d,)),
                      (f"{b}.{a}.norm_k.weight", (d,))]
        specs += [(f"{b}.norm3.weight", (d,)), (f"{b}.norm3.bias", (d,)),
                  (f"{b}.modulation", (1, 6, d))]
        lin(f"{b}.ffn.0", d, f)
        lin(f"{b}.ffn.2", f, d)
    lin("head.head", d, pt * ph * pw * cfg["out_dim"])
    specs.append(("head.modulation", (1, 2, d)))
    return sorted(specs)


def cross_attention(P: Precision, q, k, v, heads_per_chunk: int = 4):
    """Softmax over every key: q [B, H, Lq, D], k, v [B, H, Lk, D]."""
    scale = q.shape[-1] ** -0.5
    out = []
    for h in range(0, q.shape[1], heads_per_chunk):
        qs, ks, vs = (t[:, h:h + heads_per_chunk] for t in (q, k, v))
        p = torch.softmax((P.round(qs) @ P.round(ks).transpose(-1, -2))
                          * scale, -1)
        out.append(P.round(p) @ P.round(vs))
    return torch.cat(out, 1)


def _block(P, f, lin, blk, x, e0, ctx, cos, sin, times, n, eps):
    e = (f(blk + ".modulation") + e0).chunk(6, 1)
    a = blk + ".self_attn"
    h = layer_norm(x) * (1 + e[1]) + e[0]
    q = apply_rope(_heads(rms(lin(a + ".q", h), f(a + ".norm_q.weight")), n),
                   cos, sin)
    k = apply_rope(_heads(rms(lin(a + ".k", h), f(a + ".norm_k.weight")), n),
                   cos, sin)
    v = _heads(lin(a + ".v", h), n)
    x = x + lin(a + ".o", _unheads(attention(P, q, k, v, times))) * e[2]
    c = blk + ".cross_attn"
    h = F.layer_norm(x, x.shape[-1:], f(blk + ".norm3.weight"),
                     f(blk + ".norm3.bias"), eps)
    q = _heads(rms(lin(c + ".q", h), f(c + ".norm_q.weight")), n)
    k = _heads(rms(lin(c + ".k", ctx), f(c + ".norm_k.weight")), n)
    v = _heads(lin(c + ".v", ctx), n)
    x = x + lin(c + ".o", _unheads(cross_attention(P, q, k, v)))
    h = layer_norm(x) * (1 + e[4]) + e[3]
    y = lin(blk + ".ffn.2", F.gelu(lin(blk + ".ffn.0", h),
                                   approximate="tanh"))
    return x + y * e[5]


def forward(cfg: dict, W: Dict[str, torch.Tensor], tokens, pos, times, text,
            mask, t, P: Precision = Precision()):
    """Velocity tokens [B, L, 64] in float32."""
    d, n, eps = cfg["dim"], cfg["num_heads"], cfg["eps"]

    def f(name):
        return W[name].float()

    def lin(name, x):
        return P.mm(x, f(name + ".weight"), f(name + ".bias"))

    ctx = F.pad(text.float() * mask[..., None],
                (0, 0, 0, cfg["text_len"] - text.shape[1]))
    ctx = lin("text_embedding.2", F.gelu(lin("text_embedding.0", ctx),
                                         approximate="tanh"))
    e = lin("time_embedding.2", F.silu(lin(
        "time_embedding.0", timestep_embedding(t, cfg["freq_dim"]))))
    e0 = lin("time_projection.1", F.silu(e)).unflatten(1, (6, d))
    pw = f("patch_embedding.weight")
    x = P.mm(tokens.float(), pw.permute(0, 2, 3, 4, 1).reshape(d, -1),
             f("patch_embedding.bias"))
    cos, sin = rope(pos, _axes(cfg))
    for i in range(cfg["num_layers"]):
        x = _block(P, f, lin, f"blocks.{i}", x, e0, ctx, cos, sin, times, n,
                   eps)
    shift, scale = (f("head.modulation") + e[:, None]).chunk(2, 1)
    return lin("head.head", layer_norm(x) * (1 + scale) + shift)


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(lay: Layout, tokens, t: float):
    dev = tokens.device
    pos = torch.as_tensor(lay.positions, device=dev)[None].expand(2, -1, -1)
    times = torch.as_tensor(lay.time_ids, device=dev)[None].expand(2, -1)
    return pos, times, torch.full((2,), t, device=dev)


def judge(cfg: dict, W, req: Request, noise: Noise, text, tr: Traffic,
          seed: int, n_dit: int, dtype: torch.dtype,
          P: Precision = Precision(), stages: int = 3) -> Dict[str, float]:
    """``reference/t2v.py``'s five numbers for one request served by the
    Wan DiT. ``text`` is ``(emb [2, Lt, 4096], mask [2, Lt], pooled)`` as
    the rows were fed (the pooled text is not read)."""
    _no_tf32()
    tab = Tables(stages)
    units = _units(req, tr, stages)
    if not units:
        return {k: float("nan") for k in CHECKS}
    worst = {k: 0.0 for k in CHECKS}
    finals: Dict[int, torch.Tensor] = {}
    start = initial_latent(noise.initial, stages)

    def note(k, v):  # the worst reading; a NaN stays
        if worst[k] == worst[k] and not v <= worst[k]:
            worst[k] = v

    for u in sorted(units):
        prev = None
        for s in range(stages):
            fw = units[u][s]
            lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
            _, sig = tab.steps(len(fw), s)
            g = tr.guidance_of(u)
            xs = [unpatchify(f["cur"].float()[None], 1, lay.h, lay.w)
                  for f in fw]
            for i, f in enumerate(fw):
                v = f["v"].float()
                vg = v[0] + g * (v[1] - v[0])
                dt = float(torch.tensor(sig[i + 1]) - torch.tensor(sig[i]))
                step = dt * unpatchify(vg[None], 1, lay.h, lay.w)
                if i + 1 < len(fw):
                    note("euler", rel(xs[i + 1] - xs[i], step))
                else:
                    x_end = xs[i] + step
            if s == 0:
                want = start[:, u:u + 1]
                note("start", rel(xs[0], want.to(dtype).float()))
            else:
                a, b = tab.transition(s)
                want = a * up2(prev) + b * block_noise(noise.blocks[(u, s)],
                                                      tab.gamma)
                note("transition", rel(xs[0], want.to(dtype).float()))
            if u > 0:
                hist = lay.history_tokens([finals[j] for j in range(u)],
                                          dtype)[0]
                note("history", rel(fw[0]["cond"].float(), hist.float()))
            prev = x_end
        finals[u] = prev

    # the DiT on a sample drawn from the seed, with the longest layout in it
    flat = [(u, s, i) for u in sorted(units) for s in range(stages)
            for i in range(len(units[u][s]))]
    longest = max(flat, key=lambda k: (Layout(k[0], k[1], tr.h_lat, tr.w_lat,
                                              stages).length, k))
    pick = random.Random(seed).sample(flat, min(n_dit - 1, len(flat)))
    emb, mask, _ = text
    for (u, s, i) in sorted(set(pick) | {longest}):
        fw = units[u][s]
        lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
        ts, _ = tab.steps(len(fw), s)
        cur = fw[i]["cur"].float()
        tokens = torch.cat([fw[0]["cond"].float(), cur])[None].expand(2, -1,
                                                                     -1)
        pos, times, t = _inputs(lay, cur, float(ts[i]))
        out = forward(cfg, W, tokens, pos, times, emb, mask, t,
                      P)[:, -cur.shape[0]:]
        note("dit", rel(fw[i]["v"].float(), out))
    return worst


def plain_request(cfg: dict, W, noise: Noise, text, tr: Traffic, units: int,
                  token_dtype: torch.dtype, P: Precision, stages: int = 3
                  ) -> Request:
    """``reference/t2v.py``'s ``plain_request`` on the Wan DiT: the first
    ``units`` units of the request run by the reference in the program's
    place, tokens cast to ``token_dtype``, products at ``P``."""
    _no_tf32()
    tab = Tables(stages)
    emb, mask, _ = text
    low = initial_latent(noise.initial, stages)
    req, finals = Request(), []
    for u in range(units):
        x = low[:, u:u + 1]
        for s in range(stages):
            lay = Layout(u, s, tr.h_lat, tr.w_lat, stages)
            if s:
                a, b = tab.transition(s)
                x = a * up2(x) + b * block_noise(noise.blocks[(u, s)],
                                                 tab.gamma)
            cond = lay.history_tokens(finals, token_dtype)[0] if u else (
                x.new_zeros((lay.budget, x.shape[-1] * 4)))
            cond = cond.float()
            ts, sig = tab.steps(tr.steps_of(u)[s], s)
            g = tr.guidance_of(u)
            for i in range(len(ts)):
                cur = patchify(x.to(token_dtype)).float()[0]
                tokens = torch.cat([cond, cur])[None].expand(2, -1, -1)
                pos, times, t = _inputs(lay, cur, float(ts[i]))
                v = P.round(forward(cfg, W, tokens, pos, times, emb, mask, t,
                                    P)[:, -cur.shape[0]:])
                req.forwards.append(dict(unit=u, stage=s, step=i, cur=cur,
                                         v=v, **({"cond": cond} if i == 0
                                                 else {})))
                vg = v[0] + g * (v[1] - v[0])
                dt = float(torch.tensor(sig[i + 1]) - torch.tensor(sig[i]))
                x = x + dt * unpatchify(vg[None], 1, lay.h, lay.w)
        finals.append(x)
    return req
