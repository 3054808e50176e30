"""The fused pass from an attention's q, k and v projections to its joint
layout (``ops/qk_norm_rope.py``, ``csrc/qk_norm_rope.cu``).

On the CPU:

* the kernel's plain version (one rounding) equals the attention modules'
  composition (``RMSNorm``, ``torch.cat``, ``apply_rope``) computed in fp32,
  bit for bit, for a per-head and a full-width norm group, joined and single
  sources, with and without RoPE, and a plain copy; in bf16 the two are
  within two bf16 ulps of each rotated pair's magnitude;
* what the kernel refuses, before any launch: malformed slots, and inputs
  that need a gradient (it has no backward);
* ``composition()`` is what asks for the composition: the train step opens
  it over its forwards and backward (a remat block's recompute included),
  ``capture_qk`` over its block, and nothing else;
* on the CPU every attention module keeps its composition: the kernel's
  counters do not move, and a miniFLUX dual and single block, an SD3 block
  and a Wan block give the outputs and gradients of the code they ran
  before, bit for bit.

On the card (``gpu``, skipped without one), at each family's real shapes
(miniFLUX's dual site at 128 text + 3072 latent tokens and its single site,
24 x 64 heads, axes 16/24/24; SD3's, one temporal axis over 64; Wan's
self-attention, 40 x 128 heads normalised over 5120, axes 44/42/42, and its
cross-attention, q over 2944 tokens and k and v over 512 text tokens, no
RoPE): the kernel against its plain version and against the composition,
one launch per site, v copied bit for bit; its refusals (an fp32 or
non-contiguous input, a wrong shape, a gradient); a CUDA-graph replay equal
to the eager call bit for bit; and bf16 blocks that launch it once per
attention without autograd, raise under autograd, and compose inside
``composition()``. No JAX: on the card this file runs as

    python -m pytest tests/test_torch_port_qk_norm_rope.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer)
from pyramid_flow_tpu_torch.models.mmdit import blocks as mmdit_blocks
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.models.wan import blocks as wan_blocks
from pyramid_flow_tpu_torch.ops.qk_norm_rope import (
    Slot, check_slots, composing, composition, qk_norm_rope_composed,
    qk_norm_rope_cuda, qk_norm_rope_reference, qkv_heads, split_heads)
from pyramid_flow_tpu_torch.ops.rope import apply_rope, rope_freqs
from pyramid_flow_tpu_torch.pipeline.noising import GeneratorDraws
from pyramid_flow_tpu_torch.schedulers.flow_matching import (
    PyramidFlowMatchEulerDiscreteScheduler)
from pyramid_flow_tpu_torch.training.train_state import create_train_state
from pyramid_flow_tpu_torch.training.trainer import make_train_step

RMSNorm = flux_blocks.RMSNorm

# each family's attention sites at a 384x640 request's unit 15 stage 2 (B =
# 2, the CFG rows): heads, head dim, norm group, text tokens, latent tokens,
# RoPE axes (None: no rotation; then k and v come from TEXT_LEN text tokens)
SITES = dict(
    flux_dual=(24, 64, "head", 128, 3072, (16, 24, 24)),
    flux_single=(24, 64, "head", 0, 3200, (16, 24, 24)),
    sd3=(24, 64, "head", 128, 3072, (64,)),
    wan_self=(40, 128, "token", 0, 2944, (44, 42, 42)),
    wan_cross=(40, 128, "token", 0, 2944, None))
TEXT_LEN = 512


# ---------------------------------------------------------------- helpers
def site(name, dtype=torch.bfloat16, device="cuda", b=2, seed=0,
         small=False):
    """``(slots, num_heads, cos, sin)`` of site ``name``: q and k
    normalised (and rotated), v copied; sources 3 N(0, 1), gains
    1 + N(0, 0.2), latent positions on a half-pixel grid. ``small`` keeps
    the structure at 3 heads, 5 text and 11 latent tokens."""
    g = torch.Generator().manual_seed(seed)
    heads, dh, group, lt, lx, axes = SITES[name]
    if small:
        heads, lt, lx = 3, min(lt, 5), 11
    width = heads * dh

    def src(n):
        return (3 * torch.randn((b, n, width), generator=g)).to(device, dtype)

    def norm():
        return _norm(dh if group == "head" else width, dtype, device, g)

    if axes is None:
        text = 7 if small else TEXT_LEN
        return ((Slot((src(lx),), (norm(),)), Slot((src(text),), (norm(),)),
                 Slot((src(text),))), heads, None, None)
    lens = (lt, lx) if lt else (lx,)
    slots = tuple(Slot(tuple(src(n) for n in lens),
                       tuple(norm() for _ in lens), True) for _ in range(2))
    slots += (Slot(tuple(src(n) for n in lens)),)
    cos, sin = rope_freqs(_positions(b, lt, lx, axes, seed).to(device), axes)
    return slots, heads, cos, sin


def pair_ulps(got, want) -> float:
    """The largest distance between two bf16 ``[..., D]`` tensors in ulps of
    each rotated pair's magnitude (a rotation spreads one rounding of its
    input over both of its outputs)."""
    a, w = got.float(), want.float()
    mag = w.unflatten(-1, (-1, 2)).norm(dim=-1).repeat_interleave(2, dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return ((a - w).abs() / ulp).max().item()


def _positions(b, lt, lx, axes, g):
    """Text at 0 on every axis, then latent (t, h, w) positions, some of
    them fractional as a low-resolution stage's are."""
    lat = torch.from_numpy(
        np.random.default_rng(g).integers(0, 96, (b, lx, len(axes)))
        .astype(np.float32) / 2)
    return torch.cat([torch.zeros(b, lt, len(axes)), lat], dim=1)


def _norm(width, dtype, device, g, eps=1e-6):
    norm = RMSNorm(width, eps, dtype=dtype, device=device)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.2 * torch.randn(width, generator=g))
    return norm


CASES = tuple(SITES)


def _site(case, dtype=torch.float32, device="cpu", seed=0, small=True):
    return site(case, dtype, device, seed=seed, small=small)


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize("case", CASES)
def test_reference_is_the_composition_in_fp32(case):
    slots, heads, cos, sin = _site(case)
    want = qk_norm_rope_composed(slots, heads, cos, sin)
    got = qk_norm_rope_reference(slots, heads, cos, sin)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_reference_rounds_once_in_bf16(case):
    slots, heads, cos, sin = _site(case, torch.bfloat16, seed=1)
    want = qk_norm_rope_composed(slots, heads, cos, sin)
    got = qk_norm_rope_reference(slots, heads, cos, sin)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        if i == 2:  # v: a copy
            assert torch.equal(g, w)
        else:
            assert pair_ulps(g, w) <= 2
    # and the reference is the fp32 chain rounded once
    f32 = [Slot(tuple(s.float() for s in slot.sources),
                None if slot.norms is None else tuple(
                    _as_fp32(n) for n in slot.norms), slot.rope)
           for slot in slots]
    exact = qk_norm_rope_composed(f32, heads, cos, sin)
    for g, e in zip(got, exact):
        assert torch.equal(g, e.to(torch.bfloat16))


def _as_fp32(norm):
    twin = RMSNorm(norm.weight.shape[0], norm.eps)
    with torch.no_grad():
        twin.weight.copy_(norm.weight.float())
    return twin


def _refusals(slots, heads, cos):
    """Inputs the kernel refuses, each with a fragment of its message."""
    q, k, v = slots
    wide = q.sources[0]
    bad_gain = _norm(wide.shape[-1] // heads + 8, wide.dtype, wide.device,
                     torch.Generator().manual_seed(0))
    out = [
        ((q, k, v, v), "slots"),
        ((q._replace(sources=(wide[0],)),), "sources must be"),
        ((q._replace(sources=(wide, wide, wide)),), "1 or 2 sources"),
        ((q._replace(norms=q.norms + q.norms[:1]),), "one norm per source"),
        ((q._replace(norms=None),), "rotated slot"),
        ((q._replace(norms=(bad_gain,) * len(q.sources)),), "norm group"),
        ((q, k._replace(sources=tuple(s[:1] for s in k.sources))), "source"),
    ]
    if cos is not None:
        out.append(((q,), "cos"))  # cos is cut short for this one
    return out


@pytest.mark.parametrize("case", ["flux_dual", "wan_self"])
def test_refusals_before_a_launch(case):
    slots, heads, cos, sin = _site(case)
    before = (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured)
    for bad, msg in _refusals(slots, heads, cos):
        c = cos[:, :-1] if msg == "cos" else cos
        with pytest.raises((ValueError, TypeError), match=msg):
            check_slots(bad, heads, c, sin)
        with pytest.raises((ValueError, TypeError)):
            qk_norm_rope_cuda(bad, heads, c, sin)
    with pytest.raises(ValueError, match="width"):
        check_slots(slots, heads * 5, cos, sin)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        qk_norm_rope_cuda(slots, heads, cos, sin)  # the CPU
    assert (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured) == before


@pytest.mark.parametrize("case", ["flux_dual", "wan_cross"])
def test_kernel_refuses_a_gradient(case):
    """The kernel has no backward: inputs that need a gradient (the gains
    are parameters, or a source that requires one) are refused whatever the
    device, before a launch; without autograd they are not."""
    slots, heads, cos, sin = _site(case)
    before = (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured)
    leaf = slots[0].sources[0].detach().requires_grad_()
    plain = [s._replace(norms=None if s.norms is None else tuple(
        _frozen(n) for n in s.norms)) for s in slots]
    for bad in (slots, [plain[0]._replace(sources=(leaf,) + plain[0]
                                          .sources[1:])] + plain[1:]):
        with pytest.raises(RuntimeError, match="no backward"):
            qk_norm_rope_cuda(bad, heads, cos, sin)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        qk_norm_rope_cuda(slots, heads, cos, sin)
    assert (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured) == before


def _frozen(norm):
    twin = RMSNorm(norm.weight.shape[0], norm.eps)
    with torch.no_grad():
        twin.weight.copy_(norm.weight)
    twin.weight.requires_grad_(False)
    return twin


def test_composition_opens_and_closes():
    assert not composing()
    with composition():
        assert composing()
        with composition():
            assert composing()
        assert composing()
        with pytest.raises(KeyError), composition():
            raise KeyError("inside")
        assert composing()
    assert not composing()


def _tiny_dit(family):
    torch.manual_seed(0)
    if family == "flux":
        return PyramidFluxTransformer(FluxConfig(
            in_channels=16, num_layers=1, num_single_layers=1,
            attention_head_dim=8, num_attention_heads=2,
            joint_attention_dim=32, pooled_projection_dim=24,
            axes_dims_rope=(4, 2, 2)), device="cpu", remat=True)
    return PyramidDiffusionMMDiT(MMDiTConfig(
        sample_size=32, in_channels=4, num_layers=2, attention_head_dim=8,
        num_attention_heads=4, caption_projection_dim=32,
        pooled_projection_dim=24, joint_attention_dim=32,
        pos_embed_max_size=24), device="cpu", remat=True)


def _tiny_batch(b=4):
    g = torch.Generator().manual_seed(6)
    mask = torch.ones((b, 8), dtype=torch.bool)
    mask[:, 6:] = False
    return {"latents": 0.5 * torch.randn((b, 4, 8, 8, 4), generator=g),
            "text_emb": torch.randn((b, 8, 32), generator=g),
            "text_mask": mask, "pooled": torch.randn((b, 24), generator=g),
            "null_text_emb": torch.zeros((b, 8, 32)),
            "null_pooled": torch.zeros((b, 24))}


def _tiny_args(dit, frames=2, h=2, w=2):
    """A forward's inputs: one row, ``frames`` latent frames of h x w
    patches after 8 text tokens (the last 2 masked)."""
    g = torch.Generator().manual_seed(1)
    cfg = dit.config
    width = (cfg.in_channels if isinstance(dit, PyramidFluxTransformer)
             else cfg.token_dim)
    t, y, x = torch.meshgrid(torch.arange(frames), torch.arange(h),
                             torch.arange(w), indexing="ij")
    pos = torch.stack([t, y, x], -1).reshape(1, -1, 3).float()
    mask = torch.ones((1, 8), dtype=torch.bool)
    mask[:, 6:] = False
    return [torch.randn((1, pos.shape[1], width), generator=g), pos,
            t.reshape(1, -1), torch.randn((1, 8, 32), generator=g), mask,
            torch.randn((1, 24), generator=g), torch.tensor([500.0]),
            *dit.stage_inputs(1, 2 * h, 2 * w, "cpu")]


@pytest.mark.parametrize("family", ["flux", "mmdit"])
def test_train_step_and_capture_qk_ask_for_the_composition(family,
                                                           monkeypatch):
    """Every attention of a remat train step, its recompute in the backward
    included, and of a ``capture_qk`` block runs inside ``composition()``;
    a plain forward does not."""
    dit = _tiny_dit(family)
    seen = []
    for attn in dit.attention_modules:
        attn.register_forward_pre_hook(
            lambda m, a: seen.append(composing()))
    step = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler())
    step(create_train_state(dit), _tiny_batch(), GeneratorDraws(
        torch.Generator().manual_seed(5)), (3, 3, 2))
    assert not composing()
    n = dit.num_attention_calls
    # three stage forwards, then the backward's recompute of remat blocks
    assert len(seen) > 3 * n
    assert all(seen)
    seen.clear()
    with torch.no_grad():
        args = _tiny_args(dit)
        dit(*args)
        with dit.capture_qk() as captured:
            dit(*args)
    assert len(captured) == n
    assert seen == [False] * n + [True] * n


# The attention modules' forwards as they were before the fused pass, to
# hold the composition they still run to that code bit for bit.
def _unheads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _old_joint(self, x, ctx, rope_cos, rope_sin, time_ids, bounded=True):
    n = self.num_heads
    nq, nk = self.norm_q, self.norm_k
    naq = getattr(self, "norm_added_q", None) or self.norm_add_q
    nak = getattr(self, "norm_added_k", None) or self.norm_add_k
    q = nq(split_heads(self.to_q(x), n))
    k = nk(split_heads(self.to_k(x), n))
    v = split_heads(self.to_v(x), n)
    cq = naq(split_heads(self.add_q_proj(ctx), n))
    ck = nak(split_heads(self.add_k_proj(ctx), n))
    cv = split_heads(self.add_v_proj(ctx), n)
    lt = ctx.shape[1]
    q = apply_rope(torch.cat([cq, q], dim=2), rope_cos, rope_sin)
    k = apply_rope(torch.cat([ck, k], dim=2), rope_cos, rope_sin)
    v = torch.cat([cv, v], dim=2)
    o = _unheads(flux_blocks._attention(
        q, k, v, time_ids, self.causal, self.head_dim, self.state.sp_group,
        bounded))
    add_out = getattr(self, "to_add_out", None)
    return (self.to_out[0](o[:, lt:]),
            None if add_out is None else add_out(o[:, :lt]))


def _old_single(self, x, rope_cos, rope_sin, time_ids, bounded=True):
    n = self.num_heads
    q = apply_rope(self.norm_q(split_heads(self.to_q(x), n)), rope_cos,
                   rope_sin)
    k = apply_rope(self.norm_k(split_heads(self.to_k(x), n)), rope_cos,
                   rope_sin)
    v = split_heads(self.to_v(x), n)
    return _unheads(flux_blocks._attention(
        q, k, v, time_ids, self.causal, self.head_dim, self.state.sp_group,
        bounded))


def _old_wan_self(self, x, rope_cos, rope_sin, time_ids, bounded=False):
    n = self.num_heads
    q = apply_rope(split_heads(self.norm_q(self.q(x)), n), rope_cos,
                   rope_sin)
    k = apply_rope(split_heads(self.norm_k(self.k(x)), n), rope_cos,
                   rope_sin)
    v = split_heads(self.v(x), n)
    return self.o(_unheads(wan_blocks._attention(
        q, k, v, time_ids, True, self.head_dim, None, bounded)))


def _old_wan_cross(self, x, ctx, time_q, time_kv, bounded=False):
    n = self.num_heads
    q = split_heads(self.norm_q(self.q(x)), n)
    k = split_heads(self.norm_k(self.k(ctx)), n)
    v = split_heads(self.v(ctx), n)
    return self.o(_unheads(wan_blocks._cross_attention(
        q, k, v, time_q, time_kv, self.head_dim, bounded)))


OLD = {flux_blocks.JointAttention: _old_joint,
       flux_blocks.SingleAttention: _old_single,
       mmdit_blocks.MMDiTJointAttention: _old_joint,
       wan_blocks.WanSelfAttention: _old_wan_self,
       wan_blocks.WanCrossAttention: _old_wan_cross}


def _block(kind, dtype, device, heads=2, seed=0):
    """A block, its forward arguments and how many of the first ones take a
    gradient; weights N(0, 0.05) and qk-norm gains 1 + N(0, 0.05)."""
    torch.manual_seed(seed)
    head_dim = 128 if kind == "wan" else 64
    kw = dict(dtype=dtype, device=device)
    d, b, lt, lx = heads * head_dim, 2, 5, 12
    if kind == "flux_dual":
        blk = flux_blocks.FluxTransformerBlock(heads, head_dim, **kw)
    elif kind == "flux_single":
        blk = flux_blocks.FluxSingleTransformerBlock(heads, head_dim, **kw)
    elif kind == "sd3":
        blk = mmdit_blocks.JointTransformerBlock(heads, head_dim, **kw)
    else:
        blk = wan_blocks.WanAttentionBlock(d, 2 * d, heads, **kw)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            z = torch.randn(p.shape, device=device) * 0.05
            gain = name.split(".")[-2:][0].startswith("norm_")
            p.copy_(z + 1 if gain else z)
    g = torch.Generator().manual_seed(seed + 1)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(device, dt)

    times = torch.arange(lx).div(4, rounding_mode="floor")
    if kind == "wan":
        cos, sin = rope_freqs(_positions(b, 0, lx, (44, 42, 42), seed)
                              .to(device), (44, 42, 42))
        time_ids = times[None].expand(b, -1).to(device, torch.int32)
        args = (rnd(b, lx, d, dt=torch.float32), rnd(b, 6, d,
                                                     dt=torch.float32),
                rnd(b, 7, d), cos, sin, time_ids.contiguous(),
                torch.zeros((b, 7), dtype=torch.int32, device=device))
        return blk, args, 3
    axes = (64,) if kind == "sd3" else (16, 24, 24)
    cos, sin = rope_freqs(_positions(b, lt, lx, axes, seed).to(device), axes)
    time_ids = torch.cat([torch.zeros(b, lt, dtype=torch.int32),
                          times[None].expand(b, -1).int()], 1).to(device)
    temb = rnd(b, d)
    if kind == "flux_single":
        return blk, (rnd(b, lt + lx, d), temb, cos, sin, time_ids), 2
    return blk, (rnd(b, lx, d), rnd(b, lt, d), temb, cos, sin, time_ids), 3


def _run(blk, args, n_grad, old, monkeypatch):
    """The block's output and the gradients of its parameters and of its
    first ``n_grad`` inputs; with ``old``, every attention module runs its
    former forward."""
    with monkeypatch.context() as m:
        if old:
            for cls, fn in OLD.items():
                m.setattr(cls, "forward", fn)
        blk.zero_grad(set_to_none=True)
        leaves = [a.detach().requires_grad_(i < n_grad)
                  for i, a in enumerate(args)]
        out = blk(*leaves)
        outs = [t for t in (out if isinstance(out, tuple) else (out,))
                if t is not None]
        sum(((t.float() ** 2).mean() for t in outs)).backward()
        grads = [p.grad for p in blk.parameters()]
        grads += [a.grad for a in leaves if a.requires_grad]
    return [o.detach() for o in outs], grads


BLOCKS = ("flux_dual", "flux_single", "sd3", "wan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", BLOCKS)
def test_blocks_keep_the_composition_on_the_cpu(kind, dtype, monkeypatch):
    blk, args, n_grad = _block(kind, dtype, "cpu")
    before = (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured)
    outs, grads = _run(blk, args, n_grad, False, monkeypatch)
    want_outs, want_grads = _run(blk, args, n_grad, True, monkeypatch)
    assert (qk_norm_rope_cuda.launches, qk_norm_rope_cuda.captured) == before
    assert len(outs) == len(want_outs) and len(grads) == len(want_grads)
    for got, want in zip(outs + grads, want_outs + want_grads):
        assert got is not None and torch.equal(got, want)
    with torch.no_grad():  # no gradient, still the CPU
        again = blk(*args)
    again = again if isinstance(again, tuple) else (again,)
    for got, want in zip([t for t in again if t is not None], want_outs):
        assert torch.equal(got, want)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


def _card_site(case, seed=0):
    return _site(case, torch.bfloat16, "cuda", seed=seed, small=False)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_at_real_shapes(case, cuda):
    slots, heads, cos, sin = _card_site(case)
    before = qk_norm_rope_cuda.launches
    with torch.no_grad():
        got = qkv_heads(slots, heads, cos, sin)
        torch.cuda.synchronize()
    assert qk_norm_rope_cuda.launches - before == 1
    ref = qk_norm_rope_reference(slots, heads, cos, sin)
    composed = qk_norm_rope_composed(slots, heads, cos, sin)
    for i, (g, r, c) in enumerate(zip(got, ref, composed)):
        joint = sum(s.shape[1] for s in slots[i].sources)
        assert g.shape == (2, heads, joint, g.shape[-1]) and g.is_contiguous()
        assert torch.isfinite(g.float()).all()
        if i == 2:  # v
            assert _bit_equal(g, c)
        else:
            assert pair_ulps(g, r) <= 1, i
            assert pair_ulps(g, c) <= 2, i


@pytest.mark.gpu
def test_kernel_refuses(cuda):
    slots, heads, cos, sin = _card_site("flux_dual")
    q, k, v = slots
    before = qk_norm_rope_cuda.launches
    strided = q.sources[1].transpose(0, 1).contiguous().transpose(0, 1)
    bad = [
        ((q._replace(sources=(q.sources[0], strided)), k, v), "contiguous"),
        ((q._replace(sources=tuple(s.float() for s in q.sources)),), "bf16"),
        ((q, k._replace(sources=(k.sources[0][:, :, :-64], k.sources[1]))),
         "source"),
        ((q,), "cos"),
    ]
    with torch.no_grad():
        for slots_, msg in bad:
            c = cos[:, :-1] if msg == "cos" else cos
            with pytest.raises((ValueError, TypeError), match=msg):
                qkv_heads(slots_, heads, c, sin)
        with pytest.raises(ValueError, match="width"):
            qkv_heads(slots, heads - 1, cos, sin)
    # under autograd the gains are parameters that take a gradient
    with pytest.raises(RuntimeError, match="no backward"):
        qkv_heads(slots, heads, cos, sin)
    assert qk_norm_rope_cuda.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flux_dual", "wan_self", "wan_cross"])
def test_graph_replay_is_the_eager_call(case, cuda):
    slots, heads, cos, sin = _card_site(case, seed=3)
    with torch.no_grad():
        eager = qk_norm_rope_cuda(slots, heads, cos, sin)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        captured, launches = (qk_norm_rope_cuda.captured,
                              qk_norm_rope_cuda.launches)
        with torch.cuda.stream(stream):
            with torch.cuda.graph(graph, stream=stream):
                static = qk_norm_rope_cuda(slots, heads, cos, sin)
        torch.cuda.current_stream().wait_stream(stream)
        assert qk_norm_rope_cuda.captured - captured == 1
        assert qk_norm_rope_cuda.launches == launches
        for _ in range(2):
            for t in static:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for s, e in zip(static, eager):
                assert _bit_equal(s, e)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BLOCKS)
def test_blocks_launch_without_grad_and_compose_on_request(kind, cuda,
                                                           monkeypatch):
    """A bf16 block on the card launches the kernel once per attention
    without autograd and refuses autograd; inside ``composition()`` it
    launches none and gives the former forward's outputs and gradients bit
    for bit. An fp32 block on the card is refused (the kernel takes
    bf16)."""
    blk, args, n_grad = _block(kind, torch.bfloat16, "cuda")
    sites = 2 if kind == "wan" else 1
    before = qk_norm_rope_cuda.launches
    with torch.no_grad():
        fused = blk(*args)
    assert qk_norm_rope_cuda.launches - before == sites
    fused = fused if isinstance(fused, tuple) else (fused,)
    before = qk_norm_rope_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        _run(blk, args, n_grad, False, monkeypatch)
    with composition():
        outs, grads = _run(blk, args, n_grad, False, monkeypatch)
    assert qk_norm_rope_cuda.launches == before
    want_outs, want_grads = _run(blk, args, n_grad, True, monkeypatch)
    for got, want in zip(outs + grads, want_outs + want_grads):
        assert got is not None and torch.equal(got, want)
    # the fused forward is the composed one but for q/k's single rounding
    for got, want in zip([t for t in fused if t is not None], want_outs):
        err = ((got.float() - want.float()).norm() / want.float().norm())
        assert err.item() <= 2e-2
    blk32, args32, _ = _block(kind, torch.float32, "cuda")
    with torch.no_grad(), pytest.raises(TypeError, match="bf16"):
        blk32(*args32)
    assert qk_norm_rope_cuda.launches == before
