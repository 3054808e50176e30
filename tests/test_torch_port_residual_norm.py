"""The fused residual update and LayerNorm of the DiT blocks
(``ops/residual_norm.py``, ``csrc/residual_norm.cu``).

On the CPU:

* the kernel's plain version (``x'`` rounded to the stream's dtype, the
  norm of it rounded once) equals the blocks' composition computed in fp32,
  bit for bit, for every operand combination (no residual, a gated or a
  plain residual, each with adaLN's modulation, a LayerNorm's affine or no
  norm); in bf16 it is the fp32 chain on the rounded stream, rounded once;
* what the kernel refuses, before any launch: malformed operands, and
  inputs that need a gradient (it has no backward);
* on the CPU every block keeps the composition: the kernel's counters do
  not move, and a miniFLUX dual and single block, an SD3 block, SD3's last
  (context-pre-only) block and a Wan block give the outputs and gradients
  of the code they ran before, bit for bit, in fp32 and bf16.

On the card (``gpu``, skipped without one), at miniFLUX's dual-block site
(a bf16 stream of 2 x 3072 rows x 1536) and at Wan's (an fp32 stream of 2 x
2944 rows x 5120), for every operand combination: ``x'`` equal to the plain
version bit for bit and ``h`` within one bf16 ulp of its terms, and both
within the bf16 rounding of the composition; row counts that are not a
multiple of a block's rows and a stream with a batch stride of its own (the
slice ``norm_out`` reads); the refusals; a CUDA-graph replay equal to the
eager call bit for bit; and bf16 blocks that launch it three times per
stream of a dual block, twice per single block and four times per Wan
block without autograd, raise under autograd, and compose inside
``ops.composition.composition()``. No JAX: on the card this file runs as

    python -m pytest tests/test_torch_port_residual_norm.py -m gpu --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.blocks import layer_norm
from pyramid_flow_tpu_torch.models.mmdit import blocks as mmdit_blocks
from pyramid_flow_tpu_torch.models.wan import blocks as wan_blocks
from pyramid_flow_tpu_torch.ops.composition import composition
from pyramid_flow_tpu_torch.ops.residual_norm import (
    Norm, check_operands, residual_norm, residual_norm_composed,
    residual_norm_cuda, residual_norm_reference)
from test_torch_port_qk_norm_rope import _block, _run

# (stream dtype, batch rows, rows, width): miniFLUX's dual-block latent
# stream at a 384x640 request's unit 15 stage 2, and Wan's fp32 stream
SITES = dict(flux=(torch.bfloat16, 2, 3072, 1536),
             wan=(torch.float32, 2, 2944, 5120))
# (residual: None, "gated" or "plain"; norm: None, "mod" or "affine")
CASES = dict(norm=(None, "mod"), gated=("gated", None), plain=("plain", None),
             gated_mod=("gated", "mod"), plain_mod=("plain", "mod"),
             gated_affine=("gated", "affine"), affine=(None, "affine"))


# ---------------------------------------------------------------- helpers
def operands(case, dtype, b, rows, width, device="cpu", seed=0):
    """``(x, y, gate, norm)`` of ``case``: the stream 3 N(0, 1); y N(0, 1)
    in bf16 (the stream's dtype on the CPU in fp32); the gate and the
    modulation 0.5 N(0, 1), chunks of one ``[B, 6, D]`` tensor as the blocks
    cut them; an affine norm's weight 1 + N(0, 0.2) and bias N(0, 0.2) in
    bf16."""
    g = torch.Generator().manual_seed(seed)
    residual, kind = CASES[case]

    def rnd(*shape, s=1.0):
        return s * torch.randn(shape, generator=g)

    x = rnd(b, rows, width, s=3.0).to(device, dtype)
    y_dtype = torch.bfloat16 if dtype == torch.bfloat16 or device != "cpu" \
        else dtype
    y = rnd(b, rows, width).to(device, y_dtype) if residual else None
    mod = rnd(b, 6, width, s=0.5).to(device, dtype).chunk(6, dim=1)
    gate = mod[2] if residual == "gated" else None
    norm = None
    if kind == "mod":
        norm = Norm(mod[0], mod[1])
    elif kind == "affine":
        w_dtype = torch.bfloat16 if device != "cpu" else dtype
        norm = Norm(rnd(width, s=0.2).to(device, w_dtype),
                    (1 + rnd(width, s=0.2)).to(device, w_dtype), 1e-6, True)
    return x, y, gate, norm


def _ulp(mag):
    """A bf16 ulp at each magnitude."""
    return torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)


def term_ulps(got, want, x_out, norm, stream=None) -> float:
    """The largest distance between two bf16 ``h`` in bf16 ulps of the
    magnitude of its terms, ``|n * mul| + |add|`` (``n`` the normalised
    stream): a sum that cancels keeps the terms' rounding, not its own.
    With ``stream``, the magnitude of the residual's terms (``|x| + |gate
    * y|``), normalised and scaled as the stream is, counts too: a stream
    that rounds its product before the sum (the composition) passes that
    rounding on to ``h``."""
    xf = x_out.float()
    n = F.layer_norm(xf, xf.shape[-1:], eps=norm.eps)
    mul = norm.scale.float() if norm.affine else 1 + norm.scale.float()
    mag = (n * mul).abs() + norm.shift.float().abs()
    if stream is not None:
        rstd = torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True)
                           + norm.eps)
        mag = mag + stream * rstd * mul.abs()
    return ((got.float() - want.float()).abs() / _ulp(mag)).max().item()


def residual_terms(x, y, gate):
    """``|x| + |gate * y|`` (``|x|`` without a residual)."""
    if y is None:
        return x.float().abs()
    gy = y.float() if gate is None else gate.float() * y.float()
    return x.float().abs() + gy.abs()


def stream_ulps(got, want, x, y, gate) -> float:
    """The distance between two streams ``x'`` in ulps of their dtype at
    the magnitude ``|x| + |gate * y|``."""
    mag = residual_terms(x, y, gate)
    ulp = _ulp(mag) if got.dtype == torch.bfloat16 else _ulp(mag) / 2 ** 16
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _counts():
    return residual_norm_cuda.launches, residual_norm_cuda.captured


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize("case", CASES)
def test_reference_is_the_composition_in_fp32(case):
    x, y, gate, norm = operands(case, torch.float32, 2, 5, 48)
    want = residual_norm_composed(x, y, gate, norm)
    got = residual_norm_reference(x, y, gate, norm)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_reference_rounds_once_in_bf16(case):
    x, y, gate, norm = operands(case, torch.bfloat16, 3, 7, 64, seed=1)
    x_out, h = residual_norm_reference(x, y, gate, norm)
    if y is not None:  # the residual in fp32, rounded once
        assert torch.equal(x_out, (x.float() + (
            y.float() if gate is None else gate.float() * y.float())
        ).to(torch.bfloat16))
    else:
        assert torch.equal(x_out, x)
    if norm is None:
        assert h is None
        return
    # the norm of the stored stream in fp32, rounded once
    _, exact = residual_norm_composed(
        x_out.float(), norm=Norm(norm.shift.float(), norm.scale.float(),
                                 norm.eps, norm.affine))
    assert h.dtype == torch.bfloat16 and torch.equal(h, exact.bfloat16())
    # and within the composition's bf16 roundings
    want = residual_norm_composed(x, y, gate, norm)
    assert stream_ulps(want[0], x_out, x, y, gate) <= 1
    assert term_ulps(want[1].to(torch.bfloat16), h, x_out, norm,
                     residual_terms(x, y, gate)) <= 4


def _refusals(x, y, gate, norm):
    """Operands the kernel refuses, each with a fragment of its message."""
    b, l, d = x.shape
    mod = Norm(norm.shift, norm.scale)
    return [
        ((x[0], y, gate, norm), "must be"),
        ((x[..., :d - 4], None, None, Norm(mod.shift[..., :d - 4],
                                          mod.scale[..., :d - 4])), "width"),
        ((torch.zeros(b, l, 8200), None, None, None), "width"),
        ((x, y[:, :-1], gate, norm), "not the stream"),
        ((x, None, gate, norm), "gate needs a residual"),
        ((x, None, None, None), "residual or a norm"),
        ((x, y, gate[:1], norm), "gate"),
        ((x, y, gate, mod._replace(scale=mod.scale[:, :, :-8])), "scale"),
        ((x, y, gate, Norm(mod.shift, mod.scale[0, 0], 1e-6, True)),
         "shift"),
    ]


def test_refusals_before_a_launch():
    x, y, gate, norm = operands("gated_mod", torch.float32, 2, 5, 48)
    before = _counts()
    for bad, msg in _refusals(x, y, gate, norm):
        with pytest.raises((ValueError, TypeError), match=msg):
            check_operands(*bad)
        with pytest.raises((ValueError, TypeError)):
            residual_norm_cuda(*bad)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        residual_norm_cuda(x, y, gate, norm)  # the CPU
    leaf = x.detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        residual_norm_cuda(leaf, y, gate, norm)
    assert _counts() == before


# The blocks' forwards as they were before the fused pass, to hold the
# composition they still run to that code bit for bit.
def _old_ada_zero(self, x, temb):
    emb = self.linear(F.silu(temb))[:, None]
    shift, scale, gate, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, -1)
    return (layer_norm(x) * (1 + scale) + shift, gate, shift_mlp,
            scale_mlp, gate_mlp)


def _old_ada_single(self, x, temb):
    shift, scale, gate = self.linear(F.silu(temb))[:, None].chunk(3, -1)
    return layer_norm(x) * (1 + scale) + shift, gate


def _old_ada_continuous(self, x, temb):
    scale, shift = self.linear(F.silu(temb))[:, None].chunk(2, -1)
    return layer_norm(x) * (1 + scale) + shift


def _old_dual(self, x, ctx, temb, rope_cos, rope_sin, time_ids,
              bounded=True):
    pre_only = getattr(self, "context_pre_only", False)
    nx, gate, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb)
    if pre_only:
        nc = self.norm1_context(ctx, temb)
    else:
        nc, c_gate, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
            self.norm1_context(ctx, temb)
    x_attn, ctx_attn = self.attn(nx, nc, rope_cos, rope_sin, time_ids,
                                 bounded)
    x = x + gate * x_attn
    h = layer_norm(x) * (1 + scale_mlp) + shift_mlp
    x = x + gate_mlp * self.ff(h)
    if pre_only:
        return x, ctx
    ctx = ctx + c_gate * ctx_attn
    hc = layer_norm(ctx) * (1 + c_scale_mlp) + c_shift_mlp
    ctx = ctx + c_gate_mlp * self.ff_context(hc)
    return x, ctx


def _old_single(self, x, temb, rope_cos, rope_sin, time_ids, bounded=True):
    nx, gate = self.norm(x, temb)
    mlp = F.gelu(self.proj_mlp(nx), approximate="tanh")
    attn = self.attn(nx, rope_cos, rope_sin, time_ids, bounded)
    return x + gate * self.proj_out(torch.cat([attn, mlp], dim=-1))


def _old_modulate(x, shift, scale):
    return layer_norm(x) * (1 + scale) + shift


def _old_wan(self, x, e0, ctx, rope_cos, rope_sin, time_ids, time_kv,
             bounded=False):
    dtype = self.modulation.dtype
    e = (self.modulation.float() + e0).chunk(6, dim=1)
    y = self.self_attn(_old_modulate(x, e[0], e[1]).to(dtype), rope_cos,
                       rope_sin, time_ids, bounded)
    x = x + y.float() * e[2]
    n3 = F.layer_norm(x, x.shape[-1:], self.norm3.weight.float(),
                      self.norm3.bias.float(), self.eps)
    x = x + self.cross_attn(n3.to(dtype), ctx, time_ids, time_kv,
                            bounded).float()
    y = self.ffn(_old_modulate(x, e[3], e[4]).to(dtype))
    return x + y.float() * e[5]


OLD = {flux_blocks.AdaLayerNormZero: _old_ada_zero,
       flux_blocks.AdaLayerNormZeroSingle: _old_ada_single,
       flux_blocks.AdaLayerNormContinuous: _old_ada_continuous,
       flux_blocks.FluxTransformerBlock: _old_dual,
       mmdit_blocks.JointTransformerBlock: _old_dual,
       flux_blocks.FluxSingleTransformerBlock: _old_single,
       wan_blocks.WanAttentionBlock: _old_wan}
BLOCKS = ("flux_dual", "flux_single", "sd3", "sd3_last", "wan")
# fused residual norms per block in a serving forward
LAUNCHES = dict(flux_dual=6, flux_single=2, sd3=6, sd3_last=4, wan=4)


def _equal(got, want):
    return len(got) == len(want) and all(
        g is not None and w is not None and torch.equal(g, w)
        for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", BLOCKS)
def test_blocks_keep_their_former_bodies_on_the_cpu(kind, dtype,
                                                    monkeypatch):
    blk, args, n_grad = _block(kind, dtype, "cpu")
    before = _counts()
    outs, grads = _run(blk, args, n_grad, None, monkeypatch)
    want_outs, want_grads = _run(blk, args, n_grad, OLD, monkeypatch)
    assert _counts() == before
    assert _equal(outs, want_outs) and _equal(grads, want_grads)
    if kind == "sd3_last":  # the context comes back as it came
        assert torch.equal(outs[1], args[1])


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
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8))


def _check(got, x, y, gate, norm):
    """``got`` against the plain version (``x'`` bit-equal, ``h`` within one
    bf16 ulp of its terms) and the composition (``x'`` within one ulp of
    the stream's dtype, ``h`` within four of its terms and the residual's,
    whose product the composition rounds)."""
    ref = residual_norm_reference(x, y, gate, norm, torch.bfloat16)
    composed = residual_norm_composed(x, y, gate, norm, torch.bfloat16)
    x_out, h = got
    assert x_out.shape == x.shape and x_out.dtype == x.dtype
    assert _bit_equal(x_out, ref[0])
    if y is not None:
        assert x_out.is_contiguous() and x_out.data_ptr() != x.data_ptr()
        assert stream_ulps(x_out, composed[0], x, y, gate) <= 1
    if norm is None:
        assert h is None
        return
    assert h.dtype == torch.bfloat16 and h.is_contiguous()
    assert torch.isfinite(h.float()).all()
    assert term_ulps(h, ref[1], ref[0], norm) <= 1
    assert term_ulps(h, composed[1], ref[0], norm,
                     residual_terms(x, y, gate)) <= 4


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("site", SITES)
def test_kernel_matches_plain_at_real_shapes(site, case, cuda):
    x, y, gate, norm = operands(case, *SITES[site], device="cuda")
    before = residual_norm_cuda.launches
    with torch.no_grad():
        got = residual_norm(x, y, gate, norm, torch.bfloat16)
        torch.cuda.synchronize()
    assert residual_norm_cuda.launches - before == 1
    _check(got, x, y, gate, norm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 1536),
                                         (torch.float32, 5120),
                                         (torch.bfloat16, 264),
                                         (torch.float32, 2056)])
def test_ragged_rows_and_a_strided_stream(dtype, width, cuda):
    """21 rows (a block holds four rows of one warp), widths whose vectors
    leave a thread's last one empty, the stream as a slice of a longer one
    (``norm_out`` reads the latent rows after the text), and no rows."""
    for case in ("gated_mod", "norm", "plain"):
        x, y, gate, norm = operands(case, dtype, 3, 7, width, "cuda", seed=2)
        with torch.no_grad():
            _check(residual_norm_cuda(x, y, gate, norm, torch.bfloat16),
                   x, y, gate, norm)
    x, _, _, norm = operands("norm", dtype, 3, 12, width, "cuda", seed=3)
    view = x[:, 5:]
    assert not view.is_contiguous()
    with torch.no_grad():
        _check(residual_norm_cuda(view, None, None, norm, torch.bfloat16),
               view, None, None, norm)
    # no rows at all (a sequence-parallel rank's empty text shard): empty
    # outputs, and no launch
    x, y, gate, norm = operands("gated_mod", dtype, 2, 0, width, "cuda")
    before = _counts()
    with torch.no_grad():
        x_out, h = residual_norm_cuda(x, y, gate, norm, torch.bfloat16)
    assert x_out.shape == h.shape == x.shape and h.dtype == torch.bfloat16
    assert _counts() == before


@pytest.mark.gpu
def test_kernel_refuses(cuda):
    x, y, gate, norm = operands("gated_mod", *SITES["flux"], device="cuda")
    before = _counts()
    wan = operands("gated_mod", *SITES["wan"], device="cuda")
    bad = [
        ((x.float(), y, gate.float(), Norm(norm.shift.float(),
                                           norm.scale.float())), "bf16"),
        ((x, y.float(), gate, norm), "bf16 y"),
        ((x.half(), None, None, norm), "stream"),
        ((x, y.transpose(0, 1).contiguous().transpose(0, 1), gate, norm),
         "contiguous"),
        ((x.transpose(1, 2).contiguous().transpose(1, 2), y, gate, norm),
         "rows"),
        ((x, y, gate.float(), norm), "gate"),
        ((wan[0], wan[1], wan[2].bfloat16(), wan[3], torch.bfloat16),
         "gate"),
        ((x[..., :1532], None, None, Norm(norm.shift[..., :1532],
                                          norm.scale[..., :1532])), "width"),
    ]
    with torch.no_grad():
        for args, msg in bad:
            with pytest.raises((ValueError, TypeError), match=msg):
                residual_norm(*args)
    # under autograd a parameter (here the stream) takes a gradient
    with pytest.raises(RuntimeError, match="no backward"):
        residual_norm(x.requires_grad_(), y, gate, norm)
    assert _counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("site", SITES)
def test_graph_replay_is_the_eager_call(site, cuda):
    x, y, gate, norm = operands("gated_mod", *SITES[site], device="cuda",
                                seed=4)
    with torch.no_grad():
        eager = residual_norm_cuda(x, y, gate, norm, torch.bfloat16)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        captured, launches = _counts()[1], _counts()[0]
        with torch.cuda.stream(stream):
            with torch.cuda.graph(graph, stream=stream):
                static = residual_norm_cuda(x, y, gate, norm, torch.bfloat16)
        torch.cuda.current_stream().wait_stream(stream)
        assert _counts() == (launches, captured + 1)
        for _ in range(2):
            for t in static:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert all(_bit_equal(s, e) for s, e in zip(static, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BLOCKS)
def test_blocks_launch_without_grad_and_compose_on_request(kind, cuda,
                                                           monkeypatch):
    """A bf16 block on the card launches the kernel ``LAUNCHES[kind]``
    times without autograd and refuses autograd; inside ``composition()``
    it launches none and gives the former forward's outputs and gradients
    bit for bit; the fused forward is within 2e-2 relative L2 of it."""
    blk, args, n_grad = _block(kind, torch.bfloat16, "cuda")
    before = residual_norm_cuda.launches
    with torch.no_grad():
        fused = blk(*args)
    assert residual_norm_cuda.launches - before == LAUNCHES[kind]
    fused = fused if isinstance(fused, tuple) else (fused,)
    before = residual_norm_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        _run(blk, args, n_grad, None, monkeypatch)
    with composition():
        outs, grads = _run(blk, args, n_grad, None, monkeypatch)
        want_outs, want_grads = _run(blk, args, n_grad, OLD, monkeypatch)
    assert residual_norm_cuda.launches == before
    assert _equal(outs, want_outs) and _equal(grads, want_grads)
    for got, want in zip([t for t in fused if t is not None], want_outs):
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert err.item() <= 2e-2
