"""The DiTs' piecewise CUDA graphs (``models.dit_graphs``).

On the CPU:

* the constant tables a forward reads (the timestep sinusoid's and RoPE's
  frequencies), now made once per device, equal the numpy formulas they
  replaced bit for bit;
* a forward of any of the three families that may not be graphed (on the
  CPU, under autograd, with ``capture_qk`` open, with an sp group, inside
  ``ops.composition.composition()``) runs eagerly, says why, and leaves the
  graph counters as they were;
* the seam that the DiT's shared site state holds during a capture is
  called in place of every attention, in call order, with the attention
  function's module and name and the arguments it takes;
* a toy two-block family on the DiT shell, whose attention function has a
  name of its own, runs through ``models.dit_graphs`` unedited: a capture's
  seams record its module and name, and making their recorded calls where
  a replay makes them gives the eager forward;
* at the published widths (on ``meta``) the sites keep their order, 57, 24
  and 80 per forward, beside 191, 143 and 160 fused residual norms;
* a deep copy or a pickle of a DiT starts with an empty graph cache.

On the card (``gpu``, skipped without one), reduced-depth miniFLUX, MMDiT
and Wan, CFG rows 2, two layouts: graphed and eager forwards agree to 1e-3
relative L2 and their attention outputs are bit-equal; the counters read
eager, capture, replay; a layout's graphs still replay after another
layout's; an output survives the next forward; an in-place weight update
is replayed and a replaced weight drops the graphs; a forward hook sees
every forward; a wrapper set on ``blocks._attention`` after capture is
called once per site that calls it per replay, and the flash forward is
launched ``num_attention_calls`` times; at full depth 57, 24 and 80 times
per forward (miniFLUX, the MMDiT, Wan), from 58, 25 and 81 graphs, the
fused q/k/v kernel (``ops.qk_norm_rope``) as often, and the fused
residual-norm kernel (``ops.residual_norm``) 191, 143 and 160 times. With
those kernels engaged, each family's eager, captured and replayed forwards
are bit-equal, and at the release widths within 1e-2 of the forward on the
composed chains, which launches neither. No JAX: on the
card this file runs as

    python -m pytest tests/test_torch_port_dit_graphs.py -m gpu --noconftest
"""

import ast
import copy
import io
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from pyramid_flow_tpu_torch.models import dit_graphs
from pyramid_flow_tpu_torch.models.attention_site import AttentionSite
from pyramid_flow_tpu_torch.models.dit_base import DiTBase
from pyramid_flow_tpu_torch.models.dit_graphs import (
    GRAPH_FORWARDS, bypass_reason)
from pyramid_flow_tpu_torch.models.flux import blocks as flux_blocks
from pyramid_flow_tpu_torch.models.flux.model import (
    FluxConfig, PyramidFluxTransformer, timestep_sinusoidal)
from pyramid_flow_tpu_torch.models.mmdit import blocks as mmdit_blocks
from pyramid_flow_tpu_torch.models.mmdit.model import (
    MMDiTConfig, PyramidDiffusionMMDiT)
from pyramid_flow_tpu_torch.models.wan import blocks as wan_blocks
from pyramid_flow_tpu_torch.models.wan.model import WanConfig, WanDiT
from pyramid_flow_tpu_torch.ops.flash_attention import flash_fwd_cuda
from pyramid_flow_tpu_torch.ops.composition import composition
from pyramid_flow_tpu_torch.ops.qk_norm_rope import Slot, qk_norm_rope_cuda
from pyramid_flow_tpu_torch.ops.residual_norm import residual_norm_cuda
from pyramid_flow_tpu_torch.ops.rope import rope_freqs
from pyramid_flow_tpu_torch.utils import profiling

FAMILIES = ("flux", "mmdit", "wan")
BLOCKS = {"flux": flux_blocks, "mmdit": mmdit_blocks, "wan": wan_blocks}


# ------------------------------------------------------------ the tables
def _numpy_sinusoidal(t, dim):
    """The sinusoid as it was computed before: numpy, uploaded per call."""
    half = dim // 2
    exponent = -np.log(10000.0) * np.arange(half, dtype=np.float32) / half
    freqs = torch.as_tensor(np.exp(exponent), device=t.device)
    arg = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def _numpy_rope(positions, axes_dim, theta=10000.0):
    outs_cos, outs_sin = [], []
    for i, dim in enumerate(axes_dim):
        scale = np.arange(0, dim, 2, dtype=np.float64) / dim
        omega = torch.as_tensor((1.0 / (theta ** scale)).astype(np.float32),
                                device=positions.device)
        ang = positions[..., i].float()[..., None] * omega
        outs_cos.append(torch.cos(ang))
        outs_sin.append(torch.sin(ang))
    return torch.cat(outs_cos, dim=-1), torch.cat(outs_sin, dim=-1)


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


@pytest.mark.parametrize("dim", [256, 8])
def test_sinusoid_table_is_the_numpy_one(dim):
    t = torch.tensor([0.0, 1.0, 17.25, 333.0, 999.0])
    assert _bit_equal(timestep_sinusoidal(t, dim), _numpy_sinusoidal(t, dim))


@pytest.mark.parametrize("axes", [(16, 24, 24), (4, 2, 2), (64,)])
def test_rope_tables_are_the_numpy_ones(axes):
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(
        (rng.integers(0, 40, (2, 9, len(axes))) / 4).astype(np.float32))
    for got, want in zip(rope_freqs(pos, axes), _numpy_rope(pos, axes)):
        assert _bit_equal(got, want)


# ------------------------------------------------------- the bypass rules
def _out_layer(dit):
    """The zero-initialised output projection."""
    return dit.head.head if isinstance(dit, WanDiT) else dit.proj_out


def _tiny(family):
    """A tiny CPU DiT whose output projection is not zero."""
    torch.manual_seed(0)
    if family == "flux":
        dit = PyramidFluxTransformer(FluxConfig(
            in_channels=16, num_layers=1, num_single_layers=2,
            attention_head_dim=8, num_attention_heads=2,
            joint_attention_dim=32, pooled_projection_dim=24,
            axes_dims_rope=(4, 2, 2)), device="cpu")
    elif family == "wan":
        dit = WanDiT(WanConfig(dim=256, ffn_dim=512, num_heads=2,
                               num_layers=2, text_len=16, text_dim=32),
                     device="cpu")
    else:
        dit = PyramidDiffusionMMDiT(MMDiTConfig(
            sample_size=32, in_channels=4, num_layers=2,
            attention_head_dim=8, num_attention_heads=4,
            caption_projection_dim=32, pooled_projection_dim=24,
            joint_attention_dim=32, pos_embed_max_size=24), device="cpu")
    nn.init.normal_(_out_layer(dit).weight, std=0.1)
    return dit


def _layout_inputs(dit, frames, h, w, text=8, rows=2, seed=0, dtype=None,
                   device="cpu"):
    """A forward's inputs: ``frames`` latent frames of h x w patches."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cfg = dit.config
    width = (cfg.in_channels if isinstance(dit, PyramidFluxTransformer)
             else cfg.token_dim)
    text_dim = getattr(cfg, "joint_attention_dim", None) or cfg.text_dim
    pooled_dim = getattr(cfg, "pooled_projection_dim", 0)  # Wan takes none
    dtype = dtype or torch.float32
    t, y, x = torch.meshgrid(torch.arange(frames), torch.arange(h),
                             torch.arange(w), indexing="ij")
    pos = torch.stack([t, y, x], -1).reshape(1, -1, 3).float()
    n = pos.shape[1]
    mask = torch.ones((rows, text), dtype=torch.bool)
    mask[:, text - 2:] = False
    args = [torch.randn((rows, n, width), generator=g).to(dtype),
            pos.expand(rows, -1, -1),
            t.reshape(1, -1).expand(rows, -1).to(torch.int64),
            torch.randn((rows, text, text_dim), generator=g).to(dtype),
            mask,
            torch.randn((rows, pooled_dim), generator=g).to(dtype),
            torch.rand((rows,), generator=g) * 1000]
    args = [a.to(device) for a in args]
    if isinstance(dit, PyramidDiffusionMMDiT):
        args += list(dit.stage_inputs(rows, 2 * h, 2 * w, device))
    return args


@pytest.fixture
def sp_group(tmp_path):
    """A one-rank gloo process group: an sp group the forward accepts on
    the CPU."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()


def _forward_recorded(dit, args):
    with profiling.recording() as rec:
        out = dit(*args)
    (fw,) = [s for s in rec.spans() if s.name == "dit.forward"]
    return out, fw.attrs["graph"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", ["device", "grad", "capture_qk", "sp",
                                  "composition"])
def test_bypassed_forwards_leave_the_counters(family, case, request):
    dit = _tiny(family)
    args = _layout_inputs(dit, 2, 2, 2)
    norms = (residual_norm_cuda.launches, residual_norm_cuda.captured)
    with torch.no_grad():
        want = dit._forward(*args)
    if case == "sp":
        dit.sites.sp_group = request.getfixturevalue("sp_group")
    before = dict(GRAPH_FORWARDS)
    for _ in range(3):  # a layout's second forward would be captured
        if case == "grad":
            assert bypass_reason(dit, args[0]) == "grad"
            out, how = _forward_recorded(dit, args)
            out = out.detach()
        elif case == "capture_qk":
            with torch.no_grad(), dit.capture_qk() as captured:
                assert bypass_reason(dit, args[0]) == "capture_qk"
                out, how = _forward_recorded(dit, args)
            assert len(captured) == dit.num_attention_calls
        elif case == "composition":
            with torch.no_grad(), composition():
                assert bypass_reason(dit, args[0]) == case
                out, how = _forward_recorded(dit, args)
        else:
            with torch.no_grad():
                assert bypass_reason(dit, args[0]) == case
                out, how = _forward_recorded(dit, args)
        assert how == "eager"
        assert torch.equal(out, want)
    assert GRAPH_FORWARDS == before
    assert dit.graphs.layouts == {}
    assert (residual_norm_cuda.launches, residual_norm_cuda.captured) == norms


def _summary(t):
    return tuple(t.shape) if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("family", FAMILIES)
def test_seam_takes_each_attention(family):
    """During a capture the sites call the shared state's seam in place of
    every attention, in call order, with the attention function's blocks
    module and name and the arguments it takes; making that call gives the
    eager forward's output."""
    dit = _tiny(family)
    args = _layout_inputs(dit, 2, 2, 3)
    calls, rests = [], []

    def seam(module, name, q, k, v, rest):
        calls.append((module, name, q.shape, k.shape, v.shape,
                      tuple(map(_summary, rest))))
        rests.append(rest)
        return getattr(module, name)(q, k, v, *rest)

    before = dict(GRAPH_FORWARDS)
    with torch.no_grad():
        want = dit(*args)
        with dit.sites.seamed(seam):
            got = dit._forward(*args)
    assert dit.sites.seam is None
    assert GRAPH_FORWARDS == before  # the CPU bypasses the graphs
    assert torch.equal(got, want)
    blocks, rows, latent = BLOCKS[family], 2, args[0].shape[1]
    # every attention's time ids end with the latent tokens' own
    assert all(torch.equal(r[0][:, -latent:], args[2].int()) for r in rests)
    if family == "wan":
        assert not any(r[1].any() for r in rests[1::2])  # text keys: t=0
        cfg = dit.config
        q = (rows, cfg.num_heads, latent, cfg.head_dim)
        kv = (rows, cfg.num_heads, cfg.text_len, cfg.head_dim)
        ids = (rows, latent)
        pair = [(blocks, "_attention", q, q, q,
                 (ids, True, cfg.head_dim, None, False)),
                (blocks, "_cross_attention", q, kv, kv,
                 (ids, (rows, cfg.text_len), cfg.head_dim, False))]
        assert calls == pair * cfg.num_layers
        return
    cfg, joint = dit.config, args[3].shape[1] + latent
    qkv = (rows, cfg.num_attention_heads, joint, cfg.attention_head_dim)
    assert calls == [(blocks, "_attention", qkv, qkv, qkv,
                      ((rows, joint), True, cfg.attention_head_dim, None,
                       True))] * dit.num_attention_calls


def _toy_attention(q, k, v, scale):
    """The toy family's attention, under a name of its own."""
    return torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v


class _ToyAttention(AttentionSite):
    attention = (__name__, "_toy_attention")

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v = (nn.Linear(dim, dim) for _ in range(3))

    def forward(self, x):
        return self.attend((Slot((self.q(x),)), Slot((self.k(x),)),
                            Slot((self.v(x),))),
                           (x.shape[-1] // self.num_heads) ** -0.5)


class _ToyBlock(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.attn = _ToyAttention(dim, num_heads)
        self.mlp = nn.Linear(dim, dim)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class _ToyDiT(DiTBase):
    def __init__(self):
        super().__init__(remat=False, bounded_softmax=True, mesh=None)
        self.embed = nn.Linear(4, 16)
        self.blocks = nn.ModuleList([_ToyBlock(16, 2) for _ in range(2)])
        self.out = nn.Linear(16, 4)
        self._share_sites()

    def _forward(self, tokens):
        x = self.embed(tokens)
        for block in self.blocks:
            x = self._run(block, x)
        return self.out(x)


def test_a_new_family_runs_through_the_graphs_unedited(monkeypatch):
    """A capture of the toy family, with CUDA graphs stood in for on the
    CPU by making each seam's recorded call where a replay makes it (as
    its next graph begins), gives the eager forward: the seams record the
    toy's own module, function name and arguments. The graphs module
    imports no family."""
    torch.manual_seed(0)
    dit = _ToyDiT()
    assert dit.num_attention_calls == 2
    x = torch.randn(2, 6, 4)
    with torch.no_grad():
        want, how = _forward_recorded(dit, [x])
        assert how == "eager"

        def begin(capture):
            if capture.seams:
                s = capture.seams[-1]
                s.o.copy_(getattr(s.module, s.name)(s.q, s.k, s.v, *s.rest))

        monkeypatch.setattr(dit_graphs._Capture, "begin", begin)
        monkeypatch.setattr(dit_graphs._Capture, "end", lambda capture: None)
        capture = dit_graphs._Capture(dit.graphs)
        with dit.sites.seamed(capture):
            got = dit._forward(x)
    assert torch.equal(got, want)
    assert [(s.module, s.name, s.rest) for s in capture.seams] == [
        (sys.modules[__name__], "_toy_attention", (8 ** -0.5,))] * 2
    tree = ast.parse(open(dit_graphs.__file__).read())
    imported = [n.module or "" for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
    assert not [m for m in imported
                if {"flux", "mmdit", "wan", "importlib"} & set(m.split("."))]


@pytest.mark.parametrize("family, calls, norms", [
    ("flux", 57, 191), ("mmdit", 24, 143), ("wan", 80, 160)])
def test_published_sites_in_registration_order(family, calls, norms):
    """At the release widths, on ``meta``: the sites are every block's
    attention in order (miniFLUX's dual blocks, then its single ones;
    Wan's self-, then cross-attention of each block), all on the DiT's one
    state; a serving forward's fused residual norms number ``norms``."""
    dit = {"flux": PyramidFluxTransformer(device="meta"),
           "mmdit": PyramidDiffusionMMDiT(device="meta"),
           "wan": WanDiT(device="meta")}[family]
    if family == "wan":
        want = [a for blk in dit.blocks
                for a in (blk.self_attn, blk.cross_attn)]
    else:
        want = [blk.attn for blk in (
            *dit.transformer_blocks,
            *getattr(dit, "single_transformer_blocks", ()))]
    got = dit.attention_modules
    assert len(got) == len(want) == dit.num_attention_calls == calls
    assert all(a is b for a, b in zip(got, want))
    assert all(a.state is dit.sites for a in got)
    assert dit.num_norm_calls == norms


@pytest.mark.parametrize("family", FAMILIES)
def test_copies_start_without_graphs(family):
    """A deep copy or a pickle of a DiT has its own empty graph cache, and
    runs as the original does."""
    dit = _tiny(family)
    dit.graphs.layouts[("a layout",)] = None  # stands for a captured one
    buf = io.BytesIO()
    torch.save(dit, buf)
    buf.seek(0)
    args = _layout_inputs(dit, 2, 2, 2)
    for twin in (copy.deepcopy(dit), torch.load(buf, weights_only=False)):
        assert twin.graphs is not dit.graphs
        assert twin.graphs.layouts == {}
        with torch.no_grad():
            assert torch.equal(twin(*args), dit._forward(*args))


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _seeded_(dit, seed=1):
    """N(0, 0.05) weights, 1 + N(0, 0.05) norm gains: a DiT whose output is
    not the zero of its zero-initialised projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            z = torch.randn(p.shape, generator=g, device=p.device) * 0.05
            gain = p.dim() == 1 and name.split(".")[-2].startswith("norm")
            p.copy_(z + 1 if gain else z)
    return dit


def _card_dit(family, full=False, layers=None):
    """A small DiT, or with ``full`` the release widths, at the release
    depth or ``layers`` blocks of each kind."""
    kw = dict(dtype=torch.bfloat16, device="cuda")
    depth = {} if layers is None else dict(num_layers=layers)
    if family == "flux":
        if layers is not None:
            depth["num_single_layers"] = layers
        cfg = FluxConfig(**depth) if full else FluxConfig(
            num_layers=2, num_single_layers=3, num_attention_heads=4,
            joint_attention_dim=128, pooled_projection_dim=64)
        return _seeded_(PyramidFluxTransformer(cfg, **kw))
    if family == "wan":
        cfg = WanConfig(**depth) if full else WanConfig(
            dim=512, ffn_dim=1024, num_heads=4, num_layers=3, text_len=64,
            text_dim=256)
        return _seeded_(WanDiT(cfg, **kw))
    cfg = MMDiTConfig(**depth) if full else MMDiTConfig(
        num_layers=3, num_attention_heads=4, caption_projection_dim=256,
        pooled_projection_dim=64, joint_attention_dim=128,
        pos_embed_max_size=48)
    return _seeded_(PyramidDiffusionMMDiT(cfg, **kw))


# two layouts: 2 frames of 6x8 patches, then 3 of 8x8, after 16 text tokens
LAYOUTS = ((2, 6, 8), (3, 8, 8))


def _card_inputs(dit, layout, seed=0):
    return _layout_inputs(dit, *layout, text=16, seed=seed,
                          dtype=torch.bfloat16, device="cuda")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


class _AttentionSpy:
    """Wraps every attention function the DiT's sites call and keeps a
    clone of each output, in call order."""

    def __init__(self, monkeypatch, dit):
        self.outputs = []
        for module, name in {a.attention for a in dit.attention_modules}:
            monkeypatch.setattr(sys.modules[module], name,
                                self._spy(getattr(sys.modules[module], name)))

    def _spy(self, fn):
        def spy(*a, **k):
            o = fn(*a, **k)
            self.outputs.append(o.clone())
            return o
        return spy

    def take(self):
        out, self.outputs = self.outputs, []
        return out


def _counts():
    return dict(GRAPH_FORWARDS)


def _delta(before):
    return {k: GRAPH_FORWARDS[k] - before[k] for k in GRAPH_FORWARDS}


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_graphed_forward_matches_eager(family, cuda, monkeypatch):
    dit = _card_dit(family)
    args = _card_inputs(dit, LAYOUTS[0])
    spy = _AttentionSpy(monkeypatch, dit)
    n = dit.num_attention_calls
    with torch.no_grad():
        want = dit._forward(*args)
        want_attn = spy.take()
        for how in ("eager", "capture", "replay", "replay"):
            before, launches = _counts(), flash_fwd_cuda.launches
            out, recorded = _forward_recorded(dit, args)
            assert recorded == how
            assert _delta(before) == {k: int(k == how) for k in before}
            assert flash_fwd_cuda.launches - launches == n
            assert _rel_l2(out, want) <= 1e-3
            got_attn = spy.take()
            assert len(got_attn) == n
            assert all(torch.equal(g, w) for g, w in zip(got_attn, want_attn))
    (layout,) = [v for v in dit.graphs.layouts.values() if v.graphs]
    assert len(layout.graphs) == n + 1 and len(layout.seams) == n


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_layouts_replay_after_each_other(family, cuda):
    dit = _card_dit(family)
    a, b = (_card_inputs(dit, lay, seed=i) for i, lay in enumerate(LAYOUTS))
    with torch.inference_mode():
        want_a, want_b = dit._forward(*a), dit._forward(*b)
        for args in (a, a, b, b):  # each layout eager, then captured
            dit(*args)
        before = _counts()
        got = [dit(*args) for args in (a, b, a, b)]
    assert _delta(before) == {"replay": 4, "capture": 0, "eager": 0}
    for out, want in zip(got, (want_a, want_b, want_a, want_b)):
        assert _rel_l2(out, want) <= 1e-3
    assert len([v for v in dit.graphs.layouts.values() if v.graphs]) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_output_survives_the_next_forward(family, cuda):
    dit = _card_dit(family)
    one, two = (_card_inputs(dit, LAYOUTS[0], seed=s) for s in (0, 1))
    with torch.no_grad():
        for _ in range(2):
            dit(*one)
        first = dit(*one)
        kept = first.clone()
        second = dit(*two)
        want = dit._forward(*two)  # eager, autograd off as in serving
        torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(second, first)
    assert _rel_l2(second, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_weight_updates_reach_the_replay(family, cuda):
    dit = _card_dit(family)
    args = _card_inputs(dit, LAYOUTS[0])
    with torch.no_grad():
        for _ in range(3):
            dit(*args)
        # in place: the graphs read the same storage
        out_layer = _out_layer(dit)
        out_layer.weight.mul_(-2)
        before = _counts()
        got = dit(*args)
        assert _delta(before)["replay"] == 1
        assert _rel_l2(got, dit._forward(*args)) <= 1e-3
        # a new tensor in the parameter's place, then new storage under
        # the same parameter: each drops the graphs, which the layout's
        # next two forwards capture again
        for replace in (
                lambda: setattr(out_layer, "weight", torch.nn.Parameter(
                    out_layer.weight * 0.5)),
                lambda: setattr(out_layer.weight, "data",
                                out_layer.weight.data * 3)):
            replace()
            for how in ("eager", "capture", "replay"):
                before = _counts()
                got = dit(*args)
                assert _delta(before) == {k: int(k == how) for k in before}
                assert _rel_l2(got, dit._forward(*args)) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_hooks_and_attention_wrapper_see_every_replay(family, cuda,
                                                       monkeypatch):
    dit = _card_dit(family)
    args = _card_inputs(dit, LAYOUTS[1])
    seen = []
    dit.register_forward_hook(lambda m, a, out: seen.append((a[0], out)))
    with torch.no_grad():
        outs = [dit(*args) for _ in range(2)]  # eager, captured
        blocks = BLOCKS[family]
        fn, calls = blocks._attention, []

        def wrapper(*a, **k):
            calls.append(1)
            return fn(*a, **k)

        monkeypatch.setattr(blocks, "_attention", wrapper)
        before = _counts()
        outs += [dit(*args) for _ in range(3)]
    assert _delta(before)["replay"] == 3
    sites = [a for a in dit.attention_modules
             if a.attention[1] == "_attention"]
    assert len(calls) == 3 * len(sites)
    assert len(seen) == 5
    assert all(a is args[0] and out is o for (a, out), o in zip(seen, outs))


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_replay_is_the_eager_forward_bit_for_bit(family, cuda):
    """With the fused q/k/v kernel engaged (one launch per attention, also
    in the span's ``qk_launches``) and the fused residual norm (the DiT's
    ``num_norm_calls``, also in ``norm_launches``), the layout's eager,
    captured and replayed forwards and ``_forward`` give the same bits."""
    dit = _card_dit(family)
    n, m = dit.num_attention_calls, dit.num_norm_calls
    assert m == {"flux": 19, "mmdit": 17, "wan": 12}[family]
    args = _card_inputs(dit, LAYOUTS[1])
    outs = []
    with torch.no_grad():
        for how in ("eager", "capture", "replay", "replay"):
            launches = qk_norm_rope_cuda.launches
            norms = residual_norm_cuda.launches
            out, recorded = _forward_recorded(dit, args)
            assert recorded == how
            assert qk_norm_rope_cuda.launches - launches == n
            assert residual_norm_cuda.launches - norms == m
            outs.append(out)
        with profiling.recording() as rec:
            dit(*args)
        (fw,) = [s for s in rec.spans() if s.name == "dit.forward"]
        assert fw.attrs["qk_launches"] == n
        assert fw.attrs["norm_launches"] == m
        want = dit._forward(*args)
    assert all(_bit_equal(out, want) for out in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_serving_forward_is_near_the_composed_forward(family, cuda):
    """At the release widths (two blocks of each kind), a serving forward,
    whose q, k and v and whose norms come from the fused kernels, stays
    within 1e-2 relative L2 of the same forward on the composed chains
    (``composition()``, which launches neither fused kernel and rounds
    more often). A forward inside ``composition()`` runs eagerly, so the
    layout's next forward, not it, is captured, with the kernels."""
    dit = _card_dit(family, full=True, layers=2)
    n, m = dit.num_attention_calls, dit.num_norm_calls
    args = _layout_inputs(dit, 2, 8, 8, text=128, dtype=torch.bfloat16,
                          device="cuda")
    with torch.no_grad():
        launches = qk_norm_rope_cuda.launches
        norms = residual_norm_cuda.launches
        fused = [dit(*args)]  # the layout's first forward: eager
        with composition():
            want, how = _forward_recorded(dit, args)
        assert how == "eager"
        assert qk_norm_rope_cuda.launches - launches == n
        assert residual_norm_cuda.launches - norms == m
        for expect in ("capture", "replay"):
            out, how = _forward_recorded(dit, args)
            assert how == expect
            fused.append(out)
        assert qk_norm_rope_cuda.launches - launches == 3 * n
        assert residual_norm_cuda.launches - norms == 3 * m
    assert all(_bit_equal(out, fused[0]) for out in fused)
    assert torch.isfinite(want.float()).all()
    assert _rel_l2(fused[0], want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_full_depth_launches_per_forward(family, cuda):
    dit = _card_dit(family, full=True)
    n = {"flux": 57, "mmdit": 24, "wan": 80}[family]
    m = {"flux": 191, "mmdit": 143, "wan": 160}[family]
    assert dit.num_attention_calls == n and dit.num_norm_calls == m
    args = _layout_inputs(dit, 2, 8, 8, text=128, dtype=torch.bfloat16,
                          device="cuda")
    with torch.no_grad():
        want = dit._forward(*args)
        for _ in range(3):
            launches = flash_fwd_cuda.launches
            fused = qk_norm_rope_cuda.launches
            norms = residual_norm_cuda.launches
            got = dit(*args)
            assert flash_fwd_cuda.launches - launches == n
            assert qk_norm_rope_cuda.launches - fused == n
            assert residual_norm_cuda.launches - norms == m
        assert _rel_l2(got, want) <= 1e-3
    (layout,) = [v for v in dit.graphs.layouts.values() if v.graphs]
    assert len(layout.graphs) == n + 1
    del dit, layout
    torch.cuda.empty_cache()
