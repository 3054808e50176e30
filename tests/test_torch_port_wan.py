"""The Wan2.1 T2V DiT (``models/wan``), the port's third DiT family.

On the CPU at tiny widths (dim 256, 2 heads of 128, 2 layers, text_len 16):

* the forward against the benchmark's plain float32 reference
  (``portbench/reference/wan.py``) on the same seeded weights, at pyramid
  layouts with history, padding, two CFG rows and text masks;
* a temp-3 request through ``PyramidFlowPipeline.generate`` (the benchmark's
  Wan traffic generator drives it), held by the reference's judge to the
  cell's limits, forward by forward equal to the reference's own request in
  float32; the float8 control fails the same limits;
* the published widths on the ``meta`` device: 14,288,491,584 parameters,
  and the model FLOPs the benchmark counts for them;
* the defaults (``bounded_softmax`` False), the refusals (an sp or fsdp
  mesh, too much text, the release-checkpoint loader) and the span tree
  (one ``wan.cross_attn`` per block in every ``dit.forward``); the graph
  seams are ``test_torch_port_dit_graphs.py``'s, for all three families;
* the reference imports nothing of the program or of JAX.

On the card (``gpu``, skipped without one): at reduced depth and head dim
128, a replayed forward equals the layout's eager forward bit for bit at two
layouts, from ``2 L + 1`` graphs, launching ``2 L`` flash forwards, ``L`` of
them cross-attention, and ``4 L`` fused residual norms. No JAX: on the card this file runs as

    python -m pytest tests/test_torch_port_wan.py -m gpu --noconftest
"""

import ast
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import seeded  # noqa: E402
from portbench.harness.cell import Bench, run  # noqa: E402
from portbench.reference import t2v as ref_t2v  # noqa: E402
from portbench.reference import wan as ref_wan  # noqa: E402
from portbench.reference.dit import Precision  # noqa: E402
from portbench.reference.pyramid import Layout  # noqa: E402
from pyramid_flow_tpu_torch.models.wan.model import (  # noqa: E402
    WanConfig, WanDiT)
from pyramid_flow_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_fwd_cuda)
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (  # noqa: E402
    PyramidFlowPipeline)
from pyramid_flow_tpu_torch.utils import profiling  # noqa: E402

CELL = "wan14b-t2v-384p-5s"
TINY = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, text_len=16,
            text_dim=64)
VAE = {"block_out_channels": [16, 16, 16, 16],
       "encoder_layers_per_block": [1, 1, 1, 1],
       "decoder_layers_per_block": [1, 1, 1, 1], "num_groups": 4}
FP8 = torch.float8_e4m3fn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these widths every op is tiny, and in a
    parallel test run the default pool's per-op barrier waits on threads
    the other workers have descheduled (the float8 control took 86 s
    instead of 1 s beside eight busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_dict(**over):
    cfg = json.loads((ROOT / "portbench/configs/wan2.1-t2v-14b-384p.json")
                     .read_text())["dit"]
    return dict(cfg, **over)


def _config(d):
    return WanConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


def _seeded_dit(d, dtype=torch.float32, device="cpu", seed=9):
    dit = WanDiT(_config(d), dtype=dtype, device=device)
    seeded.load_into(dit, seeded.seeded_weights(
        ref_wan.param_specs(d), seed, 1, device, dtype))
    return dit.eval()


def _layout_inputs(lay: Layout, d, g, text=8, valid=(5, 8)):
    tokens = torch.randn((2, lay.length, 64), generator=g)
    pos = torch.as_tensor(lay.positions)[None].expand(2, -1, -1)
    times = torch.as_tensor(lay.time_ids)[None].expand(2, -1)
    emb = torch.randn((2, text, d["text_dim"]), generator=g)
    mask = torch.arange(text)[None].expand(2, -1) < torch.tensor(
        [[valid[0]], [valid[1]]])
    t = torch.tensor([900.0, 120.0])
    return tokens, pos, times, emb, mask, t


# -------------------------------------------------------------- forward
@pytest.mark.parametrize("unit,stage", [(0, 0), (2, 1), (3, 2)])
def test_forward_matches_the_reference(unit, stage):
    d = _cfg_dict(**TINY)
    dit = _seeded_dit(d)
    W = dict(seeded.seeded_weights(ref_wan.param_specs(d), 9, 1, "cpu",
                                   torch.float32))
    lay = Layout(unit, stage, 16, 16)
    g = torch.Generator().manual_seed(4)
    tokens, pos, times, emb, mask, t = _layout_inputs(lay, d, g)
    with torch.no_grad():
        got = dit(tokens, pos, times.int(), emb, mask, torch.zeros(2, 0), t)
    want = ref_wan.forward(d, W, tokens, pos, times, emb, mask, t)
    assert got.dtype == torch.float32
    cur = slice(-lay.current, None)
    assert ref_t2v.rel(got[:, cur], want[:, cur]) < 1e-4
    # a text token outside the mask is not read
    emb2 = emb.clone()
    emb2[0, 6] += 5.0
    with torch.no_grad():
        again = dit(tokens, pos, times.int(), emb2, mask, torch.zeros(2, 0),
                    t)
    assert torch.equal(again, got)


# ------------------------------------------------------- the served request
def _tiny_spec(dtype="float32", temp=3, trace=False):
    bench = Bench(ROOT)
    cfg = json.loads((ROOT / "portbench/configs/wan2.1-t2v-14b-384p.json")
                     .read_text())
    cfg.update(dtype=dtype, vae=dict(cfg["vae"], **VAE),
               dit=_cfg_dict(**TINY))
    # a window long enough to hold the whole request on a loaded machine: it
    # closes when the request's last unit is done
    spec = bench.spec(CELL, 2 ** 31 + 11, 600.0, trace, "cpu", config=cfg)
    spec.traffic.update(temp=temp, height=64, width=64, steps=[2, 2, 2],
                        video_steps=[2, 2, 2], text_len=8, text_valid=6,
                        dit_samples=3)
    return bench, spec


def test_request_is_held_to_the_reference():
    """A temp-3 request served by the pipeline with the Wan DiT (bf16, as
    the cell serves) is correct under the cell's limits; in float32 the
    program's forwards are the reference's own request's."""
    bench, spec = _tiny_spec("bfloat16")
    torch.manual_seed(0)
    out = run(bench, spec, time.perf_counter(), time.perf_counter)
    assert out["correct"] and out["attempted"] == 3, out
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())

    bench, spec = _tiny_spec("float32")
    tg = bench.generator(spec.generator)
    cell = tg.Cell(spec)
    assert isinstance(cell.pipe, PyramidFlowPipeline)
    assert isinstance(cell.pipe.dit, WanDiT)
    assert cell.pipe.model_name == "pyramid_wan"
    # this repo's VAE: miniFLUX's latent norms
    assert (cell.pipe.vae_shift_factor, cell.pipe.vae_scale_factor) == (
        -0.04, 1 / 1.8726)
    cell.window()
    req, noise = cell.requests[0], cell.noises[0]
    d = spec.config["dit"]
    W = dict(seeded.seeded_weights(ref_wan.param_specs(d), spec.seed,
                                   tg.TAG_DIT, "cpu", torch.float32))
    text = tuple(torch.cat([n, p]) for n, p in zip(cell.neg, cell.pos))
    units = {f["unit"] for f in req.forwards}
    assert units == {0, 1, 2}
    plain = ref_wan.plain_request(d, W, noise, text, cell.tr, len(units),
                                  torch.float32, Precision())
    assert len(plain.forwards) == len(req.forwards)
    for a, b in zip(req.forwards, plain.forwards):
        assert (a["unit"], a["stage"], a["step"]) == (
            b["unit"], b["stage"], b["step"])
        assert ref_t2v.rel(a["cur"].float(), b["cur"]) < 1e-4
        assert ref_t2v.rel(a["v"].float(), b["v"]) < 1e-4


def test_float8_control_fails_the_limits():
    _, spec = _tiny_spec("bfloat16")
    tg = Bench(ROOT).generator(spec.generator)
    d, dtype = spec.config["dit"], torch.bfloat16
    tr = tg.base._traffic(spec.traffic)
    pos, neg = tg._text(spec, spec.traffic, dtype)
    text = tuple(torch.cat([n, p]).float() if n.is_floating_point()
                 else torch.cat([n, p]) for n, p in zip(neg, pos))
    noise = ref_t2v.make_noise(tr, seeded.generator(spec.seed, tg.TAG_NOISE,
                                                    "cpu"))
    W = dict(seeded.seeded_weights(ref_wan.param_specs(d), spec.seed,
                                   tg.TAG_DIT, "cpu", dtype))
    with torch.no_grad():
        req = ref_wan.plain_request(d, W, noise, text, tr, 3, FP8,
                                    Precision(FP8))
        got = ref_wan.judge(d, W, req, noise, text, tr,
                            seeded.sub_seed(spec.seed, tg.TAG_SAMPLE),
                            spec.traffic["dit_samples"], dtype)
    limits = spec.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), got


# ----------------------------------------------------- published widths
def test_published_widths_on_meta():
    dit = WanDiT(device="meta")
    assert sum(p.numel() for p in dit.parameters()) == 14_288_491_584
    d = _cfg_dict()
    specs = ref_wan.param_specs(d)
    assert sorted((n, tuple(p.shape)) for n, p in dit.named_parameters()) \
        == specs
    cfg = json.loads((ROOT / "portbench/configs/wan2.1-t2v-14b-384p.json")
                     .read_text())
    assert cfg["parameters"]["dit"] == 14_288_491_584
    assert dit.config == _config(d)
    assert dit.config.head_dim == 128
    assert dit.config.rope_axes == (44, 42, 42)
    assert dit.num_attention_calls == 80
    # the model FLOPs the benchmark counts: per latent token, per text token
    # (the text MLP and the cross-attentions' k, v) and once per row
    tg = Bench(ROOT).generator("t2v_closed_loop_wan")
    per_latent = 40 * 2 * (6 * 5120 ** 2 + 2 * 5120 * 13824) + 4 * 5120 * 64
    per_text = 2 * (4096 * 5120 + 5120 ** 2) + 40 * 4 * 5120 ** 2
    per_row = 2 * (256 * 5120 + 5120 ** 2 + 5120 * 6 * 5120)
    assert tg.matmul_flops(specs, 512, 1000) == (
        1000 * per_latent + 512 * per_text + per_row)
    assert per_latent == 23_908_843_520


def test_defaults_and_refusals(tmp_path):
    d = _cfg_dict(**TINY)
    dit = WanDiT(_config(d), device="cpu")
    assert dit.bounded_softmax is False
    assert dit.model_name == "pyramid_wan"
    assert dit.sp_group is None

    class Mesh:  # the two dims the DiT reads
        mesh_dim_names = ("dp", "fsdp", "sp")

        def __init__(self, shape):
            self.shape = shape

    for shape, what in (((1, 1, 2), "sp=2"), ((1, 2, 1), "fsdp=2")):
        with pytest.raises(ValueError, match="one device.*" + what):
            WanDiT(_config(d), device="cpu", mesh=Mesh(shape))
    WanDiT(_config(d), device="cpu", mesh=Mesh((2, 1, 1)))  # dp only
    with pytest.raises(ValueError, match="patch"):
        WanDiT(_config(dict(d, patch_size=[2, 2, 2])), device="cpu")
    lay = Layout(0, 0, 16, 16)
    args = _layout_inputs(lay, d, torch.Generator().manual_seed(0), text=17,
                          valid=(3, 17))
    with torch.no_grad(), pytest.raises(ValueError, match="text_len=16"):
        dit(args[0], args[1], args[2].int(), args[3], args[4],
            torch.zeros(2, 0), args[5])
    from pyramid_flow_tpu_torch.utils.checkpoint import build_dit
    with pytest.raises(ValueError, match="pyramid_wan"):
        build_dit(str(tmp_path), "v", "pyramid_wan", {}, dtype=torch.float32,
                  device="cpu")


def test_span_tree_of_a_request():
    """Every ``dit.forward`` of a request holds one ``wan.cross_attn`` span
    per block, here 40 at the published depth."""
    d = _cfg_dict(**dict(TINY, num_layers=40))
    dit = _seeded_dit(d)
    pipe = PyramidFlowPipeline(dit, None, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    emb = torch.randn((1, 8, d["text_dim"]), generator=g)
    mask = torch.arange(8)[None] < 6
    pooled = torch.zeros((1, 0))
    with profiling.recording() as rec:
        pipe.generate(g, emb, mask, pooled, emb * 0, mask, pooled,
                      height=64, width=64, temp=2, num_inference_steps=1,
                      video_num_inference_steps=1)
    spans = rec.spans()
    forwards = [i for i, s in enumerate(spans) if s.name == "dit.forward"]
    assert len(forwards) == 6
    for i in forwards:
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == ["wan.cross_attn"] * 40
        attrs = spans[i].attrs
        assert attrs["text_tokens"] == 16 and attrs["rows"] == 2
        assert attrs["graph"] == "eager"
        assert attrs["attn_launches"] == attrs["cross_attn_launches"] == 0
        # the CPU keeps the compositions
        assert attrs["qk_launches"] == attrs["norm_launches"] == 0


@pytest.mark.parametrize("path", ["portbench/reference/wan.py",
                                  "portbench/traffic/t2v_closed_loop_wan.py"])
def test_benchmark_files_import_no_jax(path):
    """Neither imports JAX or the JAX package; the reference imports nothing
    of the program either."""
    banned = ["jax", "flax", "optax", "pyramid_flow_tpu"]
    if "reference" in path:
        banned.append("pyramid_flow_tpu_torch")
    found = []
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(node.module or "")
    tops = {n.split(".")[0] for n in found}
    assert tops.isdisjoint(banned), tops & set(banned)
    assert ("pyramid_flow_tpu_torch" in tops) == ("traffic" in path)


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
        a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))


@pytest.mark.gpu
def test_replay_is_the_eager_forward_bit_for_bit(cuda):
    d = _cfg_dict(dim=512, ffn_dim=1024, num_heads=4, num_layers=3,
                  text_len=64, text_dim=256)
    dit = _seeded_dit(d, torch.bfloat16, "cuda")
    n = dit.num_attention_calls
    assert n == 6
    g = torch.Generator().manual_seed(5)
    layouts = [Layout(1, 1, 32, 32), Layout(3, 2, 32, 32)]
    inputs = []
    for lay in layouts:
        tokens, pos, times, emb, mask, t = _layout_inputs(lay, d, g, text=32,
                                                          valid=(20, 32))
        # int32 ids broadcast over the rows, as the pipeline passes them
        times = torch.as_tensor(lay.time_ids, dtype=torch.int32,
                                device="cuda")[None].expand(2, -1)
        inputs.append(tuple(a.to("cuda") for a in (
            tokens.bfloat16(), pos, times, emb.bfloat16(), mask,
            torch.zeros(2, 0, dtype=torch.bfloat16), t)))
    with torch.no_grad():
        for args in inputs:
            outs = []
            for how in ("eager", "capture", "replay", "replay"):
                launches = flash_fwd_cuda.launches
                with profiling.recording() as rec:
                    outs.append(dit(*args))
                (fw,) = [s for s in rec.spans() if s.name == "dit.forward"]
                assert fw.attrs["graph"] == how
                assert flash_fwd_cuda.launches - launches == n
                assert fw.attrs["attn_launches"] == n
                assert fw.attrs["cross_attn_launches"] == n // 2
                assert fw.attrs["qk_launches"] == n
                assert fw.attrs["norm_launches"] == 2 * n  # four a block
                assert [s.name for s in rec.spans()].count(
                    "wan.cross_attn") == n // 2
            for out in outs[1:]:
                assert _bit_equal(out, outs[0])
        # each layout's graphs still replay after the other's
        again = [dit(*args) for args in inputs]
        for args, out in zip(inputs, again):
            assert _bit_equal(out, dit._forward(*args))
    captured = [v for v in dit.graphs.layouts.values() if v.graphs]
    assert len(captured) == 2
    for layout in captured:
        assert len(layout.graphs) == n + 1 and len(layout.seams) == n
        assert [s.name for s in layout.seams] == [
            "_attention", "_cross_attention"] * (n // 2)
