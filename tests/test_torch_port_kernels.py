"""Card-only tests of the port's CUDA kernels.

Each test compares a kernel (the flash-attention forward, the forward with
several heads per block, its delta, dK/dV and dQ backward, or the VAE's causal
conv and its gradient route) with the plain PyTorch version on the
same CUDA inputs, checks a launch counter, or checks that a wrapper refuses
what its kernel does not take. They carry the ``gpu`` marker and skip without a CUDA device. This file
imports torch and the port only, so on a machine without JAX it runs as

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest
"""

import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.models.vae import layers as vae_layers
from pyramid_flow_tpu_torch.models.vae.layers import CausalConv3d
from pyramid_flow_tpu_torch.models.vae.model import (
    CausalVideoVAE, VAEConfig, kernel_conv_count)
from pyramid_flow_tpu_torch.ops.causal_conv3d import (
    causal_conv3d,
    causal_conv3d_cuda,
    causal_conv3d_reference,
)
from pyramid_flow_tpu_torch.ops.flash_attention import (
    INVALID_TIME,
    attention_backward_reference,
    attention_reference,
    flash_attention,
    flash_bwd_cuda,
    flash_fwd_cuda,
    flash_fwd_hn_cuda,
    flash_fwd_hn_resources,
)
from pyramid_flow_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

# bf16 inputs, fp32 plain version: o is bf16-rounded (one ulp ~ 4e-3 near 1)
# and p is rounded to bf16 before p.v, so 1e-2 on o; lse has only fp32
# rounding of sums and the bf16-vs-fp32 q.k difference, so 2e-3
O_ATOL = 1e-2
LSE_ATOL = 2e-3
# backward: bf16 operands (p and ds rounded to bf16 before their products)
# against fp32, summed over up to L terms: max|err| <= 2e-2 * max|ref| for
# each of dq, dk, dv
GRAD_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layout(b, l, text_len=40, text_pad=9, cond=60, pad=50, frames=4):
    """[text (last ``text_pad`` INVALID), cond history at t=1..2, INVALID
    pad, current clip at frames 3..]: the DiT's packed AR layout."""
    t = np.zeros((b, l), np.int32)
    t[:, text_len - text_pad:text_len] = INVALID_TIME
    s = text_len
    t[:, s:s + cond // 2] = 1
    t[:, s + cond // 2:s + cond] = 2
    s += cond
    t[:, s:s + pad] = INVALID_TIME
    s += pad
    cur = np.arange(l - s) * frames // max(l - s, 1) + 3
    t[:, s:] = cur
    return t


def _inputs(dev, b=2, h=3, l=333, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((b, h, l, d)), dtype=torch.bfloat16)
    k = torch.tensor(rng.standard_normal((b, h, l, d)), dtype=torch.bfloat16)
    v = torch.tensor(rng.standard_normal((b, h, l, d)), dtype=torch.bfloat16)
    t = torch.tensor(_layout(b, l))
    return [x.to(dev) for x in (q, k, v, t)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain(cuda, d, bounded, causal):
    q, k, v, t = _inputs(cuda, d=d)
    o, lse = flash_fwd_cuda(q, k, v, t, t, causal=causal,
                            sm_scale=d ** -0.5, bounded=bounded)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_reference(q, k, v, t, causal=causal,
                                         return_lse=True)
    valid = (t[0] != INVALID_TIME).cpu()
    do = (o.float() - o_ref.float()).abs()[:, :, valid.to(cuda)]
    dl = (lse - lse_ref).abs()[:, :, valid.to(cuda)]
    assert torch.isfinite(o).all()
    assert do.max().item() <= O_ATOL, do.max().item()
    assert dl.max().item() <= LSE_ATOL, dl.max().item()


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_over_several_waves(cuda, causal):
    """1200 blocks, several waves on the card, on the DiT-like layout whose
    text padding and padded middle give q-tiles different tile types; L =
    1600 is not a multiple of the 128-key tile."""
    q, k, v, t = _inputs(cuda, h=24, l=1600)
    for bounded in (True, False):
        o, lse = flash_fwd_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                                bounded=bounded)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_reference(q, k, v, t, causal=causal,
                                             return_lse=True)
        valid = t[0] != INVALID_TIME
        assert (o.float() - o_ref.float())[:, :, valid].abs().max() <= O_ATOL
        assert (lse - lse_ref)[:, :, valid].abs().max() <= LSE_ATOL


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_all_full_tiles(cuda, causal):
    """Every key valid and at time 0: every tile is FULL (no mask) under
    both rules."""
    q, k, v, _ = _inputs(cuda, l=384)
    t = torch.zeros((2, 384), dtype=torch.int32, device=cuda)
    types = fa.tile_types(t, t, fa.FWD_TILE_Q, fa.FWD_TILE_K, causal)
    assert (types == fa.TILE_FULL).all()
    for bounded in (True, False):
        o, lse = flash_fwd_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                                bounded=bounded)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_reference(q, k, v, t, causal=causal,
                                             return_lse=True)
        assert (o.float() - o_ref.float()).abs().max() <= O_ATOL
        assert (lse - lse_ref).abs().max() <= LSE_ATOL


@pytest.mark.parametrize("bounded", [True, False])
def test_kernel_matches_plain_cross_lengths(cuda, bounded):
    """Lq != Lk: 200 queries against 333 keys of another layout."""
    q, _, _, tq = _inputs(cuda, l=200, seed=1)
    _, k, v, tk = _inputs(cuda, l=333, seed=2)
    tq = torch.where(tq == INVALID_TIME, tq, tq % 4).contiguous()
    o, lse = flash_fwd_cuda(q, k, v, tq, tk, causal=True, sm_scale=0.125,
                            bounded=bounded)
    torch.cuda.synchronize()
    o_ref, lse_ref = attention_reference(q, k, v, tq, tk, causal=True,
                                         return_lse=True)
    # valid query rows that see at least one key
    seen = (lse_ref < 1e38) & (tq != INVALID_TIME)[:, None, :]
    assert seen.any()
    assert (o.float() - o_ref.float()).abs()[seen].max().item() <= O_ATOL
    assert (lse - lse_ref).abs()[seen].max().item() <= LSE_ATOL


def test_rows_without_visible_keys(cuda):
    """Text queries (t=0) under causal see no key when every key is a later
    frame: o = 0 and lse = 3e38, never 0/0."""
    q, k, v, _ = _inputs(cuda, l=130)
    tq = torch.zeros((2, 130), dtype=torch.int32, device=cuda)
    tk = torch.full((2, 130), 5, dtype=torch.int32, device=cuda)
    for bounded in (True, False):
        o, lse = flash_fwd_cuda(q, k, v, tq, tk, causal=True, sm_scale=0.125,
                                bounded=bounded)
        torch.cuda.synchronize()
        assert (o == 0).all()
        assert (lse == 3e38).all()


def test_launch_counter_counts_launches(cuda):
    q, k, v, t = _inputs(cuda)
    before = (flash_fwd_cuda.launches, flash_fwd_cuda.classic_launches)
    flash_attention(q, k, v, t, bounded=True)
    flash_attention(q, k, v, t)
    assert (flash_fwd_cuda.launches, flash_fwd_cuda.classic_launches) == (
        before[0] + 2, before[1] + 1)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, t = _inputs(cuda)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float(), t)
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), t)
    with pytest.raises(ValueError):
        strided = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_attention(strided, k, v, t)
    with pytest.raises(TypeError):
        flash_attention(q, k, v, t.long())
    with pytest.raises(ValueError):
        flash_attention(q, k, v.cpu(), t)


def _bwd_inputs(dev, d=64, lq=333, lk=None, causal=True, seed=0, h=3,
                full=False):
    """q, k, v, times, o and lse from the forward kernel, and an upstream
    gradient that is random on valid query rows and zero on padded ones.
    ``full``: every time 0, so that every tile is FULL."""
    q, k, v, t = _inputs(dev, h=h, l=lq, d=d, seed=seed)
    tk = t
    if lk is not None:
        _, k, v, tk = _inputs(dev, h=h, l=lk, d=d, seed=seed + 1)
    if full:
        t = tk = torch.zeros_like(t)
    o, lse = flash_fwd_cuda(q, k, v, t, tk, causal=causal, sm_scale=d ** -0.5,
                            bounded=True)
    gen = torch.Generator(dev).manual_seed(seed)
    do = torch.randn(o.shape, generator=gen, device=dev)
    do = (do * (t != INVALID_TIME)[:, None, :, None]).bfloat16()
    return q, k, v, t, tk, o, lse, do


def _assert_grads_close(got, ref):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert scale > 0, name
        assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [
    dict(lq=333),                # not a multiple of the 64-row tile
    dict(lq=200, lk=333),        # Lq != Lk, ragged
    dict(lq=64, lk=64),          # one tile
    dict(lq=1600, h=24),         # 1200 blocks per kernel: several waves
    dict(lq=384, full=True),     # every tile FULL (no mask)
], ids=["ragged", "cross", "one-tile", "waves", "all-full"])
def test_bwd_kernels_match_plain(cuda, d, causal, case):
    """K3/K4 against the plain backward."""
    q, k, v, t, tk, o, lse, do = _bwd_inputs(cuda, d, causal=causal, **case)
    if case.get("full"):
        types = fa.tile_types(t, tk, 64, 64, causal)
        assert (types == fa.TILE_FULL).all()
    got = flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=causal,
                         sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    ref = attention_backward_reference(q, k, v, t, tk, o, lse, do,
                                       causal=causal)
    _assert_grads_close(got, ref)


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_repeats_are_bit_identical(cuda, d):
    """Two passes and no atomics: the same inputs give the same bits."""
    q, k, v, t, tk, o, lse, do = _bwd_inputs(cuda, d, lq=1600, h=8)
    first = flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                           sm_scale=d ** -0.5)
    second = flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                            sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_delta_matches_rowsum(cuda, d):
    """The library's delta kernel against rowsum(o * do) in fp32; zero on
    the padded rows, whose do is zero."""
    q, k, v, t, tk, o, lse, do = _bwd_inputs(cuda, d, lq=333)
    delta = torch.full(lse.shape, float("nan"), device=cuda)
    flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                   sm_scale=d ** -0.5, delta=delta)
    torch.cuda.synchronize()
    ref = (o.float() * do.float()).sum(-1)
    torch.testing.assert_close(delta, ref, rtol=1e-5, atol=1e-5)
    assert (delta[:, :, t[0] == INVALID_TIME] == 0).all()


def test_kernels_launch_from_a_fresh_thread(cuda):
    """A thread whose first CUDA work is a kernel call (the autograd
    engine's, when a backward starts at the attention) gets the same bits
    from the forward, the backward and the conv as this thread: the
    libraries make the context current before they encode tensor maps."""
    q, k, v, t, tk, o, lse, do = _bwd_inputs(cuda)
    x, weight, bias, fr = _conv_inputs(cuda, 1, 2, 8, 8, 64, 128, True)

    def run():
        return (flash_fwd_cuda(q, k, v, t, tk, causal=True, sm_scale=0.125,
                               bounded=True),
                flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                               sm_scale=0.125),
                causal_conv3d_cuda(x, weight, bias, fr))

    here, there = run(), []
    worker = threading.Thread(target=lambda: there.append(run()))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert there, "the thread's calls raised"
    def flat(r):
        (o_, lse_), grads, y = r
        return [o_, lse_, *grads, y]

    for a, b in zip(flat(here), flat(there[0])):
        assert torch.equal(a, b)


def test_kernels_launch_on_each_device_after_set_device(cuda):
    """The shared-memory opt-in is set per device, not once per process: on
    every visible device in turn (made current with ``set_device``, as a
    rank of a multi-device run does), the forward, the backward and the conv
    launch there and give the bits they give on the first device."""
    first = None
    for i in range(torch.cuda.device_count()):
        torch.cuda.set_device(i)
        dev = torch.device("cuda", torch.cuda.current_device())
        q, k, v, t, tk, o, lse, do = _bwd_inputs(dev)
        x, weight, bias, fr = _conv_inputs(dev, 1, 2, 8, 8, 64, 128, True)
        before = flash_fwd_cuda.launches
        out = [*flash_fwd_cuda(q, k, v, t, tk, causal=True, sm_scale=0.125,
                               bounded=True),
               *flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                               sm_scale=0.125),
               causal_conv3d_cuda(x, weight, bias, fr)]
        torch.cuda.synchronize(dev)
        assert flash_fwd_cuda.launches == before + 1
        assert all(r.device == dev for r in out)
        out = [r.cpu() for r in out]
        if first is None:
            first = out
        for a, b in zip(first, out):
            assert torch.equal(a, b)
    torch.cuda.set_device(0)


def test_bwd_rows_without_visible_keys(cuda):
    """Queries that see no key (lse = 3e38) give zero gradients, never NaN."""
    q, k, v, _ = _inputs(cuda, l=130)
    tq = torch.zeros((2, 130), dtype=torch.int32, device=cuda)
    tk = torch.full((2, 130), 5, dtype=torch.int32, device=cuda)
    o, lse = flash_fwd_cuda(q, k, v, tq, tk, causal=True, sm_scale=0.125,
                            bounded=False)
    do = torch.randn_like(o)
    for g in flash_bwd_cuda(q, k, v, tq, tk, o, lse, do, causal=True,
                            sm_scale=0.125):
        torch.cuda.synchronize()
        assert (g == 0).all()


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_match_autograd(cuda, bounded, causal):
    """flash_attention is differentiable on the card: its gradients match
    autograd through the plain version, with the loss weighted by the valid
    rows (padded rows carry no gradient)."""
    q, k, v, t = _inputs(cuda)
    valid = (t != INVALID_TIME)[:, None, :, None].float()

    def grads(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs)
        (out.float() * valid).square().sum().backward()
        return [x.grad for x in xs]

    got = grads(lambda a, b, c: flash_attention(a, b, c, t, causal=causal,
                                                bounded=bounded))
    ref = grads(lambda a, b, c: attention_reference(a, b, c, t,
                                                    causal=causal))
    _assert_grads_close(got, ref)


def test_bwd_launch_counters_count_launches(cuda):
    q, k, v, t = _inputs(cuda)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (flash_fwd_cuda.launches, flash_bwd_cuda.dkv_launches,
              flash_bwd_cuda.dq_launches)
    out = flash_attention(*xs, t, bounded=True)
    (out.float() * (t != INVALID_TIME)[:, None, :, None]).sum().backward()
    assert (flash_fwd_cuda.launches, flash_bwd_cuda.dkv_launches,
            flash_bwd_cuda.dq_launches) == tuple(n + 1 for n in before)


def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    q, k, v, t, tk, o, lse, do = _bwd_inputs(cuda)
    with pytest.raises(TypeError):
        flash_bwd_cuda(q, k, v, t, tk, o, lse, do.float(), causal=True,
                       sm_scale=0.125)
    with pytest.raises(ValueError):
        flash_bwd_cuda(q, k, v, t, tk, o, lse[:, :, :-1].contiguous(), do,
                       causal=True, sm_scale=0.125)
    with pytest.raises(ValueError):
        flash_bwd_cuda(q, k, v, t, tk, o, lse, do.transpose(2, 3)
                       .contiguous().transpose(2, 3), causal=True,
                       sm_scale=0.125)
    with pytest.raises(TypeError):
        flash_bwd_cuda(q, k, v, t, tk, o, lse, do, causal=True,
                       sm_scale=0.125, delta=lse.double())
    with pytest.raises(ValueError):
        flash_bwd_cuda(q.cpu(), k.cpu(), v.cpu(), t.cpu(), tk.cpu(), o.cpu(),
                       lse.cpu(), do.cpu(), causal=True, sm_scale=0.125)


# the conv: bf16 products of 27 * C terms against the fp32 plain version
CONV_REL = 2e-2


def _conv_inputs(dev, b, t, h, w, c, co, front, seed=0):
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.tensor(a, dtype=torch.bfloat16, device=dev)

    x = bf16(rng.standard_normal((b, t, h, w, c)))
    weight = bf16(rng.standard_normal((co, c, 3, 3, 3)) / np.sqrt(27 * c))
    weight = weight.contiguous(memory_format=torch.channels_last_3d)
    bias = bf16(0.1 * rng.standard_normal(co))
    fr = bf16(rng.standard_normal((b, 2, h, w, c))) if front else None
    return x, weight, bias, fr


@pytest.mark.parametrize("front", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 3, 20, 36, 128, 128),   # H, W not multiples of the 16 x 16 tile
    (2, 1, 13, 17, 64, 256),    # B = 2, one frame, two output-channel tiles
    (1, 2, 24, 32, 128, 128),   # two frames: without front, 2 and 1 taps skipped
    (1, 2, 9, 18, 512, 256),    # 512 -> 256 channels, ragged
])
def test_conv_kernel_matches_plain(cuda, shape, front):
    x, weight, bias, fr = _conv_inputs(cuda, *shape, front)
    y = causal_conv3d_cuda(x, weight, bias, fr)
    torch.cuda.synchronize()
    ref = causal_conv3d_reference(
        x.float(), weight.float(), bias.float(),
        None if fr is None else fr.float())
    assert y.shape == ref.shape and torch.isfinite(y).all()
    err = (y.float() - ref).abs().max().item()
    assert err <= CONV_REL * ref.abs().max().item(), err


def test_conv_launch_counter_counts_launches(cuda):
    """One launch per call of the public op and per admitted module call;
    the module's streaming carry passes its front to the kernel."""
    x, weight, bias, _ = _conv_inputs(cuda, 1, 2, 8, 8, 64, 128, False)
    before = causal_conv3d_cuda.launches
    causal_conv3d(x, weight, bias)
    conv = CausalConv3d(64, 128, (3, 3, 3), dtype=torch.bfloat16,
                        device=cuda).to(memory_format=torch.channels_last_3d)
    conv.cache_key = "c"
    state = {}
    xs = x.permute(0, 4, 1, 2, 3)
    first = conv(xs[:, :, :1], state, is_init=True)
    second = conv(xs[:, :, 1:], state, is_init=False)
    torch.cuda.synchronize()
    assert causal_conv3d_cuda.launches == before + 3
    whole = conv(xs)  # monolithic, equal to the two windows
    out = torch.cat([first, second], 2)
    assert (out.float() - whole.float()).abs().max().item() <= 1e-2


@pytest.mark.parametrize("shape,front", [
    ((1, 1, 48, 80, 512, 512), False),  # the decoder's first window
    ((1, 2, 48, 80, 512, 512), True),   # a later window, carried front
])
def test_conv_function_gradients_match_conv3d(cuda, shape, front):
    """A conv routed to the kernel (CausalConv3dFunction) passes the
    gradients of x, the front frames, the weight and the bias, within
    GRAD_REL of autograd through F.conv3d on the front-padded input."""
    x, weight, bias, fr = _conv_inputs(cuda, *shape, front)
    dy = _conv_inputs(cuda, *shape[:4], shape[5], shape[5], False,
                      seed=1)[0]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, weight, bias) + ((fr,) if front else ())]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, dy)

    before = causal_conv3d_cuda.launches
    y, got = grads(lambda x, w, b, f=None: causal_conv3d(x, w, b, f))
    assert causal_conv3d_cuda.launches == before + 1
    assert y.grad_fn is not None

    def conv3d(x, w, b, f=None):
        front = x.new_zeros((x.shape[0], 2) + x.shape[2:]) if f is None else f
        xp = torch.cat([front, x], 1).permute(0, 4, 1, 2, 3)
        return torch.nn.functional.conv3d(xp, w, b, padding=(0, 1, 1)
                                          ).permute(0, 2, 3, 4, 1)

    _, ref = grads(conv3d)
    assert got[1].is_contiguous(memory_format=torch.channels_last_3d)
    for name, a, b in zip(("dx", "dweight", "dbias", "dfront"), got, ref):
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert scale > 0 and err <= GRAD_REL * scale, (name, err, scale)


def test_fp32_vae_under_bf16_autocast_takes_the_kernel(cuda):
    """The GAN trainer's setting: an fp32-master VAE under CUDA bf16
    autocast admits its convs by the dtype they compute in. Each admitted
    decoder conv launches the kernel once (so none reaches ``F.conv3d``),
    the output matches the plain route's (the plain version patched in, on
    the same bf16 casts), and each admitted conv's fp32 weight gets a
    finite, nonzero fp32 gradient back through the cast."""
    torch.manual_seed(0)
    vae = CausalVideoVAE(VAEConfig(
        latent_channels=4, block_out_channels=(128, 128, 128, 128),
        encoder_layers_per_block=(1, 1, 1, 1),
        decoder_layers_per_block=(1, 1, 1, 1)), device=cuda)
    z = torch.randn((1, 2, 6, 10, 4), device=cuda)
    weight = torch.randn((1, 9, 48, 80, 3), device=cuda)
    admitted = [m for m in vae.decoder.modules()
                if isinstance(m, CausalConv3d) and m.admits(torch.bfloat16)]
    assert kernel_conv_count(vae) == 0
    with torch.autocast("cuda", dtype=torch.bfloat16):
        assert kernel_conv_count(vae.decoder) == len(admitted) > 0
        before = causal_conv3d_cuda.launches
        y = vae.decode(z)
        torch.cuda.synchronize()
        assert causal_conv3d_cuda.launches - before == len(admitted)
        with mock.patch.object(vae_layers, "causal_conv3d",
                               causal_conv3d_reference), torch.no_grad():
            y_plain = vae.decode(z)
    (y.float() * weight).mean().backward()
    for m in admitted:
        g = m.conv.weight.grad
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert g.abs().max() > 0
    rel = ((y.float() - y_plain.float()).norm() / y_plain.float().norm())
    assert rel.item() <= 2e-2, rel.item()


def test_conv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, weight, bias, fr = _conv_inputs(cuda, 1, 2, 8, 8, 64, 128, True)
    with pytest.raises(ValueError):   # fp32 is not the kernel's
        causal_conv3d_cuda(x.float(), weight.float(), bias)
    with pytest.raises(ValueError):   # weight not channels-last
        causal_conv3d_cuda(x, weight.contiguous(), bias)
    with pytest.raises(ValueError):   # 96 output channels
        causal_conv3d_cuda(x, weight[:96], bias[:96])
    with pytest.raises(ValueError):   # front of one frame
        causal_conv3d_cuda(x, weight, bias, fr[:, :1])
    with pytest.raises(ValueError):
        causal_conv3d_cuda(x.cpu(), weight, bias)


# ------------------------------------------- heads-per-block bounded forward
@pytest.mark.parametrize("hs", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_hn_kernel_matches_plain_or_is_refused(cuda, hs, causal):
    """At every hs the kernel is built for: K1's tolerances against the
    plain version where the block fits the card, a refusal before any
    launch where it does not."""
    q, k, v, t = _inputs(cuda, h=12)
    before = flash_fwd_hn_cuda.launches
    if not flash_fwd_hn_resources(hs, causal)["fits"]:
        with pytest.raises(ValueError, match="does not fit"):
            flash_fwd_hn_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                              hs=hs)
        assert flash_fwd_hn_cuda.launches == before
        return
    o, lse = flash_fwd_hn_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                               hs=hs)
    torch.cuda.synchronize()
    assert flash_fwd_hn_cuda.launches == before + 1
    o_ref, lse_ref = attention_reference(q, k, v, t, causal=causal,
                                         return_lse=True)
    valid = t[0] != INVALID_TIME
    assert torch.isfinite(o).all()
    assert (o.float() - o_ref.float())[:, :, valid].abs().max() <= O_ATOL
    assert (lse - lse_ref)[:, :, valid].abs().max() <= LSE_ATOL


@pytest.mark.parametrize("causal", [True, False])
def test_hn_kernel_at_one_head_matches_the_one_head_kernel(cuda, causal):
    """hs = 1 against the bounded forward (flash_fwd.cu): the same block
    (csrc/flash_fwd_block.cuh) at the same tile, ring and registers, so the
    same bits."""
    q, k, v, t = _inputs(cuda, h=3, l=333)
    o1, lse1 = flash_fwd_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                              bounded=True)
    o, lse = flash_fwd_hn_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                               hs=1)
    torch.cuda.synchronize()
    _assert_same_bits((o, lse), (o1, lse1))


def test_hn_kernel_rows_without_visible_keys(cuda):
    q, k, v, _ = _inputs(cuda, h=4, l=130)
    tq = torch.zeros((2, 130), dtype=torch.int32, device=cuda)
    tk = torch.full((2, 130), 5, dtype=torch.int32, device=cuda)
    o, lse = flash_fwd_hn_cuda(q, k, v, tq, tk, causal=True, sm_scale=0.125,
                               hs=2)
    torch.cuda.synchronize()
    assert (o == 0).all() and (lse == 3e38).all()


def test_hn_two_heads_fit_and_a_block_that_does_not_is_refused(cuda,
                                                               monkeypatch):
    res = flash_fwd_hn_resources(2)
    assert res["fits"] and res["threads"] == 384  # two consumers, a producer
    q, k, v, t = _inputs(cuda, h=4, d=128)  # K1 takes it, K6 does not
    with pytest.raises(ValueError, match="head dim 64"):
        flash_fwd_hn_cuda(q, k, v, t, t, causal=True, sm_scale=0.125, hs=2)
    q, k, v, t = _inputs(cuda, h=4)
    with pytest.raises(ValueError, match="hs=3"):
        flash_fwd_hn_cuda(q, k, v, t, t, causal=True, sm_scale=0.125, hs=3)
    # a card whose registers could not hold the block
    monkeypatch.setattr(fa, "flash_fwd_hn_resources", lambda hs, causal: {
        **res, "max_threads": 128, "fits": False})
    before = flash_fwd_hn_cuda.launches
    with pytest.raises(ValueError, match="does not fit"):
        flash_fwd_hn_cuda(q, k, v, t, t, causal=True, sm_scale=0.125, hs=2)
    assert flash_fwd_hn_cuda.launches == before


def _same_bits(a, b):
    """Elements of a and b (bf16 or fp32) whose bits differ."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return (a.view(view) != b.view(view)).sum()


def _assert_same_bits(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _same_bits(a, b).item() == 0


def _fitting_hs(causal=True):
    return [hs for hs in fa.HN_HEADS_PER_BLOCK
            if flash_fwd_hn_resources(hs, causal)["fits"]]


# chip_smoke.py's three DiT layouts: (height, width, unit, stage)
DIT_LAYOUTS = {"384x640 u0 s0": (384, 640, 0, 0),
               "384x640 u15 s2": (384, 640, 15, 2),
               "768x1280 u15 s2": (768, 1280, 15, 2)}


def _dit_time_ids(dev, height, width, unit, stage, b=2):
    """[b, L] time ids of the DiT's attention at one (unit, stage): 128 text
    tokens (the last 28 INVALID), then the pipeline's packed latent
    layout, as chip_smoke.py builds them."""
    from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
        PyramidFlowPipeline)
    pipe = PyramidFlowPipeline(None, device=dev)
    h_lat, w_lat = height // 8, width // 8
    budget = pipe._cond_token_budget(unit, h_lat, w_lat)[stage]
    _, time_ids, _ = pipe._stage_metadata(b, 1, h_lat, w_lat, unit, stage,
                                          budget)
    text = np.zeros(128, np.int32)
    text[100:] = INVALID_TIME
    t = np.concatenate([text, np.asarray(time_ids, np.int32)])
    return torch.as_tensor(np.broadcast_to(t, (b, t.size)).copy(),
                           device=dev)


def _rms_inputs(dev, t, h=24, d=64, seed=0):
    """q and k of RMS 1 per row (the DiT's qk-norm), v standard normal,
    bf16, [B, h, L, d] for the time ids t."""
    rng = np.random.default_rng(seed)
    shape = (t.shape[0], h, t.shape[1], d)
    q, k = (rng.standard_normal(shape) for _ in range(2))
    q, k = (x / np.sqrt((x * x).mean(-1, keepdims=True)) for x in (q, k))
    v = rng.standard_normal(shape)
    return [torch.tensor(x, dtype=torch.bfloat16, device=dev)
            for x in (q, k, v)]


@pytest.mark.parametrize("layout", list(DIT_LAYOUTS))
@pytest.mark.parametrize("causal", [True, False])
def test_hn_kernel_matches_the_one_head_kernel_on_dit_layouts(cuda, layout,
                                                              causal):
    """(a) At hs = 1 and 2, K6 against K1's bounded forward on the DiT's
    layouts at full width (B=2, H=24, D=64): every consumer runs K1's
    consumer (csrc/flash_fwd_block.cuh) on its own head's slice, with K1's
    tile, ring and shift, so the bits must be K1's."""
    t = _dit_time_ids(cuda, *DIT_LAYOUTS[layout])
    q, k, v = _rms_inputs(cuda, t)
    want = flash_fwd_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                          bounded=True)
    for hs in (1, 2):
        got = flash_fwd_hn_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                                hs=hs)
        torch.cuda.synchronize()
        _assert_same_bits(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_hn_heads_of_one_block_keep_their_own_slices(cuda, causal):
    """(b) The heads of a block differ 10x in their key norms (odd heads),
    so their scores, row bounds and outputs differ: a consumer that read
    another head's stage slice or row bound would show, against K1 (bit
    for bit at hs 1 and 2) and against the plain version (K1's
    tolerances) at every hs that fits."""
    rng = np.random.default_rng(3)
    t = torch.tensor(_layout(2, 700), device=cuda)
    shape = (2, 12, 700, 64)
    q = 0.3 * rng.standard_normal(shape)
    k = 0.3 * rng.standard_normal(shape)
    k[:, 1::2] *= 10.0
    v = rng.standard_normal(shape)
    q, k, v = (torch.tensor(x, dtype=torch.bfloat16, device=cuda)
               for x in (q, k, v))
    kn = k.float().norm(dim=-1).amax(-1)[0]
    assert (kn[1::2] > 5 * kn[0::2]).all()
    o1, lse1 = flash_fwd_cuda(q, k, v, t, t, causal=causal, sm_scale=0.125,
                              bounded=True)
    o_ref, lse_ref = attention_reference(q, k, v, t, causal=causal,
                                         return_lse=True)
    valid = t[0] != INVALID_TIME
    for hs in _fitting_hs(causal):
        o, lse = flash_fwd_hn_cuda(q, k, v, t, t, causal=causal,
                                   sm_scale=0.125, hs=hs)
        torch.cuda.synchronize()
        if hs <= 2:
            _assert_same_bits((o, lse), (o1, lse1))
        assert (o.float() - o_ref.float())[:, :, valid].abs().max() <= O_ATOL
        assert (lse - lse_ref)[:, :, valid].abs().max() <= LSE_ATOL


@pytest.mark.parametrize("lq,lk", [(333, 333), (1000, 3072)])
@pytest.mark.parametrize("causal", [True, False])
def test_hn_kernel_at_ragged_lengths(cuda, lq, lk, causal):
    """(c) L not a multiple of the tiles (333; 1000 queries against 3072
    keys), on layouts whose tiles are SKIP, FULL and MASKED: rows past L
    load as zeros, never the next head's rows, and the TMA byte count of a
    stage holds at the ragged edge. At every hs that fits, against the
    plain version (K1's tolerances) on the valid rows that see a key, and
    bit for bit against K1 at hs 1 and 2."""
    def time_ids(l):
        # 64 text tokens at t=0, then frames of 96 tokens from t=1, with 20
        # INVALID tokens at 200
        t = np.zeros(l, np.int32)
        t[64:] = 1 + np.arange(l - 64) // 96
        t[200:220] = INVALID_TIME
        return torch.tensor(np.stack([t, t]), device=cuda)

    q = _inputs(cuda, h=12, l=lq, seed=4)[0]
    k, v = _inputs(cuda, h=12, l=lk, seed=5)[1:3]
    tq, tk = time_ids(lq), time_ids(lk)
    types = fa.tile_types(tq, tk, fa.FWD_TILE_Q, fa.FWD_TILE_K, causal)
    if causal:
        assert {fa.TILE_SKIP, fa.TILE_FULL, fa.TILE_MASKED} <= set(
            types.unique().tolist())
    o1, lse1 = flash_fwd_cuda(q, k, v, tq, tk, causal=causal, sm_scale=0.125,
                              bounded=True)
    o_ref, lse_ref = attention_reference(q, k, v, tq, tk, causal=causal,
                                         return_lse=True)
    seen = (lse_ref < 1e38) & (tq != INVALID_TIME)[:, None, :]
    assert seen.any()
    for hs in _fitting_hs(causal):
        o, lse = flash_fwd_hn_cuda(q, k, v, tq, tk, causal=causal,
                                   sm_scale=0.125, hs=hs)
        torch.cuda.synchronize()
        if hs <= 2:
            _assert_same_bits((o, lse), (o1, lse1))
        assert (o.float() - o_ref.float()).abs()[seen].max() <= O_ATOL
        assert (lse - lse_ref).abs()[seen].max() <= LSE_ATOL


def test_hn_kernel_finishes_200_launches_with_the_same_bits(cuda):
    """(d) 200 back-to-back launches at hs = 2 on the DiT's 384x640 unit 15
    stage 2 layout (B=2, H=24): all finish within a minute (two consumers
    walk one ring; a hang fails here instead of blocking), and every launch
    gives the first one's bits."""
    t = _dit_time_ids(cuda, *DIT_LAYOUTS["384x640 u15 s2"])
    q, k, v = _rms_inputs(cuda, t, seed=6)
    first = flash_fwd_hn_cuda(q, k, v, t, t, causal=True, sm_scale=0.125,
                              hs=2)
    torch.cuda.synchronize()
    assert torch.isfinite(first[0]).all()
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(200):
        o, lse = flash_fwd_hn_cuda(q, k, v, t, t, causal=True, sm_scale=0.125,
                                   hs=2)
        differ += _same_bits(o, first[0]) + _same_bits(lse, first[1])
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + 60.0
    while not done.query():
        if time.monotonic() > deadline:
            pytest.fail("200 launches of the hs=2 forward did not finish "
                        "within 60 s")
        time.sleep(0.01)
    assert differ.item() == 0
