"""Card-only tests of the port's CUDA flash-attention kernel.

Each test compares the kernel with the plain PyTorch version on the same
CUDA inputs, or checks that the wrapper refuses what the kernel does not
take. They carry the ``gpu`` marker and skip without a CUDA device. This file
imports torch and the port only, so on a machine without JAX it runs as

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.ops.flash_attention import (
    INVALID_TIME,
    attention_reference,
    flash_attention,
    flash_fwd_cuda,
)

pytestmark = pytest.mark.gpu

# bf16 inputs, fp32 plain version: o is bf16-rounded (one ulp ~ 4e-3 near 1)
# and p is rounded to bf16 before p.v, so 1e-2 on o; lse has only fp32
# rounding of sums and the bf16-vs-fp32 q.k difference, so 2e-3
O_ATOL = 1e-2
LSE_ATOL = 2e-3


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
    before = flash_fwd_cuda.launches
    flash_attention(q, k, v, t, bounded=True)
    flash_attention(q, k, v, t)
    assert flash_fwd_cuda.launches == before + 2


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
