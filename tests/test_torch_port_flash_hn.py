"""Port parity: the heads-per-block bounded forward's tool, JAX vs torch, on
the CPU.

The port's ``flash_h2`` takes its plain version for CPU tensors; it is held
against the JAX tool's ``flash_h2`` (the Pallas kernel
``_fwd_kernel_bounded_hn`` in interpret mode, 256-row blocks, at hs 1, 2
and 4 heads per grid cell of the four heads) at the tool's mixed layout
(text, four frames, INVALID padding), causal and not, and on rows with no
visible key. fp32 on both sides: o and lse atol 1e-5
on valid rows (the same softmax, summed in another order; measured about
1e-7). The 768p stage-2 layout's time ids and the JAX tool's
``reference_lse`` are matched exactly and to 1e-5. The kernel itself runs only on the card
(tests/test_torch_port_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.ops import flash_attention as fa
from pyramid_flow_tpu_torch.tools import exp_flash_h2 as tool
from tools import exp_flash_h2 as jtool

B, NH, L, D = 1, 4, 640, 64
TOL = dict(rtol=0, atol=1e-5)


def _mixed_inputs():
    rng = np.random.default_rng(0)
    q, k = (0.3 * rng.standard_normal((B, NH, L, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, NH, L, D)).astype(np.float32)
    t = np.concatenate([np.zeros(64, np.int32), np.repeat(np.arange(1, 5), 96),
                        np.full(L - 64 - 384, fa.INVALID_TIME, np.int32)])
    return q, k, v, np.broadcast_to(t, (B, L)).copy()


@pytest.mark.parametrize("hs", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_route_matches_jax_kernel(causal, hs):
    q, k, v, t = _mixed_inputs()
    want, want_lse = jtool.flash_h2(*map(jnp.asarray, (q, k, v, t)),
                                    causal=causal, block_q=256, block_k=256,
                                    return_lse=True, hs=hs)
    got, got_lse = tool.flash_h2(*map(torch.from_numpy, (q, k, v, t)),
                                 causal=causal, return_lse=True, hs=hs)
    valid = t[0] != fa.INVALID_TIME
    np.testing.assert_allclose(got.numpy()[:, :, valid],
                               np.asarray(want)[:, :, valid], **TOL)
    np.testing.assert_allclose(got_lse.numpy()[:, :, valid],
                               np.asarray(want_lse)[:, :, valid], **TOL)
    ref_lse = jtool.reference_lse(*map(jnp.asarray, (q, k, t)),
                                  causal=causal)
    np.testing.assert_allclose(
        tool.reference_lse(*map(torch.from_numpy, (q, k, t)),
                           causal=causal).numpy(), np.asarray(ref_lse), **TOL)


def test_empty_rows_give_the_sentinel():
    q, k, v, _ = _mixed_inputs()
    tq = np.ones((B, L), np.int32)
    tk = np.full((B, L), fa.INVALID_TIME, np.int32)
    o_j, lse_j = jtool.flash_h2(*map(jnp.asarray, (q, k, v, tq, tk)),
                                causal=False, block_q=256, block_k=256,
                                return_lse=True)
    o, lse = tool.flash_h2(*map(torch.from_numpy, (q, k, v, tq, tk)),
                           causal=False, return_lse=True)
    assert (np.asarray(lse_j) == np.float32(3e38)).all()
    assert (lse.numpy() == np.float32(3e38)).all()
    assert not np.asarray(o_j).any() and not o.numpy().any()


def test_768p_stage2_layout_matches_jax():
    q, tq, L768 = tool.layout_768p_stage2("cpu")
    jq, jtq, jl = jtool.layout_768p_stage2()
    assert L768 == jl == 11008
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jtq))
    assert q.shape == jq.shape == (2, 24, 11008, 64)
    assert q.dtype == torch.bfloat16
    assert abs(q.float().std().item() - 0.3) < 1e-2
    # the layout's counts: text, padding, and the 3840-token current clip
    t = tq[0].numpy()
    assert (t == 0).sum() == 128 and (t == 16).sum() == 3840
    assert (t == fa.INVALID_TIME).sum() == 7168 - 128 - 7000


def test_wrapper_guards_and_main_without_a_card(monkeypatch):
    q, k, v, t = _mixed_inputs()
    qb = torch.from_numpy(q).bfloat16()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_hn_cuda(qb, qb, qb, torch.from_numpy(t),
                             torch.from_numpy(t), causal=True,
                             sm_scale=D ** -0.5, hs=2)
    with pytest.raises(ValueError, match="built for hs"):
        fa.flash_fwd_hn_resources(5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 1
    assert tool.main(["--full", "--iters", "1"]) == 1
