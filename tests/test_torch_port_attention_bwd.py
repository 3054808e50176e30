"""Port parity: the attention backward, JAX vs torch, on the CPU.

The port's plain backward (``attention_backward_reference``) is held
against the JAX package's backward kernels themselves (``_bwd``, Pallas in
interpret mode) on the o and lse of JAX's forward kernels; the port's
differentiable ``flash_attention`` (``FlashAttentionFunction``) against
``jax.grad`` through JAX's ``flash_attention`` in both softmax forms, and
against autograd through the port's own plain forward.

The layout: text with INVALID padding, a conditioning history over two
frames, an INVALID pad, and a current clip over two frames. Upstream
gradients are zero on INVALID query rows, the backward's contract (the loss
is weighted by the valid-row mask, as in ``tests/test_flash_attention.py``).

Tolerances, fp32 throughout: the plain backward vs the Pallas backward
(same o and lse, sums in another order) atol 2e-5, rtol 1e-4; gradients vs
``jax.grad`` atol 5e-4, rtol 1e-3 (as the JAX package's own kernel-vs-
reference gradient test); the Function vs autograd on the port's side, where
the arithmetic differs only in rounding order, atol 1e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.ops import flash_attention as jfa
from pyramid_flow_tpu_torch.ops.flash_attention import (
    INVALID_TIME,
    attention_backward_reference,
    attention_reference,
    flash_attention,
)

B, H, D = 2, 2, 32
L = 256          # a multiple of the JAX kernels' 128-row blocks for _fwd
L_RAGGED = 203   # not a multiple of anything, for the public APIs
BWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
PORT_TOL = dict(atol=1e-5, rtol=1e-4)


def _times(l):
    """[text 24 (last 6 INVALID) | history t=1,2 | INVALID pad | t=3,4]."""
    t = np.zeros(l, np.int32)
    t[18:24] = INVALID_TIME
    hist = (l - 24) // 3
    t[24:24 + hist // 2] = 1
    t[24 + hist // 2:24 + hist] = 2
    pad = 24 + hist + 17
    t[24 + hist:pad] = INVALID_TIME
    t[pad:pad + (l - pad) // 2] = 3
    t[pad + (l - pad) // 2:] = 4
    return np.broadcast_to(t, (B, l)).copy()


def _inputs(l, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, l, D)).astype(np.float32)
               for _ in range(3))
    t = _times(l)
    valid = (t != INVALID_TIME)[:, None, :, None]
    do = rng.standard_normal((B, H, l, D)).astype(np.float32) * valid
    return q, k, v, t, do, valid.astype(np.float32)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_bwd(causal, bounded):
    q, k, v, t, do, _ = _inputs(L, seed=0)
    jq, jk, jv, jt, jdo = map(jnp.asarray, (q, k, v, t, do))
    scale = D ** -0.5
    o, lse = jfa._fwd(jq, jk, jv, jt, jt, causal, scale, 128, 128, bounded)
    dq, dk, dv = jfa._bwd(jq, jk, jv, jt, jt, o, lse, jdo, causal, scale,
                          128, 128)
    got = attention_backward_reference(
        *map(torch.from_numpy, (q, k, v, t, t, np.array(o),
                                np.array(lse), do)),
        causal=causal, sm_scale=scale)
    assert np.abs(np.asarray(dk)).max() > 1e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BWD_TOL,
                                   err_msg=name)


def _port_grads(fn, q, k, v, w):
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    ((out * torch.from_numpy(w)) ** 2).sum().backward()
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_match_jax_grad(causal, bounded):
    q, k, v, t, _, w = _inputs(L_RAGGED, seed=1)
    jt, jw = jnp.asarray(t), jnp.asarray(w)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, jt, causal=causal, bounded=bounded)
        return jnp.sum((o * jw) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tt = torch.from_numpy(t)
    got = _port_grads(lambda a, b, c: flash_attention(
        a, b, c, tt, causal=causal, bounded=bounded), q, k, v, w)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("causal", [True, False])
def test_function_matches_autograd_through_reference(causal):
    q, k, v, t, _, w = _inputs(L_RAGGED, seed=2)
    tt = torch.from_numpy(t)
    got = _port_grads(lambda a, b, c: flash_attention(
        a, b, c, tt, causal=causal, bounded=True), q, k, v, w)
    ref = _port_grads(lambda a, b, c: attention_reference(
        a, b, c, tt, causal=causal), q, k, v, w)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, b, **PORT_TOL, err_msg=f"grad {name}")


def test_rows_without_visible_keys_get_zero_gradients():
    """Text queries at t=0 against keys of later frames see nothing: lse is
    3e38 and every gradient is exactly zero, never NaN."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, D))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    tq = torch.zeros((1, 40), dtype=torch.int32)
    tk = torch.full((1, 40), 5, dtype=torch.int32)
    out = flash_attention(q, k, v, tq, tk, causal=True)
    assert (out == 0).all()
    out.sum().backward()
    for x in (q, k, v):
        assert (x.grad == 0).all()
