"""Port parity: the gradient of the causal 3x3x3 conv (K5's route), on the
CPU.

The conv kernel's forward has no gradient of its own; on the card
``CausalConv3dFunction`` gives it the plain backward
``causal_conv3d_backward`` (``torch.nn.grad`` over the front-padded input).
The JAX VAE's conv is differentiated by XLA, so the reference is
``jax.vjp`` of the JAX ``CausalConv3d`` (XLA conv), with zero front frames
(the first window) and with a carried front (a later streaming window).

Tolerances, fp32: each of dx, dfront, dweight and dbias within 1e-4 of
max|ref| against ``jax.vjp`` and against autograd through the plain forward
(sums of up to 27 * C * B * T * H * W terms in another order); the
Function's backward against finite differences of the plain forward in
fp64 with ``torch.autograd.gradcheck``'s defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu_torch.ops import causal_conv3d as cc
from test_torch_port_conv import _conv_pair

REL = 1e-4
SHAPE = (2, 3, 5, 6, 16, 32)  # B, T, H, W, C, Co


def _case(front, seed=0):
    b, t, h, w, c, co = SHAPE
    jconv, params, _ = _conv_pair(c, co, (1, 1, 1), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, t, h, w, c)).astype(np.float32)
    fr = (rng.standard_normal((b, 2, h, w, c)).astype(np.float32)
          if front else None)
    dy = rng.standard_normal((b, t, h, w, co)).astype(np.float32)
    return jconv, params, x, fr, dy


def _assert_close(got, ref, name):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, name
    err = np.abs(got - ref).max()
    assert err <= REL * scale, (name, err, scale)


def _torch_grads(x, fr, dy, params):
    kernel = np.asarray(params["params"]["kernel"])
    weight = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
    weight = weight.contiguous(memory_format=torch.channels_last_3d)
    return cc.causal_conv3d_backward(
        torch.from_numpy(x), weight,
        None if fr is None else torch.from_numpy(fr), torch.from_numpy(dy))


def _jax_grads(jconv, params, x, fr, dy):
    """jax.vjp of the JAX conv in its streaming form: is_init (zero front)
    or a later window whose carried front is the cache."""
    kernel, bias = params["params"]["kernel"], params["params"]["bias"]

    def f(kernel, bias, x, front):
        v = {"params": {"kernel": kernel, "bias": bias}}
        if front is not None:
            v["cache"] = {"front_feat": front}
        out, _ = jconv.apply(v, x, is_init=front is None,
                             temporal_chunk=True, mutable=["cache"])
        return out

    front = None if fr is None else jnp.asarray(fr)
    out, vjp = jax.vjp(lambda k, b, x, f_: f(k, b, x, f_), kernel, bias,
                       jnp.asarray(x), front)
    assert out.shape == dy.shape
    dk, db, dx, dfront = vjp(jnp.asarray(dy))
    return dx, dfront, np.asarray(dk).transpose(4, 3, 0, 1, 2), db


@pytest.mark.parametrize("front", [False, True])
def test_plain_backward_matches_jax_vjp(front):
    jconv, params, x, fr, dy = _case(front)
    got = _torch_grads(x, fr, dy, params)
    ref = _jax_grads(jconv, params, x, fr, dy)
    assert got[2].is_contiguous(memory_format=torch.channels_last_3d)
    for name, g, r in zip(("dx", "dfront", "dweight", "dbias"), got, ref):
        if r is None:
            assert g is None, name
            continue
        _assert_close(g.numpy(), r, name)


@pytest.mark.parametrize("front", [False, True])
def test_plain_backward_matches_autograd(front):
    _, params, x, fr, dy = _case(front, seed=3)
    got = _torch_grads(x, fr, dy, params)
    kernel = np.asarray(params["params"]["kernel"])
    leaves = [torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
              .requires_grad_(),
              torch.from_numpy(np.array(params["params"]["bias"]))
              .requires_grad_()]
    if fr is not None:
        leaves.append(torch.from_numpy(fr).requires_grad_())
    y = cc.causal_conv3d_reference(*leaves)
    ref = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    ref_by_name = dict(zip(("dx", "dweight", "dbias", "dfront"), ref))
    for name, g in zip(("dx", "dfront", "dweight", "dbias"), got):
        if name not in ref_by_name:
            assert g is None, name
            continue
        _assert_close(g.numpy(), ref_by_name[name].numpy(), name)


@pytest.mark.parametrize("front", [False, True])
def test_function_backward_gradcheck(monkeypatch, front):
    """The Function's backward against finite differences, in fp64, with
    the plain forward in the kernel's place (the CPU has no kernel)."""
    monkeypatch.setattr(cc, "causal_conv3d_cuda", cc.causal_conv3d_reference)
    rng = np.random.default_rng(7)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    x, weight, bias = leaf(1, 2, 3, 4, 2), leaf(3, 2, 3, 3, 3), leaf(3)
    fr = leaf(1, 2, 3, 4, 2) if front else None
    assert torch.autograd.gradcheck(
        lambda x, w, b, f: cc.CausalConv3dFunction.apply(x, w, b, f),
        (x, weight, bias, fr))


def test_function_saves_nothing_without_grad(monkeypatch):
    """Under no_grad (the VAE's encode and decode in serving) the Function
    builds no graph; with grad, only the inputs that need one get one."""
    monkeypatch.setattr(cc, "causal_conv3d_cuda", cc.causal_conv3d_reference)
    x = torch.randn(1, 2, 3, 4, 2, requires_grad=True)
    weight = torch.randn(3, 2, 3, 3, 3, requires_grad=True)
    bias = torch.randn(3)
    with torch.no_grad():
        y = cc.CausalConv3dFunction.apply(x, weight, bias, None)
    assert y.grad_fn is None
    y = cc.CausalConv3dFunction.apply(x, weight, bias, None)
    dx, dw = torch.autograd.grad(y.sum(), (x, weight))
    ref = torch.autograd.grad(
        cc.causal_conv3d_reference(x, weight, bias).sum(), (x, weight))
    torch.testing.assert_close(dx, ref[0])
    torch.testing.assert_close(dw, ref[1])
