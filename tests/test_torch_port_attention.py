"""Port parity: attention, JAX's Pallas kernels (interpret mode) vs the port.

On the CPU the port's ``flash_attention`` runs its plain version. It is held
against the JAX forward kernels themselves, bounded and classic, causal and
non-causal, on a packed AR layout with text padding, a padded middle and a
ragged length. Both sides are fp32; tolerance atol 2e-5 on o and lse over
valid query rows (padded query rows are unspecified in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.ops import flash_attention as jfa
from pyramid_flow_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5
INVALID = fa.INVALID_TIME


def _layout(b, l):
    """[text 24 (last 5 INVALID) | cond frames 1, 2 | INVALID pad | current
    clip at frames 3..4]."""
    t = np.zeros((b, l), np.int32)
    t[:, 19:24] = INVALID
    t[:, 24:64] = 1
    t[:, 64:100] = 2
    t[:, 100:130] = INVALID
    t[:, 130:165] = 3
    t[:, 165:] = 4
    return t


def _inputs(b=2, h=2, l=200, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32) * s
               for s in (0.5, 0.5, 1.0))
    return q, k, v, _layout(b, l)


def _jax_fwd(q, k, v, t, causal, bounded, block=128):
    """JAX's internal forward on inputs padded to block multiples."""
    l = q.shape[2]
    pad = (-l) % block
    qkv = [jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, pad), (0, 0)))
           for x in (q, k, v)]
    tp = jnp.pad(jnp.asarray(t), ((0, 0), (0, pad)), constant_values=INVALID)
    o, lse = jfa._fwd(*qkv, tp, tp, causal, q.shape[-1] ** -0.5, block,
                      block, bounded)
    return np.asarray(o)[:, :, :l], np.asarray(lse)[:, :, :l]


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_o_and_lse_match_pallas(causal, bounded):
    q, k, v, t = _inputs()
    o_j, lse_j = _jax_fwd(q, k, v, t, causal, bounded)
    o_t, lse_t = fa._fwd(*(torch.from_numpy(x) for x in (q, k, v, t, t)),
                         causal, 64 ** -0.5, bounded)
    valid = t[0] != INVALID
    np.testing.assert_allclose(o_t.numpy()[:, :, valid], o_j[:, :, valid],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy()[:, :, valid], lse_j[:, :, valid],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("bounded", [True, None])
def test_public_flash_attention_matches(bounded):
    q, k, v, t = _inputs(l=150, d=32, seed=1)
    o_j = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v, t)), causal=True, bounded=bounded))
    o_t = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, t)),
                             causal=True, bounded=bounded)
    valid = t[0] != INVALID
    np.testing.assert_allclose(o_t.numpy()[:, :, valid], o_j[:, :, valid],
                               atol=ATOL, rtol=0)


def test_plain_version_matches_jax_reference():
    """Including rows with no visible key (text queries against later-frame
    keys): zeros, as in JAX's reference, and lse = 3e38."""
    q, k, v, t = _inputs(l=96, seed=2)
    tk = np.full_like(t, 5)
    tq = np.zeros_like(t)
    ref = np.asarray(jfa.attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(tq),
        jnp.asarray(tk), causal=True))
    o, lse = fa.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, tq, tk)), causal=True,
        return_lse=True)
    np.testing.assert_array_equal(o.numpy(), ref)
    assert (o == 0).all() and (lse == 3e38).all()
    for causal in (True, False):
        ref = np.asarray(jfa.attention_reference(
            *(jnp.asarray(x) for x in (q, k, v, t)), causal=causal))
        o = fa.attention_reference(
            *(torch.from_numpy(x) for x in (q, k, v, t)), causal=causal)
        np.testing.assert_allclose(o.numpy(), ref, atol=ATOL, rtol=0)


def test_cuda_path_never_falls_back_on_cpu_tensors():
    """The kernel launcher refuses CPU tensors instead of running the plain
    version."""
    q, k, v, t = (torch.from_numpy(x) for x in _inputs(l=64))
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(q, k, v, t, t, causal=True, sm_scale=0.125,
                          bounded=True)
