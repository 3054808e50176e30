"""Port parity: the causal 3x3x3 conv (K5) and its routing, JAX vs torch.

* The plain version (``causal_conv3d_reference``, the kernel's contract on
  the CPU) against the Pallas kernel ``pallas_causal_conv3d`` in interpret
  mode, at the shapes of test_causal_conv_kernel.py; fp32, atol/rtol 1e-4
  (the TPU test's own tolerance: 27 * C products summed in another order).
* ``CausalConv3d`` streaming over windows (single-frame windows included)
  against JAX's ``temporal_chunk=True`` carry, stride 1 and temporal stride
  2, fp32 atol 1e-5; and the bf16 kernel route, which on the CPU runs the
  plain version, against the same JAX output within bf16 rounding (2e-2 of
  the output's scale).
* The number of the release VAE's convs that the kernel takes, counted on
  the ``meta`` device: the count ``chip_smoke.py`` multiplies by windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.vae import layers as jlayers
from pyramid_flow_tpu.ops.causal_conv3d import pallas_causal_conv3d
from pyramid_flow_tpu_torch.models.vae import layers
from pyramid_flow_tpu_torch.models.vae.model import (
    CausalVideoVAE, VAEConfig, kernel_conv_count)
from pyramid_flow_tpu_torch.ops import causal_conv3d as cc


@pytest.mark.parametrize("shape", [
    (1, 3, 16, 128, 128, 128),
    (2, 1, 16, 128, 128, 128),   # image frame
    (1, 2, 32, 256, 128, 256),   # channel change
    (1, 2, 12, 128, 128, 128),   # H not a multiple of the kernel's 16-row tile
])
def test_plain_matches_pallas(shape):
    b, t, h, w, c, co = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, t, h, w, c)).astype(np.float32)
    k = (0.02 * rng.standard_normal((3, 3, 3, c, co))).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    ref = np.asarray(pallas_causal_conv3d(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(bias)))
    out = cc.causal_conv3d(torch.from_numpy(x),
                           torch.from_numpy(k.transpose(4, 3, 0, 1, 2)),
                           torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def _jax_stream(conv, params, windows):
    """JAX's streaming apply: the cache collection threaded by hand."""
    cache, outs = None, []
    for i, xw in enumerate(windows):
        v = dict(params) if cache is None else {**params, "cache": cache}
        out, mut = conv.apply(v, jnp.asarray(xw), is_init=(i == 0),
                              temporal_chunk=True, mutable=["cache"])
        cache = mut["cache"]
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1)


def _port_stream(conv, windows, dtype=torch.float32):
    state, outs = {}, []
    with torch.no_grad():
        for i, xw in enumerate(windows):
            x = layers.channels_last(torch.from_numpy(xw).to(dtype))
            y = conv(x, state, is_init=(i == 0))
            assert y.is_contiguous(memory_format=torch.channels_last_3d)
            outs.append(y.permute(0, 2, 3, 4, 1).float().numpy())
    return np.concatenate(outs, axis=1)


def _conv_pair(c, co, stride, seed):
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((3, 3, 3, c, co))
              / np.sqrt(27 * c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    jconv = jlayers.CausalConv3d(co, (3, 3, 3), stride=stride)
    params = {"params": {"kernel": jnp.asarray(kernel),
                         "bias": jnp.asarray(bias)}}

    def port(dtype):
        conv = layers.CausalConv3d(c, co, (3, 3, 3), stride=stride,
                                   dtype=dtype)
        conv.cache_key = "conv"
        conv.to(memory_format=torch.channels_last_3d)
        with torch.no_grad():
            conv.conv.weight.copy_(torch.from_numpy(
                kernel.transpose(4, 3, 0, 1, 2)))
            conv.conv.bias.copy_(torch.from_numpy(bias))
        return conv

    return jconv, params, port


@pytest.mark.parametrize("stride,splits", [
    ((1, 1, 1), (1, 1, 2, 3)),   # single-frame windows carry a front frame
    ((1, 1, 1), (3, 4)),
    ((2, 1, 1), (1, 2, 2)),      # temporal downsampler: the last frame only
])
def test_streaming_carry_matches_jax(stride, splits):
    c, co = 64, 128  # the fewest input channels the kernel admits
    jconv, params, port = _conv_pair(c, co, stride, seed=len(splits))
    x = np.random.default_rng(3).standard_normal(
        (1, sum(splits), 5, 6, c)).astype(np.float32)
    bounds = np.cumsum((0,) + splits)
    windows = [x[:, s:e] for s, e in zip(bounds[:-1], bounds[1:])]
    ref = _jax_stream(jconv, params, windows)
    np.testing.assert_allclose(_port_stream(port(torch.float32), windows),
                               ref, atol=1e-5, rtol=0)
    if stride != (1, 1, 1):
        return
    # bf16: the kernel route, which runs the plain version on the CPU
    conv = port(torch.bfloat16)
    assert conv.uses_kernel
    calls = []
    real = layers.causal_conv3d

    def spy(*args):
        calls.append(args[3] is not None)  # whether a front was passed
        return real(*args)

    layers.causal_conv3d = spy
    try:
        out = _port_stream(conv, windows, torch.bfloat16)
    finally:
        layers.causal_conv3d = real
    assert calls == [False] + [True] * (len(windows) - 1)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2e-2 * scale


def test_kernel_rule():
    ok = dict(kernel_size=(3, 3, 3), stride=(1, 1, 1), dtype=torch.bfloat16)
    assert cc.supports_kernel(128, 128, **ok)
    assert cc.supports_kernel(512, 2048, **ok)
    assert not cc.supports_kernel(3, 128, **ok)          # conv_in
    assert not cc.supports_kernel(128, 3, **ok)          # conv_out
    assert not cc.supports_kernel(512, 32, **ok)         # encoder conv_out
    assert not cc.supports_kernel(96, 128, **ok)         # C % 64
    assert not cc.supports_kernel(128, 128, (3, 3, 3), (1, 2, 2),
                                  torch.bfloat16)        # downsampler
    assert not cc.supports_kernel(128, 128, (1, 1, 1), (1, 1, 1),
                                  torch.bfloat16)        # shortcut
    assert not cc.supports_kernel(128, 128, (3, 3, 3), (1, 1, 1),
                                  torch.float32)


def test_release_vae_kernel_conv_count():
    """Encoder: 4 blocks x 2 resnets x 2 convs + the mid block's 4 = 20;
    decoder: the mid block's 4 + 4 blocks x 3 resnets x 2 convs + 3 x 2
    upsamplers = 34. The ends, shortcuts and downsamplers stay on
    F.conv3d."""
    vae = CausalVideoVAE(VAEConfig(), dtype=torch.bfloat16, device="meta")
    assert kernel_conv_count(vae.encoder) == 20
    assert kernel_conv_count(vae.decoder) == 34
    assert kernel_conv_count(vae) == 54
    fp32 = CausalVideoVAE(VAEConfig(), device="meta")
    assert kernel_conv_count(fp32) == 0
    assert all(p.is_contiguous(memory_format=torch.channels_last_3d)
               for p in vae.parameters() if p.dim() == 5)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """The admission rule (input channels a multiple of 64: one K step is
    one 128-byte row) is checked before the device and before the library
    is touched; nothing is launched or counted."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(cc, "kernel_library", no_library)
    x = torch.zeros((1, 2, 8, 16, 96), dtype=torch.bfloat16)
    weight = torch.zeros((128, 96, 3, 3, 3), dtype=torch.bfloat16)
    bias = torch.zeros(128)
    before = cc.causal_conv3d_cuda.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        cc.causal_conv3d_cuda(x, weight, bias)
    x, weight = x[..., :64].contiguous(), weight[:, :64].contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cc.causal_conv3d_cuda(x, weight, bias)
    assert cc.causal_conv3d_cuda.launches == before
