"""Port parity for image-to-video, JAX vs torch.

The tiny DiT and VAE of test_torch_port_pipeline.py. ``generate_i2v`` of
both pipelines from the same raw image latent, with the port replaying JAX's
key splits (image-to-video's unit loop starts at unit 1); and both runners'
``generate_i2v`` from the same uint8 image through the same stand-in text
encoder (a function of the prompt string), the port replaying the key JAX's
runner splits for the posterior draw and the pipeline: once at the image's
own size and once resize-cropped to the requested size.

Tolerances: latents atol 5e-4, as for text-to-video (the same DiT forwards);
the posterior sample enters both through the same draw.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.pipeline import runner as jrunner
from pyramid_flow_tpu_torch.models.vae import model as vae_model
from pyramid_flow_tpu_torch.pipeline import runner
from test_torch_port_pipeline import (  # noqa: F401 (the fixture)
    GEN, SEED, JaxNoise, _text, pipelines)

LATENT_ATOL = 5e-4


def test_generate_i2v_latents_match_jax(pipelines):  # noqa: F811
    jpipe, tpipe = pipelines
    img = np.random.default_rng(3).standard_normal(
        (1, 1, 8, 8, 4)).astype(np.float32)
    emb, mask, pooled = _text()
    ref = np.asarray(jpipe.generate_i2v(
        jax.random.PRNGKey(SEED), jnp.asarray(img), *map(jnp.asarray, (
            emb, mask, pooled, emb * 0, mask, pooled * 0)),
        output_type="latent", **GEN))
    noise = JaxNoise(SEED, first_unit=1)
    calls = []
    out = tpipe.generate_i2v(
        None, torch.from_numpy(img), *map(torch.from_numpy, (
            emb, mask, pooled, emb * 0, mask, pooled * 0)),
        output_type="latent", noise=noise, progress_callback=calls.append,
        **GEN)
    assert out.shape == ref.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=LATENT_ATOL, rtol=0)
    # unit 0 is the normalised image itself
    np.testing.assert_allclose(out[:, :1].numpy(),
                               (img + 0.04) / 1.8726, rtol=1e-6)
    assert [c[1:3] for c in noise.calls[1:]] == [
        (u, s) for u in (1, 2) for s in (1, 2)]
    assert [(c["unit"], c["units"]) for c in calls] == [(1, 2), (2, 2)]


def _text_encoder(wrap):
    """The stand-in text encoder: features drawn from a seed made of the
    prompt strings, as ``wrap``'s arrays."""
    def encode(prompts):
        seed = zlib.crc32("|".join(prompts).encode())
        rng = np.random.default_rng(seed)
        b = len(prompts)
        emb = rng.standard_normal((b, 8, 32)).astype(np.float32)
        mask = np.arange(8)[None].repeat(b, 0) < 6
        pooled = rng.standard_normal((b, 24)).astype(np.float32)
        return tuple(map(wrap, (emb, mask, pooled)))
    return encode


@pytest.mark.parametrize("image_hw,size", [((64, 64), {}),
                                           ((80, 96), dict(height=64,
                                                           width=64))])
def test_runner_generate_i2v_matches_jax(  # noqa: F811
        pipelines, image_hw, size, monkeypatch):
    jpipe, tpipe = pipelines
    image = np.random.default_rng(4).integers(
        0, 256, image_hw + (3,), dtype=np.uint8)
    gen = {k: v for k, v in GEN.items() if k not in ("height", "width")}
    ref = np.asarray(jrunner.PyramidFlowRunner(
        jpipe, _text_encoder(jnp.asarray)).generate_i2v(
            "a red kite", image, seed=SEED, output_type="latent", **size,
            **gen))

    # JAX's runner: split the seed's key; the sub key draws the posterior,
    # the other key drives the pipeline; the port's posterior draw is
    # replaced by the sub key's
    key, sub = jax.random.split(jax.random.PRNGKey(SEED))
    draw = torch.from_numpy(np.array(jax.random.normal(sub, (1, 1, 8, 8, 4))))
    sample = vae_model.gaussian_sample
    monkeypatch.setattr(vae_model, "gaussian_sample",
                        lambda moments, generator: sample(moments, draw))
    out = runner.PyramidFlowRunner(
        tpipe, _text_encoder(torch.from_numpy)).generate_i2v(
            "a red kite", image, seed=SEED,
            noise=JaxNoise(key, first_unit=1), output_type="latent", **size,
            **gen)
    assert out.shape == ref.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=LATENT_ATOL, rtol=0)
    if size:
        np.testing.assert_array_equal(runner._resize_crop(image, 64, 64),
                                      jrunner._resize_crop(image, 64, 64))


def test_runner_from_pretrained_names_its_roadmap_item():
    """``from_pretrained`` is ported (ROADMAP A8): on a path without the
    released layout it names the missing components, and no roadmap item
    (test_torch_port_checkpoint.py loads a real layout)."""
    with pytest.raises(FileNotFoundError, match="no weights for") as exc:
        runner.PyramidFlowRunner.from_pretrained("x", device="cpu")
    assert "A8" not in str(exc.value)
