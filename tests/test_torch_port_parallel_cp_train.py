"""Port parity for the context-parallel GAN-VAE step, JAX vs torch, on the
CPU: the port's ``make_vae_train_step(mesh=...)`` on spawned gloo ranks
(``_parallel_harness``) against JAX's ``make_vae_train_step`` on the whole
clip in the pytest process, both with ``is_init=False`` (continuation
clips, as CP trains them) and ``grads_only``; JAX's own
``tests/test_cp_vae_training.py`` holds its cp step to that same
monolithic step.

The tiny GAN of test_torch_port_vae_training.py (JAX's ``TINY_VAE``
geometry, full VGG16 LPIPS, ndf-8 two-layer discriminators, weights from
numpy seeds) on a 32-frame 32x32 clip: 16 frames and 2 latent frames per
rank at cp=2, the discriminator on (``disc_start=0``) so that the adaptive
weight's global gradients are exercised. The posterior draw is JAX's at the
whole clip's latent shape; each rank takes its shard.

Tolerances: JAX's CP test's own, ``_grads_close`` (each leaf within 1e-3 of
its scale, floored at 1e-2 of the largest gradient, rtol 5e-3) and
``_compare_metrics`` (atol 3e-5, rtol 2e-4): a sharded step sums in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyramid_flow_tpu_torch.utils.converters import (
    discriminator_state_dict_from_jax, vae_state_dict_from_jax)

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_cp_vae_training import _compare_metrics, _grads_close
from test_torch_port_vae_training import (
    DISC, TINY, _jax_state, _np, tiny_gan_nets)


@pytest.fixture(scope="module")
def nets():
    return tiny_gan_nets()


def _clip(b):
    video = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (1, 32, 32, 32, 3))) * 0.5
    if b == 2:
        video = np.concatenate([video, video[:, :, ::-1]], axis=0)
    return np.ascontiguousarray(video, dtype=np.float32)


def run_case(nets, tmp_path, use_3d, mesh_shape):
    video = _clip(mesh_shape[0])
    key = jax.random.PRNGKey(5)
    jg, jd, jm = _jax_grads(nets, use_3d, video, key)
    # the one draw of the step: fold_in(key, step 0), the whole latent
    shape = (video.shape[0], video.shape[1] // 8, 4, 4, TINY["latent_channels"])
    draws = {((("fold", 0),), "normal", shape): np.asarray(
        jax.random.normal(jax.random.fold_in(key, 0), shape))}
    sd = {k: v.numpy() for k, v in vae_state_dict_from_jax(
        _np(nets["vae_params"])).items()}
    lp = {k: v.numpy() for k, v in nets["port_lpips"]().state_dict().items()}
    dsd = {k: v.numpy() for k, v in discriminator_state_dict_from_jax(
        _np(nets["disc_params"][use_3d])).items()}
    world = int(np.prod(mesh_shape))
    out = run_ranks(ranks.vae_grads, world, tmp_path, TINY, sd, lp, dsd,
                    DISC, use_3d, video, draws, mesh_shape)
    for r in out[1:]:
        _compare_metrics(jm, r, 0)
    metrics, gvae, glogvar, gdisc = out[0]
    _compare_metrics(jm, metrics, 0)
    assert metrics["vae/d_weight"] > 0
    ref_vae = {k: v.numpy() for k, v in vae_state_dict_from_jax(
        _np({"params": jg["vae"]})).items()}
    ref_disc = {k: v.numpy() for k, v in discriminator_state_dict_from_jax(
        _np({"params": jd})).items()}
    assert gvae.keys() == ref_vae.keys() and gdisc.keys() == ref_disc.keys()
    _grads_close({**gvae, "logvar": glogvar},
                 {**ref_vae, "logvar": np.asarray(jg["logvar"])})
    _grads_close(gdisc, ref_disc)


def _jax_grads(nets, use_3d, video, key):
    from pyramid_flow_tpu.training import vae_trainer as jtrainer
    step = jtrainer.make_vae_train_step(
        nets["jvae"], nets["jlpips"], nets["lpips_params"],
        nets["discs"][use_3d], use_3d_disc=use_3d, donate=False,
        is_init=False, grads_only=True)
    return step(_jax_state(nets, use_3d, 0), jnp.asarray(video), key)


@pytest.mark.parametrize("use_3d", [False, True], ids=["2d", "3d_disc"])
def test_cp_vae_train_step_matches_jax(nets, tmp_path, use_3d):
    """cp=2: the generator's and the discriminator's gradients and every
    metric of the step, on each rank; with the 3D discriminator on the
    clip gathered over cp."""
    run_case(nets, tmp_path, use_3d, (1, 2))
