"""Port parity for the VAE's temporal context parallelism, JAX vs torch, on
the CPU: two spawned gloo ranks (``_parallel_harness``) against JAX's
``tests/test_cp.py`` cases in the pytest process.

* the halo exchange's semantics: each rank's frames get the previous
  rank's last two in front (zeros on the first), and the gradient of the
  halo goes back to the rank it came from;
* ``cp_vae_apply(vae.encode)`` of a 32-frame clip at cp=2 against JAX's
  monolithic encode (JAX's ``test_cp_encode_matches_monolithic``);
* ``cp_vae_decode`` of 4 latent frames at cp=2 (the global upsampler shift
  and the tail trim) against JAX's monolithic decode and JAX's own
  ``cp_vae_decode`` (``test_cp_decode_matches_monolithic_tail``);
* the scoped ``cp_context``.

JAX's ``TINY`` VAE of tests/test_cp.py with its weights redrawn from a
numpy seed (test_torch_port_vae.py's ``_randomize``) and carried over by
``vae_state_dict_from_jax``. Tolerance: atol 2e-5 (JAX's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyramid_flow_tpu.models.vae.model import CausalVideoVAE as JVAE
from pyramid_flow_tpu.models.vae.model import VAEConfig as JVAEConfig
from pyramid_flow_tpu.parallel.cp import cp_vae_decode as jcp_vae_decode
from pyramid_flow_tpu_torch.parallel.cp import cp_context, current_cp_axis
from pyramid_flow_tpu_torch.utils.converters import vae_state_dict_from_jax

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_vae import _randomize

TINY = dict(latent_channels=4, block_out_channels=(8, 8, 16, 16),
            encoder_layers_per_block=(1, 1, 1, 1),
            decoder_layers_per_block=(1, 1, 1, 1), num_groups=4)


def test_cp_context_is_scoped():
    assert current_cp_axis() is None
    with cp_context("cp"):
        assert current_cp_axis() == "cp"
        with cp_context("other"):
            assert current_cp_axis() == "other"
        assert current_cp_axis() == "cp"
    assert current_cp_axis() is None


def test_cp_halo_encode_and_decode_match_jax(tmp_path):
    jvae = JVAE(config=JVAEConfig(**TINY))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (1, 32, 16, 16, 3)))
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 4, 2, 2, 4)))
    shapes = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 1, 16, 16, 3)),
        rng=jax.random.PRNGKey(2)))
    variables = jax.tree.map(jnp.asarray, _randomize(shapes, 11))
    mono_enc = np.asarray(jvae.apply(variables, jnp.asarray(x),
                                     method=jvae.encode))
    mono_dec = np.asarray(jvae.apply(variables, jnp.asarray(z),
                                     method=jvae.decode))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("cp",))
    jcp_dec = np.asarray(jcp_vae_decode(jvae, variables, jnp.asarray(z),
                                        mesh))
    sd = {k: v.numpy() for k, v in vae_state_dict_from_jax(
        jax.tree.map(np.array, variables)).items()}
    out = run_ranks(ranks.cp_encode_decode, 2, tmp_path, TINY, sd, x, z)

    # the halo: rank r holds frames (2r, 2r + 1); weights 1..4 on the 4
    # frames of [halo; own], so rank 0's own frames get 3, 4 from itself
    # and 1, 2 from rank 1's halo
    (_, _, halo0, g0), (_, _, halo1, g1) = out
    np.testing.assert_array_equal(halo0, [0, 0, 0, 1])
    np.testing.assert_array_equal(halo1, [0, 1, 2, 3])
    np.testing.assert_array_equal(g0, [3 + 1, 4 + 2])
    np.testing.assert_array_equal(g1, [3, 4])

    for enc, dec, _, _ in out:
        assert enc.shape == mono_enc.shape and dec.shape == mono_dec.shape
        np.testing.assert_allclose(enc, mono_enc, atol=2e-5)
        np.testing.assert_allclose(dec, mono_dec, atol=2e-5)
        np.testing.assert_allclose(dec, jcp_dec, atol=2e-5)
    assert torch.is_tensor(torch.from_numpy(out[0][0]))
