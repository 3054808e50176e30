"""Port parity for the GAN-VAE step at dp=2 x cp=2 (four gloo ranks: batch
and time sharded together) against JAX's monolithic step on the same two
clips, as JAX's ``test_cp_plus_dp_vae_train_step`` holds its own. Setup and
tolerances as test_torch_port_parallel_cp_train.py."""

from test_torch_port_parallel_cp_train import nets, run_case  # noqa: F401


def test_cp_plus_dp_vae_train_step(nets, tmp_path):  # noqa: F811
    run_case(nets, tmp_path, False, (2, 2))
