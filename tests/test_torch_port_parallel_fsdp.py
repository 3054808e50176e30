"""Port parity for FSDP2 in its sharded regime and data parallelism beside
it, JAX vs torch, on the CPU (``_parallel_harness`` ranks; JAX's unsharded
step in the pytest process).

JAX's ``test_fsdp_sharded_matches_replicated`` holds its step with the
parameters sharded (min_shard_dim lowered so that they are) to its step
with them replicated. The port cannot leave a parameter whole under FSDP2
(it shards on dim 0 where JAX replicates), so its two regimes are JAX's
rule (min_shard_dim 16: most parameters on JAX's dim) and the dim-0
fallback for every parameter (min_shard_dim 2**30): both over fsdp=2, and
both must give JAX's step; and the (2, 2, 1) mesh, dp beside fsdp. Setup
and tolerances as test_torch_port_parallel_train.py.
"""

import numpy as np
import pytest

from pyramid_flow_tpu_torch.models.flux.model import FluxConfig

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_dit_loss import DIT, UNITS
from test_torch_port_parallel_train import LR, case, check_against_jax  # noqa


@pytest.mark.parametrize("mesh_shape,min_dim", [
    ((1, 2, 1), 16), ((1, 2, 1), 1 << 30), ((2, 2, 1), 16)],
    ids=["fsdp2_rule", "fsdp2_dim0", "dp2_fsdp2"])
def test_fsdp_sharded_matches_replicated(tmp_path, case, mesh_shape, min_dim):
    dit_j, params, sd, batch, draws, ref = case
    world = int(np.prod(mesh_shape))
    out = run_ranks(ranks.train_steps, world, tmp_path, "flux",
                    FluxConfig(**DIT), sd, batch, UNITS, mesh_shape, min_dim,
                    draws, 2, LR)
    stats = out[0]["stats"]
    assert stats["sharded_fraction"] == 1.0 and stats["replicated"] == 0
    if min_dim == 16:
        assert stats["rule_fraction"] > 0.5, stats
    else:
        assert stats["rule_fraction"] == 0.0, stats
    check_against_jax(out, ref)
