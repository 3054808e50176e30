"""Port parity for sequence parallelism and the mesh, JAX vs torch, on the
CPU: the port's ranks are spawned gloo processes (``_parallel_harness``),
JAX runs in the pytest process on its 8-device virtual CPU mesh.

* the FSDP sharding rule (``spec_for_param``) against JAX's
  ``_spec_for_param``, and FSDP2's sharding of the tiny miniFLUX over
  fsdp=2 against JAX's ``param_sharding`` of the same parameters;
* ``sp_flash_attention`` at sp=2 against JAX's at sp=2 (its output and
  ``jax.vjp``'s three gradients), at a length that needs no padding and one
  that does;
* the tiny miniFLUX and MMDiT (tests/test_torch_port_dit_loss.py's and
  tests/test_torch_port_mmdit.py's) at sp=2 against JAX's forward and
  parameter gradients on the same inputs; the MMDiT layout carries INVALID
  padding between its history and its current clip. Each rank also runs a
  forward on the classic route, and each attention's softmax form is seen
  where ``sp_flash_attention`` hands over to ``flash_attention``.

Tolerances (fp32): attention atol 2e-5 (JAX's own SP test); the DiTs'
outputs rtol/atol 1e-4 and gradients atol 2e-6 + rtol 2e-3 (the one-device
parity tests').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyramid_flow_tpu.ops.flash_attention import flash_attention as jflash
from pyramid_flow_tpu.parallel import mesh as jmesh
from pyramid_flow_tpu.parallel.sp import sp_flash_attention as jsp_flash
from pyramid_flow_tpu_torch.models.flux.model import FluxConfig
from pyramid_flow_tpu_torch.models.mmdit.model import MMDiTConfig
from pyramid_flow_tpu_torch.ops.flash_attention import INVALID_TIME
from pyramid_flow_tpu_torch.parallel import mesh
from pyramid_flow_tpu_torch.utils.converters import (
    flux_state_dict_from_jax, mmdit_state_dict_from_jax)

import _parallel_ranks as ranks
from _parallel_harness import run_ranks
from test_torch_port_dit_loss import DIT, tiny_dits
from test_torch_port_mmdit import TINY as MMDIT, tiny_layout, tiny_mmdits

GRAD_TOL = dict(atol=2e-6, rtol=2e-3)


@pytest.mark.parametrize("shape", [(2048, 512), (64,), (1023, 7), (3, 4096),
                                   (1024, 1024), (2, 2, 2048), ()])
@pytest.mark.parametrize("fsdp,min_dim", [(8, 1024), (2, 64), (1, 1)])
def test_sharding_rule_matches_jax(shape, fsdp, min_dim):
    spec = jmesh._spec_for_param("p", shape, fsdp, min_dim)
    dim = mesh.spec_for_param(shape, fsdp, min_dim)
    want = next((i for i, a in enumerate(spec) if a == "fsdp"), None)
    assert dim == want


def test_fsdp2_sharding_matches_jax(tmp_path):
    """Over fsdp=2 (min_shard_dim 64) every parameter JAX shards is an FSDP2
    shard on JAX's dim, and the stats count what JAX counts: JAX's
    replicated elements are FSDP2's dim-0 fallback. With fsdp=1 every
    parameter is whole."""
    _, params, make_port = tiny_dits()
    sd = {k: v.numpy() for k, v in make_port().state_dict().items()}
    jm = jmesh.make_mesh(jmesh.MeshConfig(fsdp=2), devices=jax.devices()[:2])
    jstats = {}
    specs = jmesh.param_sharding(jm, params, verbose=False, min_shard_dim=64,
                                 stats_out=jstats)
    # the size of the dim JAX shards each parameter on (-1: replicated);
    # the port's weights are JAX's transposed, so sizes name the dim
    sizes = flux_state_dict_from_jax(jax.tree.map(
        lambda s, p: np.asarray([p.shape[i] for i, a in enumerate(s.spec)
                                 if a == "fsdp"] or [-1]), specs, params))
    for fsdp in (2, 1):
        out = run_ranks(ranks.sharding_placements, 2, tmp_path / str(fsdp),
                        "flux", FluxConfig(**DIT), sd, (2 // fsdp, fsdp, 1),
                        64)
        placements, stats = out[0]
        assert out[1] == out[0]
        if fsdp == 1:
            assert stats["replicated"] == sum(v.size for v in sd.values())
            assert stats["sharded"] == stats["dim0_fallback"] == 0
            continue
        assert stats["sharded"] == jstats["sharded"]
        assert stats["dim0_fallback"] == jstats["replicated"]
        assert stats["replicated"] == 0 and stats["sharded_fraction"] == 1
        np.testing.assert_allclose(stats["rule_fraction"],
                                   jstats["sharded_fraction"])
        for name, size in sizes.items():
            size, dim = int(size.reshape(-1)[0]), placements[name]
            if size < 0:
                assert dim == 0, name
            else:
                assert sd[name].shape[dim] == size, name
                assert dim == mesh.spec_for_param(sd[name].shape, 2, 64)


@pytest.mark.parametrize("l", [256, 200], ids=["exact", "padded"])
def test_sp_attention_matches_jax(tmp_path, l):
    """Output and the gradients of ``sum(o * w)`` w.r.t. q, k, v at sp=2:
    heads divide, and at L=200 the gathered sequence pads to 256."""
    b, h, d = 2, 4, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, l, d)).astype(np.float32)
               for _ in range(3))
    time_ids = np.repeat(np.arange(l // 40 + 1, dtype=np.int32), 40)[:l]
    time_ids = np.broadcast_to(time_ids, (b, l)).copy()
    time_ids[1, -10:] = INVALID_TIME
    # a padded query row's output is unspecified and takes no gradient
    valid = (time_ids != INVALID_TIME)[:, None, :, None]
    w = rng.standard_normal(q.shape).astype(np.float32) * valid
    jm = jmesh.make_mesh(jmesh.MeshConfig(sp=2), devices=jax.devices()[:2])
    out = run_ranks(ranks.sp_attention, 2, tmp_path, q, k, v, time_ids, True,
                    w)
    o = np.concatenate([r[0] for r in out], axis=2)

    def f(q_, k_, v_):
        return jsp_flash(q_, k_, v_, jnp.asarray(time_ids), jm, causal=True)

    ref, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(w))
    np.testing.assert_allclose(o * valid, np.asarray(ref) * valid, atol=2e-5)
    one = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                            jnp.asarray(time_ids), causal=True))
    np.testing.assert_allclose(o * valid, one * valid, atol=2e-5)
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[1 + i] for r in out], axis=2)
        np.testing.assert_allclose(got, np.asarray(grads[i]), atol=2e-5,
                                   err_msg=name)


def _flux_case():
    dit_j, params, make_port = tiny_dits()
    rng = np.random.default_rng(3)
    b, l, lt = 2, 150, 8
    time = np.repeat(np.arange(3, dtype=np.int32), 50)[None].repeat(b, 0)
    mask = np.ones((b, lt), bool)
    mask[:, -2:] = False
    inputs = [rng.standard_normal((b, l, 16)).astype(np.float32),
              rng.uniform(0, 4, (b, l, 3)).astype(np.float32), time,
              rng.standard_normal((b, lt, 32)).astype(np.float32), mask,
              rng.standard_normal((b, 24)).astype(np.float32),
              np.array([700.0, 90.0], np.float32)]
    return (dit_j, params, make_port, "flux", FluxConfig(**DIT), inputs,
            flux_state_dict_from_jax)


def _mmdit_case():
    dit_j, params, make_port = tiny_mmdits()
    return (dit_j, params, make_port, "mmdit", MMDiTConfig(**MMDIT),
            list(tiny_layout()), mmdit_state_dict_from_jax)


@pytest.mark.parametrize("case", [_flux_case, _mmdit_case],
                         ids=["flux", "mmdit"])
def test_sp_dit_matches_jax(tmp_path, case):
    """sp=2: each rank's whole output and the parameter gradients of a
    weighted sum of the valid rows, against JAX's forward and ``jax.grad``.
    An sp rank's gradient is sp times its tokens' share (the gather at
    exit sums every rank's copy of the loss), so their mean is the
    model's gradient, what FSDP2's average makes of it in training."""
    dit_j, params, make_port, kind, cfg, inputs, to_port = case()
    valid = inputs[2][0] != INVALID_TIME
    b, l, c = inputs[0].shape[0], inputs[0].shape[1], inputs[0].shape[2]
    weight = np.random.default_rng(5).standard_normal((b, l, c)).astype(
        np.float32) * valid[None, :, None]

    def loss_j(p):
        return jnp.sum(dit_j.apply(p, *map(jnp.asarray, inputs)) * weight)

    ref = np.asarray(dit_j.apply(params, *map(jnp.asarray, inputs)))
    jgrads = to_port(jax.tree.map(np.array, jax.jit(jax.grad(loss_j))(
        params)))
    sd = {k: v.numpy() for k, v in make_port().state_dict().items()}
    out = run_ranks(ranks.dit_forward, 2, tmp_path, kind, cfg, sd, inputs,
                    weight, (1, 1, 2))
    n = make_port().num_attention_calls
    for o, _, (routes, classic) in out:
        np.testing.assert_allclose(o[:, valid], ref[:, valid], rtol=1e-4,
                                   atol=1e-4)
        # the DiT's route reaches flash_attention through Ulysses
        assert routes == [True] * n + [False] * n
        np.testing.assert_allclose(classic[:, valid], ref[:, valid],
                                   rtol=1e-4, atol=1e-4)
    got = {n: (out[0][1][n] + out[1][1][n]) / 2 for n in out[0][1]}
    for name, g in got.items():
        np.testing.assert_allclose(g, jgrads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
