"""Port parity: the forward kernel's tile classification.

``tile_types``, the port's plain copy of the TPU rule that the forward kernel
applies to each of its tiles, against the JAX package's ``_tile_types`` on the
DiT's packed attention layouts as ``_stage_metadata`` builds them (384x640,
every stage of units 0, 1 and 15, behind the 128-token prompt whose last 28
tokens are masked), causal and not, at the kernel's tiles (64 query rows,
128 keys) and at the TPU kernel's (128, 128); and with Lq != Lk at a length
that is no multiple of the tile, which the port pads with INVALID_TIME as the
TPU wrapper pads it. Integer rules: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.ops import flash_attention as jfa
from pyramid_flow_tpu_torch.ops import flash_attention as fa
from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
    PyramidFlowPipeline)

INVALID = fa.INVALID_TIME


def _layouts():
    """[2, L] time ids of the DiT at every (unit, stage) below."""
    pipe = PyramidFlowPipeline(None, device="cpu")
    text = np.zeros(128, np.int32)
    text[100:] = INVALID
    out = []
    for unit in (0, 1, 15):
        budgets = pipe._cond_token_budget(unit, 48, 80)
        for stage in range(3):
            _, time_ids, _ = pipe._stage_metadata(2, 1, 48, 80, unit, stage,
                                                  budgets[stage])
            t = np.concatenate([text, np.asarray(time_ids)])
            out.append(np.ascontiguousarray(np.broadcast_to(t, (2, t.size)),
                                            np.int32))
    return out


def _pad(t, size):
    pad = -t.shape[1] % size
    return np.pad(t, ((0, 0), (0, pad)), constant_values=INVALID)


@pytest.mark.parametrize("tiles", [(fa.FWD_TILE_Q, fa.FWD_TILE_K),
                                   (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_types_match_jax_on_the_dit_layouts(causal, tiles):
    bq, bk = tiles
    seen = set()
    for t in _layouts():
        got = fa.tile_types(torch.from_numpy(t), torch.from_numpy(t), bq, bk,
                            causal).numpy()
        want = np.asarray(jfa._tile_types(jnp.asarray(_pad(t, bq)),
                                          jnp.asarray(_pad(t, bk)), bq, bk,
                                          causal))
        np.testing.assert_array_equal(got, want)
        seen.update(np.unique(got).tolist())
    # the layouts reach every type
    assert seen == {fa.TILE_SKIP, fa.TILE_FULL, fa.TILE_MASKED}


@pytest.mark.parametrize("causal", [True, False])
def test_tile_types_match_jax_on_ragged_cross_lengths(causal):
    """The first 1000 queries of the last layout against all its keys."""
    t = _layouts()[-1]
    tq = np.ascontiguousarray(t[:, :1000])
    got = fa.tile_types(torch.from_numpy(tq), torch.from_numpy(t),
                        fa.FWD_TILE_Q, fa.FWD_TILE_K, causal).numpy()
    want = np.asarray(jfa._tile_types(
        jnp.asarray(_pad(tq, fa.FWD_TILE_Q)),
        jnp.asarray(_pad(t, fa.FWD_TILE_K)), fa.FWD_TILE_Q, fa.FWD_TILE_K,
        causal))
    assert got.shape == (2, 16, -(-t.shape[1] // fa.FWD_TILE_K))
    np.testing.assert_array_equal(got, want)
