"""The benchmark's yardstick: the card's published peaks, the least time a
piece of work could take on it, the work of the DiTs' layers counted from
their shapes, and the device's busy time from a trace.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its 700 W limit,
dense bf16 without sparsity; a card set below 700 W runs slower under load,
so every figure is printed beside the card's power limit.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
INVALID_TIME = 2 ** 30
BF16_BYTES = 2


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the operations at the bf16
    peak or the bytes at the memory rate, whichever is larger."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def visible_pairs(times: np.ndarray) -> int:
    """(query, key) pairs of one row's time ids that attention must score:
    both valid, and the key's time at most the query's."""
    t = np.asarray(times, np.int64)
    valid = np.sort(t[t != INVALID_TIME])
    return int(np.searchsorted(valid, valid, side="right").sum())


def attention_work(times: np.ndarray, heads: int, head_dim: int, rows: int
                   ) -> Tuple[float, float]:
    """(flops, bytes) of one attention call over ``rows`` batch rows of the
    layout ``times`` (text included): 4 * head_dim per visible pair and head
    (q.k and p.v), and q, k, v and o in bf16 read or written once."""
    flops = 4.0 * head_dim * heads * visible_pairs(times) * rows
    nbytes = 4.0 * rows * heads * len(times) * head_dim * BF16_BYTES
    return flops, nbytes


def matmul_flops(specs: Iterable[Tuple[str, Tuple[int, ...]]], text: int,
                 latent: int) -> float:
    """2 per multiply-add of every matrix product of one DiT row with
    ``text`` text and ``latent`` latent tokens, from its weights' names and
    shapes: the conditioning linears (the time and pooled-text MLPs, the
    adaptive norms) once per row, the text stream's per text token, the
    single blocks' per token of both, the rest per latent token."""
    total = 0.0
    for name, shape in specs:
        if not name.endswith("weight") or len(shape) < 2:
            continue
        macs = int(np.prod(shape))
        if name.startswith("time_text_embed") or ".norm" in name \
                or name.startswith("norm_out"):
            tokens = 1
        elif name.startswith("single_transformer_blocks"):
            tokens = text + latent
        elif name.startswith("context_embedder") or any(
                k in name for k in (".add_", "to_add_out", "ff_context")):
            tokens = text
        else:
            tokens = latent
        total += 2.0 * macs * tokens
    return total


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (nanoseconds), in s."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9
