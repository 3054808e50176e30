"""Inputs and weights made from the run's seed, on the device.

The benchmark makes them and hands the same to the program and to the
reference. Weights are drawn in a few large calls of one generator on the
device, in the type they are served in: standard normals in chunks, each
leaf a slice of them times ``std`` (plus one for a norm's gain), so no layer
is zero and q and k keep the RMS their norms give them.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Tuple

import torch

CHUNK = 1 << 29  # normals per draw


def sub_seed(seed: int, tag: int) -> int:
    """A generator seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + tag) % (1 << 63)


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, tag))


def seeded_weights(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                   tag: int, device, dtype: torch.dtype, std: float = 0.02
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for each of ``specs`` (sorted (name, shape)
    pairs): N(0, std), and 1 + N(0, std) for a 1-D ``*norm*.weight``, drawn
    in chunks of at most ``CHUNK`` normals in ``dtype``."""
    gen = generator(seed, tag, device)
    specs = list(specs)
    i = 0
    while i < len(specs):
        j, n = i, 0
        while j < len(specs) and (j == i or n + math.prod(specs[j][1])
                                  <= CHUNK):
            n += math.prod(specs[j][1])
            j += 1
        flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
        at = 0
        for name, shape in specs[i:j]:
            k = math.prod(shape)
            w = flat[at:at + k].view(shape) * std
            if len(shape) == 1 and "norm" in name and name.endswith("weight"):
                w = w + 1
            yield name, w
            at += k
        del flat
        i = j


def load_into(module: torch.nn.Module,
              weights: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Copy ``weights`` into ``module``'s parameters, which must be exactly
    the same names and shapes."""
    params = dict(module.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, w in weights:
            if name not in params:
                raise KeyError(f"drawn {name}, which the model lacks")
            if tuple(params[name].shape) != tuple(w.shape):
                raise ValueError(f"{name}: model {tuple(params[name].shape)}, "
                                 f"drawn {tuple(w.shape)}")
            params[name].copy_(w)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"parameters the benchmark does not draw: "
                       f"{missing[:5]}")
