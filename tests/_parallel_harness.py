"""Run a function on several gloo ranks in spawned processes (CPU).

The port's parallel tests call :func:`run_ranks` with a function of this
module or of another that imports neither JAX nor the JAX package: each
spawned process imports only torch and the port. Each rank joins a gloo
group through a ``file://`` rendezvous under the test's ``tmp_path`` (no
fixed port, so xdist workers never collide) and returns its result, which
the parent reads back in rank order.
"""

from __future__ import annotations

import os
import pickle
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# each rank runs on this many threads: the tests run under xdist
RANK_THREADS = 1


def _entry(rank: int, world: int, tmp: str, fn, args):
    torch.set_num_threads(RANK_THREADS)
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                                rank=rank, world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        out.write_bytes(pickle.dumps(("ok", result)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def run_ranks(fn, world: int, tmp_path, *args):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the list
    of their results. A rank that raises fails the call with its
    traceback."""
    tmp = Path(tmp_path) / f"ranks-{fn.__name__}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        mp.spawn(_entry, args=(world, str(tmp), fn, args), nprocs=world,
                 join=True)
    except Exception:
        for r in range(world):
            f = tmp / f"rank{r}.pkl"
            if f.exists():
                status, value = pickle.loads(f.read_bytes())
                if status == "error":
                    raise AssertionError(f"rank {r} failed:\n{value}")
        raise
    results = []
    for r in range(world):
        status, value = pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
        assert status == "ok", value
        results.append(value)
    return results
