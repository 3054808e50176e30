"""The (dp, fsdp, sp) device mesh, the rendezvous and the FSDP2 sharding rule.

The counterpart of the JAX package's ``parallel/mesh.py``. The port runs one
process per rank (``torchrun``), so its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX mesh's named dims:

  dp    data parallel (batch rows);
  fsdp  parameter and optimizer sharding, which also takes batch rows
        (ZeRO: parameters all-gathered per block, gradients reduce-scattered);
  sp    sequence parallel (Ulysses all_to_all around every attention).

Rank ``r`` sits at ``(r // (fsdp * sp), (r // sp) % fsdp, r % sp)``, JAX's
row-major device order. :func:`param_sharding` applies FSDP2
(``fully_shard``) per transformer block and then at the root over a
``(replicate, shard)`` mesh: ``shard`` is the fsdp dim, ``replicate`` the
dp and sp ranks together, so a gradient is averaged over every rank.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["MeshConfig", "make_mesh", "fsdp_mesh", "param_sharding",
           "maybe_initialize_distributed", "spec_for_param", "mesh_dim",
           "data_rank", "SP_AXIS"]

SP_AXIS = "sp"
MESH_DIMS = ("dp", "fsdp", "sp")
# torchrun's env:// contract, the reference's own
_RENDEZVOUS_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                   "MASTER_PORT")


def maybe_initialize_distributed(device_type: str = "cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment. Returns whether a default group exists afterwards.

    A no-op when no rendezvous variable is set (one process) and when a
    default group is already initialised (a harness that made its own). The
    backend follows the device: NCCL for ``cuda``, gloo for ``cpu``; on CUDA
    the rank's device is ``LOCAL_RANK``. As in JAX, a broken rendezvous
    (some variables set, others missing, or a failing init) raises: a run
    that silently trains on 1/N of its ranks is the worst failure."""
    if dist.is_available() and dist.is_initialized():
        return True
    present = [k for k in _RENDEZVOUS_ENV if k in os.environ]
    if not present:
        return False
    missing = [k for k in _RENDEZVOUS_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"rendezvous environment incomplete: {present} set, {missing} "
            "missing; refusing to fall back to one process")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    backend = "nccl" if device_type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method="env://")
    except Exception as e:
        logging.getLogger(__name__).error(
            "init_process_group(%s) failed with %s set: %s; refusing to "
            "fall back to one process", backend, present, e)
        raise
    return True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.sp


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The (dp, fsdp, sp) mesh over the default group's ranks. Defaults:
    every rank on fsdp. Needs an initialised default group (a world of one
    is fine)."""
    world = dist.get_world_size()
    if config is None:
        config = MeshConfig(fsdp=world)
    if config.num_devices != world:
        raise ValueError(f"mesh {config} needs {config.num_devices} ranks, "
                         f"the group has {world}")
    return init_device_mesh(device_type, (config.dp, config.fsdp, config.sp),
                            mesh_dim_names=MESH_DIMS)


def mesh_dim(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of ``mesh``'s dim ``name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def data_rank(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """``(index, count)`` of this rank's batch slice: the ranks of one sp
    group share it, dp x fsdp ranks split the batch."""
    if mesh is None:
        return 0, 1
    coord = mesh.get_coordinate()
    fsdp = mesh_dim(mesh, "fsdp")
    return coord[0] * fsdp + coord[1], mesh_dim(mesh, "dp") * fsdp


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 2-D ``(replicate, shard)`` mesh FSDP2 runs on: ``shard`` is the
    fsdp dim, ``replicate`` the dp and sp ranks of each fsdp position."""
    ranks = mesh.mesh.permute(0, 2, 1)  # (dp, sp, fsdp)
    return DeviceMesh(mesh.device_type,
                      ranks.reshape(-1, mesh_dim(mesh, "fsdp")),
                      mesh_dim_names=("replicate", "shard"))


def spec_for_param(shape: Tuple[int, ...], fsdp_size: int,
                   min_dim: int = 1024) -> Optional[int]:
    """The dim JAX's ``_spec_for_param`` shards a parameter on, or None
    where it replicates: the largest dim (the later of equals) that is at
    least ``min_dim`` and divides by ``fsdp_size``."""
    if fsdp_size == 1 or not shape:
        return None
    for dim in sorted(range(len(shape)), key=lambda i: (shape[i], i),
                      reverse=True):
        if shape[dim] >= min_dim and shape[dim] % fsdp_size == 0:
            return dim
    return None


def _blocks(module: nn.Module):
    """The repeated blocks FSDP2 wraps one by one: the elements of every
    ``ModuleList`` named ``*blocks``."""
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList) and name.endswith("blocks"):
            yield from child


def param_sharding(module: nn.Module, mesh: DeviceMesh, *,
                   min_shard_dim: int = 1024, verbose: bool = True,
                   stats_out: Optional[dict] = None) -> nn.Module:
    """Shard ``module`` with FSDP2 over ``mesh``'s fsdp dim, in place:
    ``fully_shard`` on each transformer block, then on the root. Returns
    the module.

    Each parameter is sharded on the dim :func:`spec_for_param` picks (JAX's
    rule). FSDP2 cannot leave a parameter whole: one JAX replicates is
    sharded on dim 0 (padded where it does not divide). ``stats_out``
    receives element counts: ``sharded`` (on JAX's dim), ``dim0_fallback``
    (JAX replicates, FSDP2 shards on dim 0), ``replicated`` (whole on every
    rank: all of them when fsdp is 1, else none), ``sharded_fraction``
    (what FSDP2 shards, over all) and ``rule_fraction`` (``sharded`` over
    all, JAX's ``sharded_fraction``)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    fsdp_size = mesh_dim(mesh, "fsdp")
    stats = {"sharded": 0, "dim0_fallback": 0, "replicated": 0}
    placements = {}
    for p in module.parameters():
        dim = spec_for_param(tuple(p.shape), fsdp_size, min_shard_dim)
        placements[p] = dim
        key = ("replicated" if fsdp_size == 1 else
               "sharded" if dim is not None else "dim0_fallback")
        stats[key] += p.numel()

    def placement(p):
        dim = placements.get(p)
        return None if dim is None else Shard(dim)

    fmesh = fsdp_mesh(mesh)
    for block in _blocks(module):
        fully_shard(block, mesh=fmesh, shard_placement_fn=placement)
    fully_shard(module, mesh=fmesh, shard_placement_fn=placement)

    total = max(sum(stats.values()), 1)
    stats["sharded_fraction"] = (stats["sharded"]
                                 + stats["dim0_fallback"]) / total
    stats["rule_fraction"] = stats["sharded"] / total
    if stats_out is not None:
        stats_out.update(stats)
    if verbose and fsdp_size > 1 and dist.get_rank() == 0:
        print(f"param_sharding: fsdp={fsdp_size}, "
              f"{stats['sharded'] / 1e6:.1f}M params on JAX's dim, "
              f"{stats['dim0_fallback'] / 1e6:.1f}M on dim 0 where JAX "
              f"replicates", file=sys.stderr)
    return module
