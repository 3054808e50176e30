"""What each gloo rank of the port's parallel tests runs.

Torch and the port only: :func:`_parallel_harness.run_ranks` spawns
processes that import this module, and the tests compare what the ranks
return with the JAX package in the pytest process. Inputs arrive as numpy
arrays and state dicts; results go back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pyramid_flow_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def _np(t):
    return t.detach().float().cpu().numpy()


class ReplayDraws:
    """A draw source that replays a table of draws recorded in the pytest
    process (``test_torch_port_parallel_train.RecordingDraws`` over JAX's
    keys), keyed by the path of ``split``/``fold_in`` calls and the draw's
    kind and shape: JAX's draws are functions of (key, shape), so a rank
    that asks for a draw by the same path gets the same values."""

    def __init__(self, table, path=()):
        self.table, self.path = table, path

    def _draw(self, kind, shape):
        return torch.from_numpy(self.table[(self.path, kind, tuple(shape))])

    def normal(self, shape):
        return self._draw("normal", shape)

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def split(self, n):
        return [ReplayDraws(self.table, self.path + (("split", n, i),))
                for i in range(n)]

    def fold_in(self, data):
        return ReplayDraws(self.table, self.path + (("fold", int(data)),))


def sp_attention(rank, world, q, k, v, time_ids, causal, weight):
    """``sp_flash_attention`` over all ranks: this rank's output shard and
    the three gradients of ``sum(o * weight)``."""
    from pyramid_flow_tpu_torch.parallel.sp import sp_flash_attention

    lsh = q.shape[2] // world
    sl = slice(rank * lsh, (rank + 1) * lsh)
    qs, ks, vs = (torch.tensor(x[:, :, sl], requires_grad=True)
                  for x in (q, k, v))
    o = sp_flash_attention(qs, ks, vs, torch.from_numpy(time_ids),
                           dist.group.WORLD, causal=causal)
    (o * torch.from_numpy(weight[:, :, sl])).sum().backward()
    return _np(o), _np(qs.grad), _np(ks.grad), _np(vs.grad)


def _tiny_dit(kind, config, state_dict, mesh):
    if kind == "flux":
        from pyramid_flow_tpu_torch.models.flux.model import (
            PyramidFluxTransformer as cls)
    else:
        from pyramid_flow_tpu_torch.models.mmdit.model import (
            PyramidDiffusionMMDiT as cls)
    dit = cls(config, device="cpu", mesh=mesh)
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in
                         state_dict.items()})
    return dit


def dit_forward(rank, world, kind, config, state_dict, inputs, weight,
                mesh_shape):
    """The DiT's forward on every rank of a (dp, fsdp, sp) mesh, and each
    parameter's gradient of ``sum(out * weight)``; then the softmax form
    that reached ``flash_attention`` in each attention of that forward and
    of one forward on the classic route (``bounded_softmax=False``), with
    the classic forward's output."""
    from pyramid_flow_tpu_torch.parallel import sp

    mesh = make_mesh(MeshConfig(*mesh_shape), "cpu")
    dit = _tiny_dit(kind, config, state_dict, mesh)
    args = [torch.from_numpy(x) for x in inputs]
    routes = []
    real = sp.flash_attention

    def spy(*a, bounded=None, **kw):
        routes.append(bounded)
        return real(*a, bounded=bounded, **kw)

    sp.flash_attention = spy
    try:
        out = dit(*args)
        (out * torch.from_numpy(weight)).sum().backward()
        dit.bounded_softmax = False
        with torch.no_grad():
            classic = dit(*args)
    finally:
        sp.flash_attention = real
    return _np(out), {n: _np(p.grad) for n, p in dit.named_parameters()
                      if p.grad is not None}, (routes, _np(classic))


def train_steps(rank, world, kind, config, state_dict, batch, units,
                mesh_shape, min_shard_dim, key, steps, lr, accum_steps=1,
                use_temporal_pyramid=True):
    """``steps`` DiT train steps (of ``accum_steps`` micro-batches) on a
    (dp, fsdp, sp) mesh with FSDP2, each rank on its slice of ``batch``,
    on the AR recipe or (``use_temporal_pyramid=False``) the full-sequence
    one. ``key``: a table of recorded draws
    (:class:`ReplayDraws`), or an int seed for a torch generator. Returns per step (loss, grad_norm) and, on rank 0, the
    parameters and EMA after the steps, the sharding stats and a
    checkpoint round trip's parameters."""
    from pyramid_flow_tpu_torch.parallel.mesh import data_rank, param_sharding
    from pyramid_flow_tpu_torch.pipeline.noising import GeneratorDraws
    from pyramid_flow_tpu_torch.schedulers.flow_matching import (
        PyramidFlowMatchEulerDiscreteScheduler)
    from pyramid_flow_tpu_torch.training.train_state import (
        TrainConfig, create_train_state)
    from pyramid_flow_tpu_torch.training.trainer import make_train_step

    mesh = make_mesh(MeshConfig(*mesh_shape), "cpu")
    dit = _tiny_dit(kind, config, state_dict, mesh)
    stats = {}
    param_sharding(dit, mesh, min_shard_dim=min_shard_dim, stats_out=stats,
                   verbose=False)
    state = create_train_state(dit, TrainConfig(learning_rate=lr,
                                                ema_decay=0.9))
    step = make_train_step(dit, PyramidFlowMatchEulerDiscreteScheduler(),
                           use_temporal_pyramid=use_temporal_pyramid,
                           accum_steps=accum_steps, mesh=mesh)
    index, count = data_rank(mesh)
    b = next(iter(batch.values())).shape[0] // count
    local = {k: torch.from_numpy(np.ascontiguousarray(
        v[index * b:(index + 1) * b])) for k, v in batch.items()}
    if isinstance(key, int):
        draws = GeneratorDraws(torch.Generator().manual_seed(key))
    else:
        draws = ReplayDraws(key)
    metrics = []
    for _ in range(steps):
        state, m = step(state, local, draws, units)
        metrics.append((m["train/loss"], m["train/grad_norm"]))
    full = state.state_dict()
    out = {"metrics": metrics, "stats": stats}
    if rank == 0:
        out["params"] = {n: t.numpy() for n, t in full["params"].items()}
        out["ema"] = {n: t.numpy() for n, t in full["ema"].items()}
        out["step"] = full["step"]
    # the checkpoint loads back on every rank, each keeping its shards
    dist.broadcast_object_list(obj := [full if rank == 0 else None])
    state.load_state_dict(obj[0])
    again = state.state_dict()
    if rank == 0:
        out["reloaded"] = all(np.array_equal(again["params"][n].numpy(),
                                             out["params"][n])
                              for n in out["params"])
    return out


def _vae(config, state_dict):
    from pyramid_flow_tpu_torch.models.vae.model import (CausalVideoVAE,
                                                         VAEConfig)
    vae = CausalVideoVAE(VAEConfig(**config), device="cpu")
    vae.load_state_dict({k: torch.from_numpy(v)
                         for k, v in state_dict.items()}, strict=True)
    return vae


def cp_encode_decode(rank, world, config, state_dict, x, z):
    """``cp_vae_apply(vae.encode)`` of ``x`` and ``cp_vae_decode`` of ``z``
    over all ranks as the cp group, and each rank's local halo of a ramp
    (the exchange's semantics), with the gradient that a weighted sum of
    every rank's halo sends back to each rank's frames."""
    from pyramid_flow_tpu_torch.parallel.cp import (
        cp_vae_apply, cp_vae_decode, halo_exchange)

    group = dist.group.WORLD
    vae = _vae(config, state_dict)
    with torch.no_grad():
        enc = cp_vae_apply(lambda s: vae.encode(s), torch.from_numpy(x),
                           group)
        dec = cp_vae_decode(vae, torch.from_numpy(z), group)
    ramp = (torch.arange(2, dtype=torch.float32) + 2 * rank)
    ramp = ramp.reshape(1, 2, 1, 1, 1).expand(1, 2, 2, 2, 1).clone()
    ramp.requires_grad_(True)
    halo = halo_exchange(ramp, 2, group)
    (halo * (1 + torch.arange(4.0).reshape(1, 4, 1, 1, 1))).sum().backward()
    return (_np(enc), _np(dec), _np(halo[0, :, 0, 0, 0]),
            _np(ramp.grad[0, :, 0, 0, 0]))


def vae_grads(rank, world, config, vae_sd, lpips_sd, disc_sd, disc_cfg,
              use_3d, video, key, mesh_shape):
    """The GAN step's ``grads_only`` gradients and metrics (the
    discriminator on) on a ("dp", "cp") mesh, each rank on its shard of
    ``video``; rank 0 returns the gradients."""
    from pyramid_flow_tpu_torch.models.vae.discriminator import (
        PatchDiscriminator2D, PatchDiscriminator3D)
    from pyramid_flow_tpu_torch.models.vae.lpips import LPIPS
    from pyramid_flow_tpu_torch.parallel.cp import make_cp_mesh
    from pyramid_flow_tpu_torch.training import vae_trainer

    dp, cp = mesh_shape
    mesh = make_cp_mesh(dp, cp, "cpu")
    vae = _vae(config, vae_sd)
    lpips = LPIPS(device="cpu")
    lpips.load_state_dict({k: torch.from_numpy(v)
                           for k, v in lpips_sd.items()})
    disc = (PatchDiscriminator3D if use_3d else PatchDiscriminator2D)(
        **disc_cfg, device="cpu")
    disc.load_state_dict({k: torch.from_numpy(v) for k, v in disc_sd.items()})
    cfg = vae_trainer.VAETrainConfig(disc_start=0, learning_rate=1e-4,
                                     disc_learning_rate=1e-4)
    state = vae_trainer.create_vae_train_state(vae, disc, cfg)
    d, c = mesh.get_coordinate()
    b, t = video.shape[0] // dp, video.shape[1] // cp
    local = torch.from_numpy(np.ascontiguousarray(
        video[d * b:(d + 1) * b, c * t:(c + 1) * t]))
    grads = vae_trainer.make_vae_train_step(
        vae, lpips, disc, use_3d_disc=use_3d, is_init=False, mesh=mesh,
        grads_only=True)
    gen, dgrads, metrics = grads(state, local, ReplayDraws(key))
    if rank:
        return metrics
    return metrics, {k: _np(v) for k, v in gen["vae"].items()}, \
        _np(gen["logvar"]), {k: _np(v) for k, v in dgrads.items()}


def sharding_placements(rank, world, kind, config, state_dict, mesh_shape,
                        min_shard_dim):
    """FSDP2's shard dim of each parameter (None: not a DTensor shard) and
    ``param_sharding``'s stats."""
    from torch.distributed.tensor import Shard

    from pyramid_flow_tpu_torch.parallel.mesh import param_sharding

    mesh = make_mesh(MeshConfig(*mesh_shape), "cpu")
    dit = _tiny_dit(kind, config, state_dict, None)
    stats = {}
    param_sharding(dit, mesh, min_shard_dim=min_shard_dim, stats_out=stats,
                   verbose=False)
    dims = {}
    for name, p in dit.named_parameters():
        shard = [pl for pl in p.placements if isinstance(pl, Shard)]
        dims[name] = shard[0].dim if shard and mesh_shape[1] > 1 else None
    return dims, stats


def serve_sp(rank, world, req):
    """One request of the serving app's ``--debug_tiny`` pipeline with the
    DiT sequence-parallel over every rank: rank 0 takes it through
    ``ServingApp.handle`` (the HTTP server's call, which broadcasts it) and
    returns its (body, content type); the other ranks follow."""
    from pyramid_flow_tpu_torch.tools.serve import (ServingApp,
                                                    build_debug_tiny)

    mesh = make_mesh(MeshConfig(sp=world), "cpu")
    pipe, te = build_debug_tiny(mesh)
    app = ServingApp(pipe=pipe, text_encoder=te, mesh=mesh)
    if rank:
        app.follow()
        return None
    out = app.handle(req)
    app.release_followers()
    return out


def _gathered(state):
    """``state.state_dict()`` (rank 0: the whole state) as numpy."""
    full = state.state_dict()
    return {"step": full["step"], "opt_count": full["opt_count"],
            "params": {n: _np(t) for n, t in full["params"].items()},
            "ema": {n: _np(t) for n, t in full["ema"].items()},
            "optimizer": {i: {k: _np(v) for k, v in s.items()}
                          for i, s in full["optimizer"].get(
                              "state", {}).items()}}


def dcp_save_resume(rank, world, kind, config, state_dict, batch, units,
                    save_shape, load_shape, path):
    """One train step on a ``save_shape`` mesh, the state saved with
    ``save_sharded`` to ``path``, then a fresh model and state on a
    ``load_shape`` mesh restored with ``load_sharded``. Returns, on rank 0,
    the gathered state after the step and after the restore, and on every
    rank the state dict of ``from_train_state(use_ema=True)``'s DiT."""
    from pyramid_flow_tpu_torch.parallel.mesh import param_sharding
    from pyramid_flow_tpu_torch.pipeline.noising import GeneratorDraws
    from pyramid_flow_tpu_torch.schedulers.flow_matching import (
        PyramidFlowMatchEulerDiscreteScheduler)
    from pyramid_flow_tpu_torch.training.train_state import (
        TrainConfig, create_train_state)
    from pyramid_flow_tpu_torch.training.trainer import make_train_step

    def sharded_state(shape):
        mesh = make_mesh(MeshConfig(*shape), "cpu")
        dit = _tiny_dit(kind, config, state_dict, mesh)
        param_sharding(dit, mesh, min_shard_dim=16, verbose=False)
        return mesh, create_train_state(dit, TrainConfig(learning_rate=1e-3,
                                                         ema_decay=0.9))

    mesh, state = sharded_state(save_shape)
    from pyramid_flow_tpu_torch.parallel.mesh import data_rank
    index, count = data_rank(mesh)
    b = next(iter(batch.values())).shape[0] // count
    local = {k: torch.from_numpy(np.ascontiguousarray(
        v[index * b:(index + 1) * b])) for k, v in batch.items()}
    step = make_train_step(state.model,
                           PyramidFlowMatchEulerDiscreteScheduler(),
                           mesh=mesh)
    step(state, local, GeneratorDraws(torch.Generator().manual_seed(0)),
         units)
    saved = _gathered(state)
    # the EMA's inference DiT, gathered on every rank
    from pyramid_flow_tpu_torch.pipeline.pyramid_pipeline import (
        PyramidFlowPipeline)
    pipe = PyramidFlowPipeline.from_train_state(
        state.model, state, use_ema=True, dtype=torch.float32, device="cpu")
    ema_dit = {n: _np(t) for n, t in pipe.dit.state_dict().items()}
    state.save_sharded(path)
    _, resumed = sharded_state(load_shape)
    resumed.load_sharded(path)
    again = _gathered(resumed)
    return (saved, again, ema_dit) if rank == 0 else ema_dit
