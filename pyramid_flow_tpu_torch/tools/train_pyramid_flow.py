"""DiT training CLI of the port (AR temporal pyramid or full sequence).

    python -m pyramid_flow_tpu_torch.tools.train_pyramid_flow --debug_tiny \\
        --epochs 1 --steps_per_epoch 2 --output_dir runs/dit

The flags are those of the JAX package's ``tools/train_pyramid_flow.py``.
Supported: both DiT families (``--model_name pyramid_flux`` or
``pyramid_mmdit``), the synthetic ``--debug_tiny`` run (on the CPU in fp32:
a tiny DiT, or with ``--model_path`` the checkpoint's), ``--anno_file``
(pre-extracted latents and text features, read by the port's numpy data
loaders, ``pyramid_flow_tpu_torch.data``), the schedule, pyramid and
logging flags, ``--gradient_checkpointing``, ``--bound_probe_freq``,
``--output_dir`` and ``--auto_resume``. ``--classic_softmax`` trains with
every DiT attention on the classic online softmax (K2, whose ``lse`` the
backward kernels take as they take the bounded one's), the counterpart of
JAX's ``PF_BOUNDED_SOFTMAX=0``: the remedy the overshoot probe's warning
names when fine-tuned qk-norm gains leave the bounded forward's envelope.
The probe runs on both routes. The full-size DiT trains on one
CUDA device with fp32 parameters and bf16 autocast.

``--model_path`` finetunes the released DiT of ``--model_variant`` (its
``config.json`` sizes it). ``--load_text_encoder`` runs the checkpoint's
frozen CLIP/T5 over each batch's raw text (:func:`fill_text_features`), and
the null features of the CFG drop are then the empty prompt's unless
``--null_text_fea`` gives them. ``--load_vae`` loads the checkpoint's VAE
into the train step, which encodes raw-pixel batches (``video``; the
``--debug_tiny`` batches are then pixels).

Parallelism: under ``torchrun`` (one process per rank; NCCL on CUDA, gloo
for ``--debug_tiny`` on the CPU) the ranks form a (``--dp``, ``--fsdp``,
``--sp``) mesh (``--fsdp 0``: all the ranks left), the DiT is sequence
parallel over sp and sharded with FSDP2 over fsdp (``--fsdp_min_shard_dim``
as in JAX), and each rank trains on its rows of the global
``--batch_size`` batch (every rank reads the same batch and keeps its
rows)::

    torchrun --nproc_per_node 4 -m pyramid_flow_tpu_torch.tools.train_pyramid_flow \
        --fsdp 2 --sp 2 --anno_file ANNO ...

A world of one under ``torchrun`` also takes the FSDP2 route.

Checkpoints, every ``--save_ckpt_freq`` epochs: on one device
``<output_dir>/checkpoint-<step>.pt`` (step, parameters, optimizer and EMA,
``torch.save``); under FSDP2 ``checkpoint-<step>/``, a
``torch.distributed.checkpoint`` directory to which each rank writes its
own shards (the counterpart of JAX's Orbax checkpoints); and beside either
``checkpoint-<step>-ema.pt`` (``utils.checkpoint.export_ema_params``: the
EMA weights and persistent buffers keyed like the released checkpoint,
gathered to rank 0). ``--auto_resume`` continues from the newest step of
either form, at the epoch that step falls in: a directory restores at any
mesh or on one device, and a ``.pt`` file at any world size too. A step's
random draws and its ``--debug_tiny`` batch depend on (seed, step) alone,
so a resumed run repeats the steps an uninterrupted run would take.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Optional

import numpy as np
import torch

__all__ = ["main", "parse_args", "latest_checkpoint", "save_checkpoint",
           "restore_checkpoint", "fill_text_features"]

DEBUG_PROMPTS = ("a cat walks on grass", "a hiker on a ridge",
                 "waves at dusk", "a red kite over a beach")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--model_name", default="pyramid_flux",
                   choices=["pyramid_flux", "pyramid_mmdit"])
    p.add_argument("--model_path", default=None,
                   help="released checkpoint root to finetune from")
    p.add_argument("--model_variant", default="diffusion_transformer_768p")
    p.add_argument("--load_vae", action="store_true",
                   help="train from raw pixels (otherwise pre-extracted latents)")
    p.add_argument("--load_text_encoder", action="store_true",
                   help="train from raw text through the frozen T5/CLIP "
                        "encoders instead of pre-extracted features")
    # data
    p.add_argument("--anno_file", default=None,
                   help="required unless --debug_tiny (synthetic batches)")
    p.add_argument("--null_text_fea", default=None,
                   help="null_text.npz from extract_text_features.py")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_frames", type=int, default=16)
    # schedule / optimization
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--gradient_checkpointing", action="store_true")
    # pyramid
    p.add_argument("--use_temporal_pyramid", action="store_true", default=True)
    p.add_argument("--no_temporal_pyramid", dest="use_temporal_pyramid",
                   action="store_false")
    p.add_argument("--sample_ratios", type=int, nargs=3, default=[1, 2, 1])
    p.add_argument("--max_temporal_length", type=int, default=31)
    p.add_argument("--frame_per_unit", type=int, default=1)
    p.add_argument("--video_sync_group", type=int, default=8)
    p.add_argument("--corrupt_ratio", type=float, default=1 / 3)
    # parallelism
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=0, help="0 = all remaining")
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--fsdp_min_shard_dim", type=int, default=1024)
    # checkpointing / logging
    p.add_argument("--output_dir", default="runs/dit")
    p.add_argument("--save_ckpt_freq", type=int, default=1, help="epochs")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--bound_probe_freq", type=int, default=500,
                   help="log train/bound_overshoot_log2 every N steps and "
                        "warn when the bounded flash kernel's exactness "
                        "envelope is at risk (0 disables)")
    p.add_argument("--classic_softmax", action="store_true",
                   help="every DiT attention on the classic online softmax "
                        "(exact at any qk-norm gain) instead of the bounded "
                        "one")
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_tiny", action="store_true",
                   help="on the CPU in fp32 with synthetic batches, a tiny "
                        "DiT unless --model_path (CI/smoke testing)")
    return p.parse_args(argv)


def outside_torchrun(args) -> Optional[str]:
    """The message for parallelism flags given outside ``torchrun``, or
    None."""
    import torch.distributed as dist

    if (args.sp > 1 or args.fsdp > 1 or args.dp > 1) and not (
            dist.is_available() and dist.is_initialized()):
        return ("--sp/--fsdp/--dp > 1 run one process per rank: launch "
                "with torchrun --nproc_per_node N")
    return None


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The path of the newest step's checkpoint in ``output_dir``, of
    either form: a ``checkpoint-<step>/`` directory
    (``torch.distributed.checkpoint``) or a ``checkpoint-<step>.pt`` file;
    the directory where a step has both."""
    if not os.path.isdir(output_dir):
        return None
    found = {}
    for name in os.listdir(output_dir):
        path = os.path.join(output_dir, name)
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and os.path.isdir(path):
            found[int(m.group(1))] = path
        m = re.fullmatch(r"checkpoint-(\d+)\.pt", name)
        if m:
            found.setdefault(int(m.group(1)), path)
    return found[max(found)] if found else None


def save_checkpoint(output_dir: str, step: int, state,
                    rank: int = 0) -> None:
    """Write the step's checkpoints: sharded, ``checkpoint-<step>/`` (each
    rank its own shards; a collective, every rank calls it), else
    ``checkpoint-<step>.pt``; then the EMA export (gathered to rank 0)."""
    from ..utils.checkpoint import export_ema_params

    if state.sharded:
        state.save_sharded(os.path.join(output_dir, f"checkpoint-{step}"))
    elif rank == 0:
        os.makedirs(output_dir, exist_ok=True)
        torch.save(state.state_dict(),
                   os.path.join(output_dir, f"checkpoint-{step}.pt"))
    ema = state.ema_state_dict()
    if rank == 0:
        export_ema_params(output_dir, step, ema)


def restore_checkpoint(path: str, state, device) -> None:
    """Load ``path``, a checkpoint directory or ``.pt`` file of either
    world size, into ``state`` (sharded: every rank calls it)."""
    if os.path.isdir(path):
        state.load_sharded(path)
    else:
        state.load_state_dict(torch.load(
            path, map_location="cpu" if state.sharded else device,
            weights_only=True))


def fill_text_features(batch_np: dict, text_encoder) -> dict:
    """A raw-text batch with the fields pre-extracted features give
    (``text_emb``, ``text_mask``, ``pooled``, as numpy), from the frozen
    encoders. The CFG drop happens in the train step, which puts the null
    features in place of a dropped row's."""
    emb, mask, pooled = text_encoder(list(batch_np["text"]))
    out = dict(batch_np)
    out["text_emb"] = emb.float().cpu().numpy()
    out["text_mask"] = mask.cpu().numpy()
    out["pooled"] = pooled.float().cpu().numpy()
    return out


def null_features(text_encoder) -> dict:
    """The empty prompt's features, the null features of the CFG drop when
    ``--null_text_fea`` does not give them (what ``extract_text_features``
    writes to ``null_text.npz``)."""
    emb, _, pooled = text_encoder("")
    return {"prompt_embed": emb[0].float().cpu().numpy(),
            "pooled_prompt_embed": pooled[0].float().cpu().numpy()}


def synthetic_batch(args, dit, step: int, pixels: bool = False,
                    text: bool = False) -> dict:
    """The ``--debug_tiny`` batch of one step, a function of (seed, step):
    latents, or with ``pixels`` the 8x8x8 larger raw video in [-1, 1]; text
    features, or with ``text`` prompts."""
    gen = np.random.default_rng((args.seed, step))
    cfg, c = dit.config, dit.latent_channels
    t = 1 + args.frame_per_unit * 2
    b = args.batch_size
    if pixels:
        out = {"video": gen.uniform(-1, 1, (b, 1 + 8 * (t - 1), 128, 128, 3)
                                    ).astype(np.float32)}
    else:
        out = {"latents": gen.standard_normal(
            (b, t, 16, 16, c)).astype(np.float32)}
    if text:
        out["text"] = [DEBUG_PROMPTS[(step * b + i) % len(DEBUG_PROMPTS)]
                       for i in range(b)]
        return out
    out.update({
        "text_emb": gen.standard_normal(
            (b, 8, cfg.joint_attention_dim)).astype(np.float32),
        "text_mask": np.ones((b, 8), bool),
        "pooled": gen.standard_normal(
            (b, cfg.pooled_projection_dim)).astype(np.float32),
    })
    return out


def device_batch(batch_np: dict, cfg, null, device) -> dict:
    """The train step's batch on ``device``, with the null text features
    (zeros unless ``--null_text_fea`` or the text encoders gave them)."""
    x = "video" if "video" in batch_np else "latents"
    b = batch_np[x].shape[0]
    lt = batch_np["text_emb"].shape[1] if "text_emb" in batch_np else 128
    batch = {
        x: batch_np[x],
        "text_emb": batch_np.get(
            "text_emb", np.zeros((b, lt, cfg.joint_attention_dim), np.float32)),
        "text_mask": batch_np.get("text_mask", np.ones((b, lt), bool)),
        "pooled": batch_np.get(
            "pooled", np.zeros((b, cfg.pooled_projection_dim), np.float32)),
    }
    if null is not None:
        batch["null_text_emb"] = np.broadcast_to(
            null["prompt_embed"][None], batch["text_emb"].shape)
        batch["null_pooled"] = np.broadcast_to(
            null["pooled_prompt_embed"][None], batch["pooled"].shape)
    else:
        batch["null_text_emb"] = np.zeros_like(batch["text_emb"])
        batch["null_pooled"] = np.zeros_like(batch["pooled"])
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in batch.items()}


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..parallel.mesh import maybe_initialize_distributed
    distributed = maybe_initialize_distributed(
        "cpu" if args.debug_tiny else "cuda")
    msg = outside_torchrun(args)
    if msg:
        sys.exit(msg)

    from ..models.flux.model import FluxConfig, PyramidFluxTransformer
    from ..models.mmdit.model import MMDiTConfig, PyramidDiffusionMMDiT
    from ..pipeline.noising import GeneratorDraws, sample_stage_length
    from ..schedulers.flow_matching import (
        PyramidFlowMatchEulerDiscreteScheduler)
    from ..training.lr_schedules import cosine_schedule
    from ..training.train_state import TrainConfig, create_train_state
    from ..training.trainer import encode_video, make_train_step
    from ..utils.checkpoint import (build_dit, build_vae,
                                    load_pretrained_components,
                                    require_components)

    mmdit = args.model_name == "pyramid_mmdit"
    if args.debug_tiny:
        # the kernels take head dims 64 and 128 in bf16: the fp32 model
        # runs the plain versions on the CPU
        device, compute_dtype = torch.device("cpu"), None
    else:
        if not torch.cuda.is_available():
            sys.exit("the full-size DiT trains on a CUDA device; none is "
                     "visible (use --debug_tiny on the CPU)")
        device, compute_dtype = torch.device("cuda"), torch.bfloat16
        if distributed:
            device = torch.device("cuda", torch.cuda.current_device())
    mesh, rank, rows = None, 0, slice(None)
    if distributed:
        import torch.distributed as dist

        from ..parallel.mesh import MeshConfig, data_rank, make_mesh
        world = dist.get_world_size()
        fsdp = args.fsdp or max(world // (args.dp * args.sp), 1)
        mesh = make_mesh(MeshConfig(dp=args.dp, fsdp=fsdp, sp=args.sp),
                         device.type)
        rank = dist.get_rank()
        index, count = data_rank(mesh)
        if args.batch_size % count:
            sys.exit(f"--batch_size {args.batch_size} does not split over "
                     f"the {count} data ranks (dp x fsdp)")
        per = args.batch_size // count
        rows = slice(index * per, (index + 1) * per)
        if rank == 0:
            print(f"mesh: dp={args.dp} fsdp={fsdp} sp={args.sp}",
                  file=sys.stderr)
    if (args.load_vae or args.load_text_encoder) and not args.model_path:
        sys.exit("--load_vae and --load_text_encoder need --model_path")
    comps = {}
    if args.model_path:
        comps = load_pretrained_components(
            args.model_path, args.model_variant, args.model_name,
            load_vae=args.load_vae,
            load_text_encoders=args.load_text_encoder)
        if "dit" not in comps:
            sys.exit(f"no DiT weights under {args.model_path}/"
                     f"{args.model_variant}: check --model_path and "
                     f"--model_variant")
        dit = build_dit(args.model_path, args.model_variant, args.model_name,
                        comps.pop("dit"), dtype=torch.float32, device=device,
                        remat=args.gradient_checkpointing, mesh=mesh,
                        bounded_softmax=not args.classic_softmax)
    else:
        if not args.debug_tiny:
            cfg = MMDiTConfig() if mmdit else FluxConfig()
        elif mmdit:
            cfg = MMDiTConfig(
                in_channels=16, num_layers=2, attention_head_dim=16,
                num_attention_heads=8, caption_projection_dim=128,
                pooled_projection_dim=32, joint_attention_dim=64)
        else:
            cfg = FluxConfig(
                in_channels=64, num_layers=2, num_single_layers=2,
                attention_head_dim=16, num_attention_heads=8,
                joint_attention_dim=64, pooled_projection_dim=32,
                axes_dims_rope=(8, 4, 4))
        torch.manual_seed(args.seed)
        dit_cls = PyramidDiffusionMMDiT if mmdit else PyramidFluxTransformer
        dit = dit_cls(cfg, device=device, remat=args.gradient_checkpointing,
                      mesh=mesh, bounded_softmax=not args.classic_softmax)
    cfg = dit.config
    if mesh is not None:
        from ..parallel.mesh import param_sharding
        stats = {}
        param_sharding(dit, mesh, min_shard_dim=args.fsdp_min_shard_dim,
                       stats_out=stats)
        if fsdp > 1 and stats["rule_fraction"] < 0.5 and rank == 0:
            print("WARNING: <50% of parameter bytes shard on JAX's rule "
                  "(the rest shard on dim 0); consider "
                  f"--fsdp_min_shard_dim below {args.fsdp_min_shard_dim}",
                  file=sys.stderr)
    # frozen encoders compute in the step's dtype
    frozen_dtype = compute_dtype or torch.float32
    vae = text_encoder = None
    if args.load_vae:
        require_components(comps, ["vae"], args.model_path)
        vae = build_vae(args.model_path, comps.pop("vae"),
                        dtype=frozen_dtype, device=device)
        vae.eval().requires_grad_(False)
    if args.load_text_encoder:
        from ..models.text.encoder import build_text_encoder
        text_encoder = build_text_encoder(comps, args.model_path,
                                          args.model_name, dtype=frozen_dtype,
                                          device=device)
    del comps
    sched = PyramidFlowMatchEulerDiscreteScheduler()

    lr = cosine_schedule(args.learning_rate, 1e-6, args.steps_per_epoch,
                         args.epochs, args.warmup_steps)
    state = create_train_state(dit, TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        max_grad_norm=args.clip_grad, lr_schedule=lr))
    start_step = 0
    if args.auto_resume:
        last = latest_checkpoint(args.output_dir)
        if last is not None:
            restore_checkpoint(last, state, device)
            start_step = state.step
            if rank == 0:
                print(f"resumed from step {start_step} ({last})",
                      file=sys.stderr)

    step_fn = make_train_step(
        dit, sched, tuple(args.sample_ratios), args.use_temporal_pyramid,
        args.frame_per_unit, args.corrupt_ratio, compute_dtype=compute_dtype,
        vae=vae, mesh=mesh)

    overshoot_probe = None
    if args.bound_probe_freq:
        from ..training.telemetry import (
            OVERSHOOT_WARN_LOG2, make_bound_overshoot_probe)
        overshoot_probe = make_bound_overshoot_probe(dit, sched)

    if args.anno_file:
        from ..data.datasets import LengthGroupedVideoTextDataset
        from ..data.loaders import create_length_grouped_video_text_dataloader
        ds = LengthGroupedVideoTextDataset(
            args.anno_file, args.max_frames,
            latent_channels=dit.latent_channels,
            load_text_fea=text_encoder is None)
        loader = create_length_grouped_video_text_dataloader(
            ds, args.batch_size, sync_group=args.video_sync_group)
        next_batch = lambda step: next(loader)  # noqa: E731
    elif args.debug_tiny:
        next_batch = lambda step: synthetic_batch(  # noqa: E731
            args, dit, step, pixels=vae is not None,
            text=text_encoder is not None)
    else:
        sys.exit("--anno_file is required unless --debug_tiny")

    from ..utils.metrics import MetricLogger
    null = np.load(args.null_text_fea) if args.null_text_fea else None
    if text_encoder is not None and null is None:
        null = null_features(text_encoder)
    logger = MetricLogger(  # rank 0 logs
        log_file=None if rank else os.path.join(args.output_dir, "log.txt"),
        tensorboard_dir=None if rank else args.tensorboard_dir,
        wandb_project=None if rank else args.wandb_project,
        wandb_config=vars(args),
        print_fn=(lambda m: None) if rank else
        (lambda m: print(m, file=sys.stderr)))
    draws = GeneratorDraws(torch.Generator(device).manual_seed(args.seed))

    step = start_step
    for epoch in range(start_step // args.steps_per_epoch, args.epochs):
        while step < (epoch + 1) * args.steps_per_epoch:
            batch_np = next_batch(step)
            if text_encoder is not None and "text_emb" not in batch_np:
                batch_np = fill_text_features(batch_np, text_encoder)
            batch = device_batch({k: v[rows] for k, v in batch_np.items()},
                                 cfg, null, device)
            frames = (batch["latents"].shape[1] if "latents" in batch
                      else 1 + (batch["video"].shape[1] - 1) // 8)
            max_units = 1 + (frames - 1) // args.frame_per_unit
            units = tuple(sample_stage_length(
                0, step, 3, args.max_temporal_length, args.frame_per_unit,
                args.video_sync_group, max_units))
            state, metrics = step_fn(state, batch, draws, units)
            loss_val = metrics["train/loss"]
            if not np.isfinite(loss_val):
                print(f"Loss is {loss_val}, stopping training",
                      file=sys.stderr)
                sys.exit(1)
            logger.update(step=step, **{k.split("/")[-1]: float(v)
                                        for k, v in metrics.items()})
            if overshoot_probe is not None and \
                    step % args.bound_probe_freq == 0:
                latents = batch.get("latents")
                if latents is None:
                    latents = encode_video(
                        vae, batch["video"],
                        draws.fold_in(-1 - step).split(2)[1], dit.model_name)
                with torch.autocast(device.type, dtype=compute_dtype,
                                    enabled=compute_dtype is not None):
                    over = overshoot_probe(
                        latents, batch["text_emb"],
                        batch["text_mask"], batch["pooled"],
                        draws.fold_in(-1 - step))
                if mesh is not None:  # a forward without grad leaves the
                    dit.reshard()     # root's parameters gathered
                logger.update(step=step, bound_overshoot_log2=over)
                if over > OVERSHOOT_WARN_LOG2 and dit.bounded_softmax:
                    logger.print_fn(
                        f"WARNING: bounded-softmax overshoot {over:.0f} log2 "
                        f"units (> {OVERSHOOT_WARN_LOG2:.0f}): qk-norm gains "
                        "are drifting out of the bounded attention's "
                        "exactness envelope; restart this run with "
                        "--classic_softmax (the classic online softmax is "
                        "exact at any gain)")
            if step % args.print_freq == 0:
                logger.print_fn(f"epoch {epoch} step {step}  {logger}")
            step += 1

        logger.write_epoch_log(epoch)
        if (epoch + 1) % args.save_ckpt_freq == 0:
            save_checkpoint(args.output_dir, step, state, rank)
            if rank == 0:
                print(f"saved checkpoint-{step} (+ema)", file=sys.stderr)
    if distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
