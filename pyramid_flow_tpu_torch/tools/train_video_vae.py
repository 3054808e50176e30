"""Causal video VAE training CLI of the port (GAN + LPIPS + KL).

    python -m pyramid_flow_tpu_torch.tools.train_video_vae \\
        --video_anno videos.jsonl --output_dir runs/vae

The flags are those of the JAX package's ``tools/train_video_vae.py``: raw
videos (``--video_anno``, a jsonl of ``{"video": path}``; ``--image_anno``
for the image role) through the port's ``VideoDataset``/``ImageDataset`` and
``create_mixed_dataloaders``, the loss weights, ``--disc_start``,
``--use_3d_disc``, ``--freeze_encoder``, ``--pretrained_vae`` (a
release-layout root holding ``causal_video_vae/``, read by the port's
``load_pretrained_components``) and ``--lpips_ckpt`` (the reference's
``vgg_lpips.pth``, loaded strict; without it LPIPS has random weights and a
warning says so). The release VAE trains on one CUDA device with fp32
parameters under bf16 autocast; ``--debug_tiny`` trains a tiny VAE and
discriminator in fp32 on the CPU (tests, smoke runs).

Context and data parallelism: under ``torchrun`` (one process per rank;
NCCL on CUDA, gloo for ``--debug_tiny``) ``--dp x --cp`` ranks form a
("dp", "cp") mesh; each rank trains on ``--num_frames / cp`` frames of its
dp slice of the ``--batch_size x dp`` clips, with every causal conv taking
the previous cp rank's last two frames (``parallel.cp``). As in JAX, under
``--cp > 1`` the clips are continuations (``is_init=False``) and need
``--num_frames % (8 cp) == 0``. Every rank reads the same clips and keeps
its shard; rank 0 logs and writes the checkpoints::

    torchrun --nproc_per_node 2 -m pyramid_flow_tpu_torch.tools.train_video_vae \
        --cp 2 --num_frames 32 --video_anno videos.jsonl ...

Checkpoints: ``<output_dir>/checkpoint-<step>.pt`` (step, the VAE, ``logvar``,
the discriminator and both optimizers), written with ``torch.save`` every
``--save_ckpt_freq`` epochs; ``--auto_resume`` continues from the newest, at
the epoch its step falls in. A non-finite loss stops the run (exit 1).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

from .train_pyramid_flow import latest_checkpoint

__all__ = ["main", "parse_args"]

# --debug_tiny: the JAX package's TINY_VAE geometry and a small
# discriminator (4 stride-2 layers would leave nothing of a 32x32 frame)
TINY_VAE = dict(latent_channels=2, block_out_channels=(4, 4, 8, 8),
                encoder_layers_per_block=(1, 1, 1, 1),
                decoder_layers_per_block=(1, 1, 1, 1), num_groups=2)
TINY_DISC = dict(ndf=8, n_layers=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video_anno", required=True)
    p.add_argument("--image_anno", default=None)
    p.add_argument("--image_mix_ratio", type=float, default=0.1)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps_per_epoch", type=int, default=2000)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lpips_ckpt", default=None, help="vgg_lpips.pth path")
    p.add_argument("--kl_weight", type=float, default=1e-12)
    p.add_argument("--pixel_weight", type=float, default=10.0)
    p.add_argument("--perceptual_weight", type=float, default=1.0)
    p.add_argument("--disc_weight", type=float, default=0.5)
    p.add_argument("--disc_start", type=int, default=250_000)
    p.add_argument("--use_3d_disc", action="store_true")
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel degree: shard the time axis over "
                        "this many ranks (needs --num_frames %% (8 cp) == 0; "
                        "continuation clips)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree; dp x cp ranks under torchrun")
    p.add_argument("--pretrained_vae", default=None,
                   help="release-layout root holding causal_video_vae/")
    p.add_argument("--output_dir", default="runs/vae")
    p.add_argument("--save_ckpt_freq", type=int, default=1, help="epochs")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_tiny", action="store_true",
                   help="a tiny VAE and discriminator in fp32 on the CPU "
                        "(CI/smoke testing)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..parallel.mesh import maybe_initialize_distributed
    distributed = maybe_initialize_distributed(
        "cpu" if args.debug_tiny else "cuda")
    if (args.cp > 1 or args.dp > 1) and not distributed:
        sys.exit("--cp/--dp > 1 run one process per rank: launch with "
                 "torchrun --nproc_per_node N")
    if args.cp > 1 and args.num_frames % (8 * args.cp):
        sys.exit(f"--cp {args.cp} needs --num_frames divisible by "
                 f"{8 * args.cp} (uniform continuation shards); got "
                 f"{args.num_frames}")

    from ..data.datasets import ImageDataset, VideoDataset
    from ..data.loaders import create_mixed_dataloaders
    from ..models.vae.discriminator import (
        PatchDiscriminator2D, PatchDiscriminator3D)
    from ..models.vae.lpips import LPIPS
    from ..models.vae.model import CausalVideoVAE, VAEConfig
    from ..pipeline.noising import GeneratorDraws
    from ..training.vae_trainer import (
        VAETrainConfig, create_vae_train_state, make_vae_train_step)
    from ..utils.checkpoint import build_vae, load_pretrained_components
    from ..utils.converters import load_state_dict
    from ..utils.metrics import MetricLogger

    if args.debug_tiny:
        device, compute_dtype = torch.device("cpu"), None
    else:
        if not torch.cuda.is_available():
            sys.exit("the release VAE trains on a CUDA device; none is "
                     "visible (use --debug_tiny on the CPU)")
        device, compute_dtype = torch.device("cuda"), torch.bfloat16
        if distributed:
            device = torch.device("cuda", torch.cuda.current_device())
    mesh, rank = None, 0
    if distributed:
        from ..parallel.cp import make_cp_mesh
        mesh = make_cp_mesh(args.dp, args.cp, device.type)
        rank = torch.distributed.get_rank()

    torch.manual_seed(args.seed)
    if args.pretrained_vae:
        comps = load_pretrained_components(args.pretrained_vae,
                                           load_text_encoders=False)
        if "vae" not in comps:
            sys.exit(f"no VAE weights under {args.pretrained_vae}/"
                     f"causal_video_vae")
        vae = build_vae(args.pretrained_vae, comps.pop("vae"),
                        dtype=torch.float32, device=device)
    else:
        vae = CausalVideoVAE(VAEConfig(**TINY_VAE) if args.debug_tiny
                             else VAEConfig(), device=device)
    lpips = LPIPS(device=device)
    if args.lpips_ckpt:
        lpips.load_state_dict(load_state_dict(args.lpips_ckpt), strict=True)
    else:
        print("WARNING: random LPIPS weights (pass --lpips_ckpt for real "
              "perceptual loss)", file=sys.stderr)
    disc_cls = PatchDiscriminator3D if args.use_3d_disc \
        else PatchDiscriminator2D
    disc = disc_cls(**(TINY_DISC if args.debug_tiny else {}), device=device)

    res = (args.resolution, args.resolution)
    video_ds = VideoDataset(args.video_anno, args.num_frames, res)
    image_ds = (ImageDataset(args.image_anno, 8, res)
                if args.image_anno else video_ds)
    # every rank reads the dp x batch_size clips and keeps its shard
    loader, role = create_mixed_dataloaders(
        video_ds, image_ds, args.batch_size * args.dp, rank=0, world=1,
        image_mix_ratio=args.image_mix_ratio if args.image_anno else 0.0,
        seed=args.seed)
    if rank == 0:
        print(f"rank 0 role: {role}", file=sys.stderr)
    shard = (slice(None), slice(None))
    if mesh is not None:
        d, c = mesh.get_coordinate()
        t = args.num_frames // args.cp
        shard = (slice(d * args.batch_size, (d + 1) * args.batch_size),
                 slice(c * t, (c + 1) * t))

    cfg = VAETrainConfig(
        learning_rate=args.learning_rate, kl_weight=args.kl_weight,
        pixel_weight=args.pixel_weight,
        perceptual_weight=args.perceptual_weight,
        disc_weight=args.disc_weight, disc_start=args.disc_start)
    state = create_vae_train_state(vae, disc, cfg)
    start_step = 0
    if args.auto_resume:
        last = latest_checkpoint(args.output_dir)
        if last is not None:
            state.load_state_dict(torch.load(last, map_location=device,
                                             weights_only=True))
            start_step = state.step
            if rank == 0:
                print(f"resumed from step {start_step}", file=sys.stderr)
    step_fn = make_vae_train_step(
        vae, lpips, disc, use_3d_disc=args.use_3d_disc,
        freeze_encoder=args.freeze_encoder, compute_dtype=compute_dtype,
        is_init=args.cp == 1, mesh=mesh)

    logger = MetricLogger(  # rank 0 logs
        log_file=None if rank else os.path.join(args.output_dir, "log.txt"),
        tensorboard_dir=None if rank else args.tensorboard_dir,
        wandb_project=None if rank else args.wandb_project,
        wandb_config=vars(args),
        print_fn=(lambda m: None) if rank else
        (lambda m: print(m, file=sys.stderr)))
    draws = GeneratorDraws(torch.Generator(device).manual_seed(args.seed))
    step = start_step
    try:
        for epoch in range(start_step // args.steps_per_epoch, args.epochs):
            while step < (epoch + 1) * args.steps_per_epoch:
                video = torch.as_tensor(next(loader)["video"][shard],
                                        device=device)
                metrics = step_fn(state, video, draws)
                loss_val = metrics["vae/total_loss"]
                if not math.isfinite(loss_val):
                    print(f"Loss is {loss_val}, stopping training",
                          file=sys.stderr)
                    sys.exit(1)
                logger.update(step=step, **{k.split("/")[-1]: v
                                            for k, v in metrics.items()})
                if step % args.print_freq == 0:
                    logger.print_fn(f"epoch {epoch} step {step}  {logger}")
                step += 1
            logger.write_epoch_log(epoch)
            if (epoch + 1) % args.save_ckpt_freq == 0 and rank == 0:
                os.makedirs(args.output_dir, exist_ok=True)
                torch.save(state.state_dict(), os.path.join(
                    args.output_dir, f"checkpoint-{step}.pt"))
                print(f"saved checkpoint-{step}", file=sys.stderr)
    finally:
        loader.close()
    if distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
