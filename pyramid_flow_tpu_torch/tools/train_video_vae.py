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
discriminator in fp32 on the CPU (tests, smoke runs). Context and data
parallelism (``--cp/--dp > 1``) exit with a message naming ROADMAP A11.

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

from .train_pyramid_flow import latest_checkpoint_step

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
                   help="context-parallel degree (not ported: ROADMAP A11)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree (not ported: ROADMAP A11)")
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
    if args.cp > 1 or args.dp > 1:
        sys.exit("--cp/--dp > 1: the port trains the VAE on one device; "
                 "context and data parallelism are not ported yet (ROADMAP "
                 "A11)")

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
    loader, role = create_mixed_dataloaders(
        video_ds, image_ds, args.batch_size, rank=0, world=1,
        image_mix_ratio=args.image_mix_ratio if args.image_anno else 0.0,
        seed=args.seed)
    print(f"rank 0 role: {role}", file=sys.stderr)

    cfg = VAETrainConfig(
        learning_rate=args.learning_rate, kl_weight=args.kl_weight,
        pixel_weight=args.pixel_weight,
        perceptual_weight=args.perceptual_weight,
        disc_weight=args.disc_weight, disc_start=args.disc_start)
    state = create_vae_train_state(vae, disc, cfg)
    start_step = 0
    if args.auto_resume:
        last = latest_checkpoint_step(args.output_dir)
        if last is not None:
            state.load_state_dict(torch.load(
                os.path.join(args.output_dir, f"checkpoint-{last}.pt"),
                map_location=device, weights_only=True))
            start_step = state.step
            print(f"resumed from step {start_step}", file=sys.stderr)
    step_fn = make_vae_train_step(
        vae, lpips, disc, use_3d_disc=args.use_3d_disc,
        freeze_encoder=args.freeze_encoder, compute_dtype=compute_dtype)

    logger = MetricLogger(
        log_file=os.path.join(args.output_dir, "log.txt"),
        tensorboard_dir=args.tensorboard_dir,
        wandb_project=args.wandb_project, wandb_config=vars(args),
        print_fn=lambda m: print(m, file=sys.stderr))
    draws = GeneratorDraws(torch.Generator(device).manual_seed(args.seed))
    step = start_step
    try:
        for epoch in range(start_step // args.steps_per_epoch, args.epochs):
            while step < (epoch + 1) * args.steps_per_epoch:
                video = torch.as_tensor(next(loader)["video"], device=device)
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
            if (epoch + 1) % args.save_ckpt_freq == 0:
                os.makedirs(args.output_dir, exist_ok=True)
                torch.save(state.state_dict(), os.path.join(
                    args.output_dir, f"checkpoint-{step}.pt"))
                print(f"saved checkpoint-{step}", file=sys.stderr)
    finally:
        loader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
