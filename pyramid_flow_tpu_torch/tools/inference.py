"""Text- and image-to-video inference CLI of the port.

    python -m pyramid_flow_tpu_torch.tools.inference \\
        --model_path CKPT --variant diffusion_transformer_384p \\
        --prompt "a hiker on a ridge" --temp 16 --height 384 --width 640 \\
        --output out/

The flags are those of the JAX package's ``tools/inference.py``, plus
``--device`` and ``--classic_softmax``, which puts every DiT attention on
the classic online softmax (K2) instead of the bounded one: the
counterpart of running JAX's CLI under ``PF_BOUNDED_SOFTMAX=0``. The frames
go to ``--output`` as PNG files and ``video.mp4`` at ``--fps``
(``utils.video_io``; without imageio's ffmpeg plugin the PNG files alone,
said on stderr).
``PyramidFlowRunner.from_pretrained`` loads the released layout under
``--model_path`` (the DiT of ``--variant``, the VAE, the text encoders and
their tokenizers); ``--input_image`` makes the request image-to-video. The
DiT is dropped before the VAE decodes, as in JAX's CLI. On the CUDA device
(the default) the models compute in bf16; ``--device cpu`` computes in fp32
(tiny checkpoints, tests).

``--sp N`` serves one request sequence-parallel under ``torchrun`` (one
process per rank; NCCL on CUDA, gloo with ``--device cpu``): the world of
``N x fsdp`` ranks is a (1, fsdp, N) mesh, as JAX's CLI builds it, every
rank runs the request on the same draws with the DiT's tokens sharded over
its sp group, and rank 0 writes the frames::

    torchrun --nproc_per_node 2 -m pyramid_flow_tpu_torch.tools.inference \
        --model_path CKPT --variant diffusion_transformer_384p --sp 2 ...
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    from ..pipeline.runner import DEFAULT_NEGATIVE_PROMPT

    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="released checkpoint root (HF snapshot layout)")
    p.add_argument("--variant", default="diffusion_transformer_768p")
    p.add_argument("--model_name", default="pyramid_flux",
                   choices=["pyramid_flux", "pyramid_mmdit"])
    p.add_argument("--prompt", default="")
    p.add_argument("--negative_prompt", default=DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--input_image", default=None, help="i2v input image path")
    p.add_argument("--temp", type=int, default=16,
                   help="latent temporal units; frames = (temp-1)*8+1")
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--num_inference_steps", type=int, default=20)
    p.add_argument("--video_num_inference_steps", type=int, default=10)
    p.add_argument("--guidance_scale", type=float, default=9.0)
    p.add_argument("--video_guidance_scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel ways")
    p.add_argument("--save_memory", action="store_true",
                   help="plan the decode for this device's memory "
                        "(pipeline.decode_settings)")
    p.add_argument("--classic_softmax", action="store_true",
                   help="every DiT attention on the classic online softmax "
                        "(exact at any qk-norm gain) instead of the bounded "
                        "one")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--output", default="output")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..parallel.mesh import (MeshConfig, make_mesh,
                                 maybe_initialize_distributed)
    from ..pipeline.runner import PyramidFlowRunner
    from ..utils.video_io import save_frames

    device = torch.device(args.device)
    mesh, rank = None, 0
    if args.sp > 1:
        import torch.distributed as dist

        if not maybe_initialize_distributed(device.type):
            sys.exit("--sp > 1 runs one process per rank: launch it with "
                     "torchrun --nproc_per_node N")
        n = dist.get_world_size()
        if n % args.sp:
            sys.exit(f"--sp {args.sp} does not divide the {n} ranks")
        mesh = make_mesh(MeshConfig(dp=1, fsdp=n // args.sp, sp=args.sp),
                         device.type)
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    print(f"loading checkpoints from {args.model_path} ...", file=sys.stderr)
    runner = PyramidFlowRunner.from_pretrained(
        args.model_path, args.variant, args.model_name, dtype=dtype,
        device=device, mesh=mesh, bounded_softmax=not args.classic_softmax)
    common = dict(
        negative_prompt=args.negative_prompt, seed=args.seed,
        height=args.height, width=args.width, temp=args.temp,
        num_inference_steps=args.num_inference_steps,
        video_num_inference_steps=args.video_num_inference_steps,
        guidance_scale=args.guidance_scale,
        video_guidance_scale=args.video_guidance_scale,
        output_type="pixels", release_dit_before_decode=True,
        save_memory=args.save_memory)
    t0 = time.perf_counter()
    if args.input_image:
        from PIL import Image
        image = np.asarray(Image.open(args.input_image).convert("RGB"))
        frames = runner.generate_i2v(args.prompt, image, **common)
    else:
        frames = runner.generate(args.prompt, **common)
    frames = frames[0].cpu().numpy()
    print(f"generated {frames.shape[0]} frames in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if rank:
        return 0
    save_frames(frames, args.output, args.fps)
    print(f"wrote {frames.shape[0]} PNG frames to {args.output}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
