"""Batch VAE latent extraction: the offline preprocessing of DiT training.

    python -m pyramid_flow_tpu_torch.tools.extract_video_vae_latents \\
        --model_path CKPT --anno_file videos.jsonl --output_dir latents/ \\
        --output_anno latents.jsonl --rank 0 --world 1

The counterpart of the JAX package's ``tools/extract_video_vae_latents.py``,
with its flags, plus ``--device``. This process takes items
``[rank::world]`` of the ``--anno_file`` jsonl (``{"video": path, ...}``),
decodes and crops each clip with ``VideoFrameProcessor`` (cv2) to
``--num_frames`` frames of ``--height`` x ``--width``, encodes it with the
checkpoint's VAE (``chunk_encode`` in windows of ``--window_size`` frames,
or with ``--tile`` in spatial tiles of that many pixels, each windowed),
samples the posterior, and saves the unnormalised fp32 latent
``[T', H', W', C]`` as ``<output_dir>/latent_<rank>_<i:07d>.npy``, where
``i`` counts every item of the slice, skipped ones too (a clip that does
not decode is printed and skipped). The saves run on four threads. The
items written go to ``--output_anno`` with a ``latent`` field, which
``LengthGroupedVideoTextDataset`` reads.

The VAE computes in bf16 on the CUDA card (the default) and in fp32 with
``--device cpu``. The posterior draws come from one ``torch.Generator``
seeded with 0, in item order: they are not the JAX tool's, whose
``PRNGKey(0)`` splits torch cannot reproduce.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Union

import numpy as np
import torch

__all__ = ["main", "parse_args", "encode_clip"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--anno_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_anno", required=True)
    p.add_argument("--num_frames", type=int, default=121)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--window_size", type=int, default=16)
    p.add_argument("--tile", type=int, default=0,
                   help="spatial tile size (0 = no tiling)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


@torch.no_grad()
def encode_clip(vae, video: np.ndarray,
                noise: Union[torch.Generator, torch.Tensor],
                window_size: int = 16, tile: int = 0) -> np.ndarray:
    """One clip's latent: pixels [T, H, W, 3] in [-1, 1] -> the posterior
    sample (``noise``: its generator, or the standard-normal draw) as fp32
    [T', H', W', C], not normalised."""
    from ..models.vae import model as vae_model

    x = torch.as_tensor(video, dtype=torch.float32)[None]
    x = x.to(next(vae.parameters()).device)
    if tile:
        moments = vae_model.tiled_encode(vae, x, tile, temporal_chunk=True,
                                         window_size=window_size)
    else:
        moments = vae_model.chunk_encode(vae, x, window_size)
    return vae_model.gaussian_sample(moments, noise)[0].float().cpu().numpy()


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..data.datasets import VideoFrameProcessor, load_jsonl
    from ..utils.checkpoint import build_vae
    from ..utils.converters import load_state_dict

    device = torch.device(args.device)
    vae_dir = os.path.join(args.model_path, "causal_video_vae")
    if not os.path.isdir(vae_dir):
        sys.exit(f"no VAE weights under {vae_dir}")
    vae = build_vae(args.model_path, load_state_dict(vae_dir),
                    dtype=torch.bfloat16 if device.type == "cuda"
                    else torch.float32, device=device).eval()

    items = load_jsonl(args.anno_file)[args.rank::args.world]
    proc = VideoFrameProcessor(args.num_frames, (args.height, args.width))
    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device).manual_seed(0)
    rows, saves = [], []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for i, item in enumerate(items):
            try:
                video, _ = proc(item["video"])
            except Exception as e:  # an unreadable clip: skipped, as in JAX
                print(f"skip {item['video']}: {e}", file=sys.stderr)
                continue
            latent = encode_clip(vae, video, generator, args.window_size,
                                 args.tile)
            path = os.path.join(args.output_dir,
                                f"latent_{args.rank}_{i:07d}.npy")
            saves.append(pool.submit(np.save, path, latent))
            rows.append({**item, "latent": path})
            if i % 20 == 0:
                print(f"[{args.rank}] {i}/{len(items)} "
                      f"latent={latent.shape}", file=sys.stderr)
    for f in saves:
        f.result()
    with open(args.output_anno, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
