"""Batch text-feature extraction (T5 sequence + CLIP pooled) to .npz files.

    python -m pyramid_flow_tpu_torch.tools.extract_text_features \\
        --model_path CKPT --anno_file videos.jsonl --output_dir text_fea/ \\
        --output_anno videos_text.jsonl

The port of the JAX package's ``tools/extract_text_features.py``, with the
same flags (plus ``--device``) and the same files, so the port's datasets
and the JAX package's read what either writes: ``null_text.npz`` (the empty
prompt, the null features of the CFG drop) and one
``text_<rank>_<index>.npz`` per item, each holding ``prompt_embed``
(float32 [L, D]), ``prompt_attention_mask`` (bool [L]) and
``pooled_prompt_embed`` (float32 [P]); ``--output_anno`` is the annotation
with each item's ``text_fea`` path. The encoders compute in bf16 on the
CUDA device (the default) and in fp32 with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--model_name", default="pyramid_flux",
                   choices=["pyramid_flux", "pyramid_mmdit"])
    p.add_argument("--anno_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_anno", required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _save(path, emb, mask, pooled):
    np.savez(path, prompt_embed=emb.float().cpu().numpy(),
             prompt_attention_mask=mask.cpu().numpy(),
             pooled_prompt_embed=pooled.float().cpu().numpy())


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..data.datasets import load_jsonl
    from ..models.text.encoder import build_text_encoder
    from ..utils.checkpoint import load_text_components

    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    te = build_text_encoder(
        load_text_components(args.model_path, args.model_name),
        args.model_path, args.model_name, dtype=dtype, device=device)

    os.makedirs(args.output_dir, exist_ok=True)
    ne, nm, npl = te("")
    _save(os.path.join(args.output_dir, "null_text.npz"), ne[0], nm[0],
          npl[0])

    items = load_jsonl(args.anno_file)[args.rank::args.world]
    rows = []
    for start in range(0, len(items), args.batch_size):
        chunk = items[start:start + args.batch_size]
        emb, mask, pooled = te([it["text"] for it in chunk])
        for j, it in enumerate(chunk):
            path = os.path.join(args.output_dir,
                                f"text_{args.rank}_{start + j:07d}.npz")
            _save(path, emb[j], mask[j], pooled[j])
            rows.append({**it, "text_fea": path})
        print(f"[{args.rank}] {start + len(chunk)}/{len(items)}",
              file=sys.stderr)
    with open(args.output_anno, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
