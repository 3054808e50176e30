"""Runs of the harness on the CPU at tiny widths, for the tests.

The cells' own workload files and limits, with the models cut to 2 + 4
(flux) or 8 (MMDiT) blocks of 8 x 64 heads, deep enough that the CFG rows
differ as at full size, and the request to 64 x 64 pixels, four units of
two steps per stage. ``dtype`` float32 makes the program's readings round-off
alone, so a fault stands out against any limit.
"""

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.cell import Bench, run  # noqa: E402

VAE = {"block_out_channels": [16, 16, 16, 16],
       "encoder_layers_per_block": [1, 1, 1, 1],
       "decoder_layers_per_block": [1, 1, 1, 1], "num_groups": 4}
CONFIGS = {
    "flux": {"family": "flux", "vae": VAE, "dit": {
        "in_channels": 64, "num_layers": 2, "num_single_layers": 4,
        "attention_head_dim": 64, "num_attention_heads": 8,
        "joint_attention_dim": 1024, "pooled_projection_dim": 512,
        "axes_dims_rope": [16, 24, 24], "patch_size": 2,
        "use_temporal_causal": True}},
    "mmdit": {"family": "mmdit", "vae": VAE, "dit": {
        "sample_size": 16, "patch_size": 2, "in_channels": 16,
        "num_layers": 8, "attention_head_dim": 64, "num_attention_heads": 8,
        "caption_projection_dim": 512, "pooled_projection_dim": 512,
        "joint_attention_dim": 1024, "pos_embed_max_size": 32,
        "use_temporal_causal": True}},
}
CELLS = {"flux": "flux-t2v-384p-5s", "mmdit": "sd3-t2v-384p-5s",
         "train": "flux-train-ar-384p"}
TRAFFIC = {
    "t2v_closed_loop": dict(temp=4, height=64, width=64, steps=[2, 2, 2],
                            video_steps=[2, 2, 2], text_len=8, text_valid=6,
                            dit_samples=3),
    "train_steps": dict(frames=4, height=64, width=64, text_len=8,
                        text_valid=6, warmup_steps=2)}


def tiny_spec(family: str, trace: bool = False, seconds: float = 1.0,
              dtype: str = "float32", seed: int = 2 ** 31 + 11,
              cell: str = ""):
    """The spec of a cell (by default the family's serving cell) cut to
    tiny widths, on the CPU."""
    bench = Bench(ROOT)
    cfg = dict(CONFIGS[family], dtype=dtype)
    spec = bench.spec(cell or CELLS[family], seed, seconds, trace, "cpu",
                      config=cfg)
    spec.traffic.update(TRAFFIC[spec.generator])
    return bench, spec


def tiny_run(family: str, trace: bool = False, seconds: float = 1.0,
             dtype: str = "float32", seed: int = 2 ** 31 + 11,
             cell: str = "") -> dict:
    """One run's result object at tiny size on the CPU."""
    bench, spec = tiny_spec(family, trace, seconds, dtype, seed, cell)
    torch.manual_seed(0)
    return run(bench, spec, time.perf_counter(), time.perf_counter)
