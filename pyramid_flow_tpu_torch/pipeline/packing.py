"""Token packing for the pyramid DiT: patchify, RoPE positions and time ids.

Each (sample, stage) is one batch row of ``[cond history clips ..., current
clip]`` tokens with explicit metadata arrays:

* patch order ``b t (h p1) (w p2) c -> b (t h w) (p1 p2 c)``;
* the temporal RoPE axis offset by each clip's start frame;
* spatial positions of lower-res clips linearly interpolated from the
  current clip's grid, so all clips share one coordinate frame;
* time ids: the latent frame index (0-based); text is handled by the model.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.resample import interp_linear_1d_grid

__all__ = ["patchify", "unpatchify", "clip_positions", "clip_metadata",
           "pack_clips"]


def patchify(x: torch.Tensor, patch: int = 2) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T*(H/p)*(W/p), p*p*C], (p1, p2, c) order."""
    b, t, h, w, c = x.shape
    p = patch
    x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, temp: int, height: int, width: int,
               patch: int = 2) -> torch.Tensor:
    """Inverse of :func:`patchify`; height/width are the latent sizes."""
    b = tokens.shape[0]
    p = patch
    hh, ww = height // p, width // p
    c = tokens.shape[-1] // (p * p)
    x = tokens.reshape(b, temp, hh, ww, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, temp, height, width, c)


def clip_positions(temp: int, height: int, width: int, train_height: int,
                   train_width: int, start_time: int) -> np.ndarray:
    """RoPE (t, h, w) positions of one clip's tokens, [temp*h*w, 3] float32.
    ``height/width`` are in patch units; ``train_*`` is the current clip's
    patch grid, which lower-res clips interpolate."""
    h_pos = interp_linear_1d_grid(train_height, height)
    w_pos = interp_linear_1d_grid(train_width, width)
    t_pos = np.arange(start_time, start_time + temp, dtype=np.float32)
    grid = np.zeros((temp, height, width, 3), np.float32)
    grid[..., 0] = t_pos[:, None, None]
    grid[..., 1] = h_pos[None, :, None]
    grid[..., 2] = w_pos[None, None, :]
    return grid.reshape(-1, 3)


def clip_metadata(shapes: Sequence[Tuple[int, ...]], patch: int = 2
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(positions, time_ids, trainable) from clip shapes
    ``[(B, T, H, W, C), ...]``, the last being the current clip."""
    train_h = shapes[-1][2] // patch
    train_w = shapes[-1][3] // patch
    pos_list, time_list = [], []
    start_t = 0
    for (_, t, h, w, _) in shapes:
        hp, wp = h // patch, w // patch
        pos_list.append(clip_positions(t, hp, wp, train_h, train_w, start_t))
        time_list.append(np.repeat(
            np.arange(start_t, start_t + t, dtype=np.int32), hp * wp))
        start_t += t
    _, t, h, w, _ = shapes[-1]
    trainable = t * (h // patch) * (w // patch)
    return (np.concatenate(pos_list, axis=0),
            np.concatenate(time_list, axis=0), trainable)


def pack_clips(clips: Sequence[torch.Tensor], patch: int = 2
               ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, int]:
    """Pack a ``[history ..., current]`` clip list into one token sequence.

    clips: ``[B, T_i, H_i, W_i, C]`` each; the last defines the grid that the
    lower-res clips' positions interpolate. Returns ``tokens [B, L, p*p*C]``,
    ``positions [L, 3]`` float32 and ``time_ids [L]`` int32 (numpy, for the
    caller to broadcast over the batch), and the last clip's token count,
    the only trainable span."""
    positions, time_ids, trainable = clip_metadata(
        [tuple(c.shape) for c in clips], patch)
    tokens = torch.cat([patchify(c, patch) for c in clips], dim=1)
    return tokens, positions, time_ids, trainable
