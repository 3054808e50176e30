"""Writing generated frames: PNG files plus an mp4, or an in-memory clip.

The JAX package's inference CLI and serving app each write their frames
through ``imageio`` (``tools/inference.py``, ``tools/serve.py``); the port
shares one writer between its two tools. When ``imageio`` or its ffmpeg
plugin is missing the mp4 is skipped: the CLI keeps the PNG frames and says
so on stderr, the serving app answers with the frame stack as
``application/x-npz`` (``frames``: uint8 [F, H, W, 3]).
"""

from __future__ import annotations

import io
import os
import sys
from typing import Optional, Tuple

import numpy as np

__all__ = ["save_frames", "video_bytes", "frames_from_bytes", "MP4", "NPZ"]

MP4, NPZ = "video/mp4", "application/x-npz"


def save_frames(frames: np.ndarray, output: str,
                fps: int = 24) -> Optional[str]:
    """uint8 frames [F, H, W, 3] -> ``<output>/frame_0000.png``, ... and
    ``<output>/video.mp4`` at ``fps``. Returns the mp4's path, or None when
    it could not be written (the reason goes to stderr)."""
    from PIL import Image

    os.makedirs(output, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(output, f"frame_{i:04d}.png"))
    path = os.path.join(output, "video.mp4")
    try:
        import imageio
        imageio.mimwrite(path, list(frames), fps=fps)
    except Exception as e:  # no imageio, or no ffmpeg plugin
        print(f"(mp4 export unavailable: {e}; PNG frames written)",
              file=sys.stderr)
        return None
    print(f"wrote {path}", file=sys.stderr)
    return path


def video_bytes(frames: np.ndarray, fps: int = 24) -> Tuple[bytes, str]:
    """uint8 frames [F, H, W, 3] -> (mp4 bytes, ``MP4``), or the frame
    stack as a compressed npz (``NPZ``) when the mp4 cannot be written."""
    buf = io.BytesIO()
    try:
        import imageio
        imageio.mimwrite(buf, list(frames), format="mp4", fps=fps)
        return buf.getvalue(), MP4
    except Exception:  # no imageio, or no ffmpeg plugin
        buf = io.BytesIO()
        np.savez_compressed(buf, frames=frames)
        return buf.getvalue(), NPZ


def frames_from_bytes(body: bytes, ctype: str) -> np.ndarray:
    """The uint8 frames [F, H, W, 3] of a :func:`video_bytes` body (an mp4
    decodes through ``imageio``, lossy)."""
    if ctype == NPZ:
        return np.load(io.BytesIO(body))["frames"]
    import imageio
    return np.stack(imageio.mimread(io.BytesIO(body), format="mp4"))
