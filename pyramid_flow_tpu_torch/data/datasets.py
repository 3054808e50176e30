"""Datasets (host-side, numpy out, channels-last).

The port's copy of the JAX package's numpy-only ``data/datasets.py`` (the
port imports nothing of that package). ``cv2`` and ``PIL`` are imported by
the functions that decode videos and images, so the latent datasets need
neither. Re-design of `dataset/dataset_cls.py`: every
dataset yields numpy arrays in [T, H, W, C] / [H, W, C] layout ready for
device feeding. Error handling matches the reference: any per-item failure
resamples a random index (:122-124 etc.) so a bad file never kills training.

* :class:`ImageTextDataset` — jsonl {image, text}; nearest aspect-ratio
  bucket, resize + random crop, normalize to [-1, 1] (:24-124)
* :class:`LengthGroupedVideoTextDataset` — jsonl {video, text, latent,
  text_fea}; loads pre-extracted VAE latents (+ optional text features),
  truncates to max_frames (:127-208)
* :class:`VideoDataset` — raw video clips for VAE training: fps resample,
  loop-pad, random temporal crop, resize + center crop (:211-316)
* :class:`ImageDataset` — packs images into a pseudo-video (:319-377)
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ImageTextDataset",
    "LengthGroupedVideoTextDataset",
    "VideoDataset",
    "ImageDataset",
    "load_jsonl",
]


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _to_float(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> float32 [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def _resize_keep_ratio_then_crop(img, size: Tuple[int, int],
                                 random_crop: bool, rng: random.Random):
    """Resize a ``PIL.Image`` so the short side covers, then (random|center)
    crop to size. size = (height, width)."""
    from PIL import Image

    th, tw = size
    w, h = img.size
    scale = max(th / h, tw / w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    img = img.resize((nw, nh), Image.BICUBIC)
    if random_crop:
        left = rng.randint(0, max(nw - tw, 0))
        top = rng.randint(0, max(nh - th, 0))
    else:
        left = (nw - tw) // 2
        top = (nh - th) // 2
    return img.crop((left, top, left + tw, top + th))


class _ResampleOnError:
    """Shared __getitem__ wrapper: failures resample a random index."""

    def __getitem__(self, idx):
        for _ in range(16):
            try:
                return self.get(idx)
            except Exception:
                idx = random.randint(0, len(self) - 1)
        raise RuntimeError("too many failed samples")


class ImageTextDataset(_ResampleOnError):
    """Multi-aspect image-text dataset with ratio buckets.

    anno_file: jsonl of {image, text}. ``ratios``/``sizes`` pair aspect
    ratios with (height, width) targets (reference :24-60).
    """

    def __init__(self, anno_file: str | Sequence[str],
                 add_normalize: bool = True,
                 ratios: Sequence[float] = (1 / 1, 3 / 5, 5 / 3),
                 sizes: Sequence[Tuple[int, int]] = ((1024, 1024), (768, 1280), (1280, 768)),
                 crop_mode: str = "random", p_random_ratio: float = 0.0,
                 seed: int = 0):
        files = [anno_file] if isinstance(anno_file, str) else list(anno_file)
        self.items = []
        for f in files:
            self.items.extend(load_jsonl(f))
        self.ratios = list(ratios)
        self.sizes = list(sizes)
        self.add_normalize = add_normalize
        self.crop_mode = crop_mode
        self.p_random_ratio = p_random_ratio
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def bucket_for(self, width: int, height: int) -> int:
        if self.p_random_ratio > 0 and self.rng.random() < self.p_random_ratio:
            return self.rng.randrange(len(self.ratios))
        ratio = height / width
        return int(np.argmin([abs(ratio - r) for r in self.ratios]))

    def get(self, idx):
        from PIL import Image

        item = self.items[idx]
        img = Image.open(item["image"]).convert("RGB")
        b = self.bucket_for(*img.size)
        img = _resize_keep_ratio_then_crop(
            img, self.sizes[b], self.crop_mode == "random", self.rng)
        arr = np.asarray(img)
        if self.add_normalize:
            arr = _to_float(arr)
        return {"image": arr, "text": item["text"], "identifier": "image",
                "bucket": b}


class LengthGroupedVideoTextDataset(_ResampleOnError):
    """Pre-extracted latent (+ text feature) dataset for DiT training.

    jsonl fields: ``latent`` (.npy/.npz/.pt with [C, T, H, W] or
    [T, H, W, C]), optional ``text_fea`` (.pt dict with prompt_embed /
    prompt_attention_mask / pooled_prompt_embed), ``text``. Latents are
    returned channels-last [T, H, W, C] and truncated to ``max_frames``
    (reference :127-208; channel/resolution asserts :174-186).
    """

    def __init__(self, anno_file: str | Sequence[str], max_frames: int = 16,
                 latent_channels: int = 16, load_text_fea: bool = True):
        files = [anno_file] if isinstance(anno_file, str) else list(anno_file)
        self.items = []
        for f in files:
            self.items.extend(load_jsonl(f))
        self.max_frames = max_frames
        self.latent_channels = latent_channels
        self.load_text_fea = load_text_fea

    def __len__(self):
        return len(self.items)

    @staticmethod
    def _load_array(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path)
        if path.endswith(".npz"):
            return np.load(path)["latent"]
        import torch
        t = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(t, dict):
            t = t.get("latent", next(iter(t.values())))
        return t.float().numpy()

    def get(self, idx):
        item = self.items[idx]
        latent = self._load_array(item["latent"])
        if latent.ndim == 4 and latent.shape[0] == self.latent_channels:
            latent = latent.transpose(1, 2, 3, 0)  # [C,T,H,W] -> [T,H,W,C]
        assert latent.shape[-1] == self.latent_channels, latent.shape
        latent = latent[: self.max_frames]

        out = {"latent": latent.astype(np.float32), "identifier": "video",
               "temporal_length": latent.shape[0]}
        if self.load_text_fea and "text_fea" in item:
            path = item["text_fea"]
            if path.endswith(".npz"):
                fea = dict(np.load(path))
                to_np = lambda v: np.asarray(v)
            else:  # reference .pt layout
                import torch
                fea = torch.load(path, map_location="cpu", weights_only=True)
                to_np = lambda v: v.float().numpy() if v.is_floating_point() else v.numpy()
            out["prompt_embed"] = to_np(fea["prompt_embed"]).astype(np.float32)
            out["prompt_attention_mask"] = np.asarray(
                to_np(fea["prompt_attention_mask"])).astype(bool)
            out["pooled_prompt_embed"] = to_np(
                fea["pooled_prompt_embed"]).astype(np.float32)
        else:
            out["text"] = item.get("text", "")
        return out


class VideoFrameProcessor:
    """cv2 decode -> fps resample -> loop-pad -> random temporal crop ->
    resize + center crop (reference :211-268)."""

    def __init__(self, num_frames: int = 17, sizes: Tuple[int, int] = (256, 256),
                 sample_fps: int = 24, seed: int = 0):
        self.num_frames = num_frames
        self.sizes = sizes
        self.sample_fps = sample_fps
        self.rng = random.Random(seed)

    def __call__(self, video_path: str) -> Tuple[np.ndarray, int]:
        import cv2

        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or self.sample_fps
        interval = max(int(round(fps / self.sample_fps)), 1)
        frames = []
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i % interval == 0:
                frames.append(frame[:, :, ::-1])  # BGR -> RGB
            i += 1
        cap.release()
        if not frames:
            raise ValueError(f"no frames in {video_path}")

        while len(frames) < self.num_frames:  # pad by looping
            frames = frames + frames[: self.num_frames - len(frames)]
        start = self.rng.randint(0, len(frames) - self.num_frames)
        frames = frames[start: start + self.num_frames]

        th, tw = self.sizes
        out = []
        for f in frames:
            h, w = f.shape[:2]
            scale = max(th / h, tw / w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            f = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_AREA)
            top, left = (nh - th) // 2, (nw - tw) // 2
            out.append(f[top: top + th, left: left + tw])
        video = _to_float(np.stack(out))
        return video, self.num_frames


class VideoDataset(_ResampleOnError):
    """Raw pixel videos for VAE training (reference :211-316)."""

    def __init__(self, anno_file: str | Sequence[str], num_frames: int = 17,
                 resolution: Tuple[int, int] = (256, 256), sample_fps: int = 24):
        files = [anno_file] if isinstance(anno_file, str) else list(anno_file)
        self.items = []
        for f in files:
            self.items.extend(load_jsonl(f))
        self.processor = VideoFrameProcessor(num_frames, resolution, sample_fps)

    def __len__(self):
        return len(self.items)

    def get(self, idx):
        item = self.items[idx]
        video, _ = self.processor(item["video"])
        return {"video": video, "identifier": "video"}


class ImageDataset(_ResampleOnError):
    """Packs ``max_frames`` images into one pseudo-video tensor per item
    (VAE image branch, reference :319-377)."""

    def __init__(self, anno_file: str | Sequence[str], max_frames: int = 8,
                 resolution: Tuple[int, int] = (256, 256), seed: int = 0):
        files = [anno_file] if isinstance(anno_file, str) else list(anno_file)
        self.items = []
        for f in files:
            self.items.extend(load_jsonl(f))
        self.max_frames = max_frames
        self.resolution = resolution
        self.rng = random.Random(seed)

    def __len__(self):
        return max(len(self.items) // self.max_frames, 1)

    def get(self, idx):
        from PIL import Image

        frames = []
        for k in range(self.max_frames):
            item = self.items[(idx * self.max_frames + k) % len(self.items)]
            img = Image.open(item["image"]).convert("RGB")
            img = _resize_keep_ratio_then_crop(
                img, self.resolution, True, self.rng)
            frames.append(_to_float(np.asarray(img)))
        return {"video": np.stack(frames), "identifier": "image"}
