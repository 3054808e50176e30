"""High-level runner: string prompts (and an image) in, frames out.

Bundles a text encoder with :class:`~.pyramid_pipeline.PyramidFlowPipeline`
so that callers pass raw prompts, with the reference's quality suffix and
default negative prompt. The text encoder is any callable that maps a list
of prompts to ``(embeddings, mask, pooled)``; ``from_pretrained`` builds
the pipeline and the checkpoint's own encoders (``models/text``) from a
released checkpoint directory.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from .pyramid_pipeline import PyramidFlowPipeline

__all__ = ["PyramidFlowRunner", "DEFAULT_NEGATIVE_PROMPT", "PROMPT_SUFFIX"]

PROMPT_SUFFIX = ", hyper quality, Ultra HD, 8K"
DEFAULT_NEGATIVE_PROMPT = (
    "cartoon style, worst quality, low quality, blurry, absolute black, "
    "absolute white, low res, extra limbs, extra digits, misplaced objects, "
    "mutated anatomy, monochrome, horror")


def _resize_crop(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Aspect-preserving cover resize (bilinear) and centre crop of a
    [H, W, 3] uint8 image to (th, tw), the reference app's
    ``resize_crop_image``."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = max(tw / w, th / h)
    rw, rh = round(w * scale), round(h * scale)
    im = Image.fromarray(img).resize((rw, rh), Image.BILINEAR)
    left, top = (rw - tw) // 2, (rh - th) // 2
    return np.asarray(im.crop((left, top, left + tw, top + th)))


class PyramidFlowRunner:
    """A pipeline and a text encoder behind a string-prompt API."""

    def __init__(self, pipeline: PyramidFlowPipeline, text_encoder):
        self.pipeline = pipeline
        self.text_encoder = text_encoder

    @classmethod
    def from_pretrained(cls, model_path: str,
                        model_variant: str = "diffusion_transformer_768p",
                        model_name: str = "pyramid_flux",
                        dtype: torch.dtype = torch.bfloat16, device="cuda",
                        **kwargs):
        """Pipeline and text encoders from a released checkpoint directory,
        each file read once: ``PyramidFlowPipeline.from_pretrained`` (its
        kwargs too) and ``FluxTextEncoder`` (CLIP-L + T5) or
        ``SD3TextEncoder`` (CLIP-L + CLIP-G + T5), with the checkpoint's
        tokenizers. A ``mesh`` kwarg makes the DiT sequence-parallel (every
        sp rank returns the whole frames), ``bounded_softmax=False``
        puts its attention on the classic online softmax, and the
        pyramid's ``scheduler`` and ``frame_per_unit`` reach the
        pipeline's constructor."""
        from ..models.text.encoder import build_text_encoder
        from ..utils.checkpoint import load_pretrained_components

        comps = load_pretrained_components(
            model_path, model_variant, model_name,
            load_vae=kwargs.get("load_vae", True))
        te = build_text_encoder(comps, model_path, model_name, dtype=dtype,
                                device=device)
        pipe = PyramidFlowPipeline.from_pretrained(
            model_path, model_variant, model_name, dtype=dtype,
            device=device, components=comps, **kwargs)
        return cls(pipe, te)

    def _encode_prompts(self, prompt, negative_prompt):
        if isinstance(prompt, str):
            prompt = [prompt]
        prompt = [p + PROMPT_SUFFIX for p in prompt]
        pos = self.text_encoder(prompt)
        neg = negative_prompt if negative_prompt is not None else ""
        if isinstance(neg, str):
            neg = [neg] * len(prompt)
        return pos, self.text_encoder(neg)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.pipeline.device).manual_seed(seed)

    def generate(self, prompt: Union[str, List[str]],
                 negative_prompt: Optional[str] = DEFAULT_NEGATIVE_PROMPT,
                 seed: int = 0, **kwargs):
        """Text-to-video; kwargs go to ``PyramidFlowPipeline.generate``
        (height, width, temp, steps, guidance, ``noise``...)."""
        pos, neg = self._encode_prompts(prompt, negative_prompt)
        return self.pipeline.generate(self._generator(seed), *pos, *neg,
                                      **kwargs)

    def generate_i2v(self, prompt: Union[str, List[str]], input_image,
                     negative_prompt: Optional[str] = DEFAULT_NEGATIVE_PROMPT,
                     seed: int = 0, **kwargs):
        """Image-to-video. ``input_image``: a PIL image or [H, W, 3] uint8.

        Without ``height``/``width`` the video takes the image's size; with
        them the image is first cover-resized and centre-cropped to it. The
        image is encoded in one 17-frame window (it has one frame) and its
        posterior sampled from the seed's generator, which then draws the
        pipeline's noise too."""
        from ..models.vae.model import chunk_encode, gaussian_sample

        pos, neg = self._encode_prompts(prompt, negative_prompt)
        img = np.asarray(input_image)
        if "height" in kwargs or "width" in kwargs:
            th, tw = kwargs.get("height"), kwargs.get("width")
            if th is None or tw is None:
                raise ValueError("pass both height and width (or neither)")
            if img.shape[:2] != (th, tw):
                img = _resize_crop(img, th, tw)
        else:
            kwargs["height"], kwargs["width"] = img.shape[0], img.shape[1]
        px = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None, None]
        moments = chunk_encode(self.pipeline.vae, px.to(self.pipeline.device),
                               window_size=16)
        generator = self._generator(seed)
        latent = gaussian_sample(moments, generator)
        return self.pipeline.generate_i2v(generator, latent, *pos, *neg,
                                          **kwargs)
