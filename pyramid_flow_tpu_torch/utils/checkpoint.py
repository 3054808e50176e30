"""Loading the released checkpoints.

The released layout (one directory per component, as the JAX package's
``utils/checkpoint.py`` reads it)::

    <model_path>/<model_variant>/    DiT (miniFLUX or SD3 MMDiT)
    <model_path>/causal_video_vae/   VAE
    <model_path>/text_encoder/       CLIP-L
    <model_path>/text_encoder_2/     T5 (flux) or CLIP-G (mmdit)
    <model_path>/text_encoder_3/     T5 (mmdit)

each with its weights (safetensors or torch files) and a ``config.json``.
The port's modules are keyed like these files, so every component is a
state dict that its module takes with ``load_state_dict(strict=True)``;
:func:`build_dit` and :func:`build_vae` build the DiT and the VAE from
theirs, ``models.text.encoder.build_text_encoder`` the text encoders.

A training run's inference weights (the EMA of the DiT's parameters and its
persistent buffers) go to ``<output_dir>/checkpoint-<step>-ema.pt``
(:func:`export_ema_params`), which :func:`load_ema_params` reads back, the
counterparts of the JAX package's Orbax EMA export.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Sequence

import torch

from .converters import load_state_dict

__all__ = ["load_pretrained_components", "load_text_components",
           "load_model_config", "require_components", "build_dit",
           "build_vae", "export_ema_params", "load_ema_params",
           "IGNORED_KEYS"]

# keys the released files may carry that no module of the port holds, and
# that the JAX package's converters ignore too: the position-id buffer that
# older CLIP files store
IGNORED_KEYS = ("text_model.embeddings.position_ids",)
# HF ties T5's input embedding to ``shared``; a file may hold either name or
# both. The JAX converter reads ``shared.weight`` and, without it,
# ``encoder.embed_tokens.weight``.
_T5_TIED = "encoder.embed_tokens.weight"


def _text_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    sd = {k: v for k, v in sd.items() if k not in IGNORED_KEYS}
    if _T5_TIED in sd:
        tied = sd.pop(_T5_TIED)
        sd.setdefault("shared.weight", tied)
    return sd


def load_pretrained_components(model_path: str,
                               model_variant: str = "diffusion_transformer_768p",
                               model_name: str = "pyramid_flux",
                               load_vae: bool = True,
                               load_text_encoders: bool = True
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts (CPU tensors in their stored dtypes) of the components
    found under ``model_path``: ``dit``, ``vae`` and, for flux, ``clip`` and
    ``t5``; for the MMDiT ``clip``, ``clip_g`` and ``t5``."""
    out = {}
    dit_dir = os.path.join(model_path, model_variant)
    if os.path.isdir(dit_dir):
        out["dit"] = load_state_dict(dit_dir)
    vae_dir = os.path.join(model_path, "causal_video_vae")
    if load_vae and os.path.isdir(vae_dir):
        out["vae"] = load_state_dict(vae_dir)
    if load_text_encoders:
        out.update(load_text_components(model_path, model_name))
    return out


def load_text_components(model_path: str, model_name: str = "pyramid_flux"
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The text encoders' state dicts found under ``model_path``: ``clip``
    (``text_encoder/``), then ``t5`` (flux: ``text_encoder_2/``) or
    ``clip_g`` (``text_encoder_2/``) and ``t5`` (``text_encoder_3/``)."""
    out = {}
    second = "t5" if model_name == "pyramid_flux" else "clip_g"
    for sub, name in (("text_encoder", "clip"), ("text_encoder_2", second),
                      ("text_encoder_3", "t5")):
        d = os.path.join(model_path, sub)
        if os.path.isdir(d):
            out[name] = _text_state(load_state_dict(d))
    return out


def require_components(comps: dict, names: Sequence[str], model_path: str):
    """Raise ``FileNotFoundError`` naming the components of ``names`` that
    ``comps`` lacks."""
    missing = [n for n in names if n not in comps]
    if missing:
        raise FileNotFoundError(
            f"no weights for {missing} under {model_path} (the released "
            f"layout: <variant>/, causal_video_vae/, text_encoder*/)")


def load_model_config(component_dir: str, kind: str):
    """The port's model config from a component directory's
    ``config.json``, read as the JAX package reads it: missing fields take
    the defaults, unknown ones are ignored, and with no JSON the default
    config comes back. A value the port cannot build (a VAE block type it
    does not know) raises, naming the field. ``kind``: ``"flux"``,
    ``"mmdit"`` or ``"vae"``."""
    from ..models.flux.model import FluxConfig
    from ..models.mmdit.model import MMDiTConfig
    from ..models.vae.model import VAEConfig

    cls = {"flux": FluxConfig, "mmdit": MMDiTConfig, "vae": VAEConfig}[kind]
    path = os.path.join(component_dir, "config.json")
    if not os.path.isfile(path):
        return cls()
    with open(path) as f:
        raw = dict(json.load(f))

    # field names and types of the reference's JSON
    if kind == "vae" and "encoder_layers_per_block" not in raw \
            and "layers_per_block" in raw:
        raw["encoder_layers_per_block"] = raw["layers_per_block"]
    raw = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()}
    names = {f.name for f in dataclasses.fields(cls)}
    try:
        return cls(**{k: v for k, v in raw.items() if k in names})
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def build_dit(model_path: str, model_variant: str, model_name: str,
              state_dict: Dict[str, torch.Tensor], *, dtype: torch.dtype,
              device, remat: bool = False, mesh=None,
              bounded_softmax: bool = True):
    """The family's DiT (``PyramidFluxTransformer`` for ``pyramid_flux``,
    else ``PyramidDiffusionMMDiT``) sized by ``<model_variant>/config.json``,
    built on ``device`` in ``dtype`` and holding ``state_dict`` (copied in,
    strictly); ``mesh`` and ``bounded_softmax`` as the DiT takes them
    (sequence parallelism; the attention's softmax form)."""
    from ..models.flux.model import PyramidFluxTransformer
    from ..models.mmdit.model import PyramidDiffusionMMDiT

    if model_name not in ("pyramid_flux", "pyramid_mmdit"):
        raise ValueError(f"no release-layout checkpoint to load for "
                         f"{model_name!r}: build its DiT and load its "
                         f"weights yourself")
    flux = model_name == "pyramid_flux"
    cls = PyramidFluxTransformer if flux else PyramidDiffusionMMDiT
    cfg = load_model_config(os.path.join(model_path, model_variant),
                            "flux" if flux else "mmdit")
    dit = cls(cfg, dtype=dtype, device=device, remat=remat, mesh=mesh,
              bounded_softmax=bounded_softmax)
    dit.load_state_dict(state_dict, strict=True)
    return dit


def build_vae(model_path: str, state_dict: Dict[str, torch.Tensor], *,
              dtype: torch.dtype, device):
    """The VAE sized by ``causal_video_vae/config.json``, built on
    ``device`` in ``dtype`` and holding ``state_dict``. Loaded by copy, so
    its conv weights keep the ``channels_last_3d`` layout the conv kernel
    reads. A config with the 2D twin blocks raises, naming the keys the
    released layout cannot place."""
    from ..models.vae.blocks import (DownEncoderBlock2D, MidBlock2D,
                                     UpDecoderBlock2D)
    from ..models.vae.model import CausalVideoVAE

    vae_dir = os.path.join(model_path, "causal_video_vae")
    vae = CausalVideoVAE(load_model_config(vae_dir, "vae"), dtype=dtype,
                         device=device)
    twins = tuple(name + "." for name, m in vae.named_modules()
                  if isinstance(m, (DownEncoderBlock2D, UpDecoderBlock2D,
                                    MidBlock2D)))
    if twins:
        keys = sorted(k for k in state_dict if k.startswith(twins))
        raise ValueError(
            f"{vae_dir}: the released layout places the causal 3D blocks' "
            f"keys only, as the JAX package's loader does; it cannot place "
            f"the 2D twin blocks {[t[:-1] for t in twins]}: keys "
            f"{keys or '(none in the files)'} (convert the JAX package's "
            f"variables with utils.converters.vae_state_dict_from_jax)")
    vae.load_state_dict(state_dict, strict=True)
    return vae


def export_ema_params(output_dir: str, step: int,
                      ema_params: Dict[str, torch.Tensor]) -> str:
    """Write ``<output_dir>/checkpoint-<step>-ema.pt``: ``ema_params``, the
    EMA weights keyed like the DiT's state dict (``TrainState.
    ema_state_dict``), loadable without the optimizer's structure. Returns
    the path."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(output_dir),
                        f"checkpoint-{step}-ema.pt")
    torch.save(ema_params, path)
    return path


def load_ema_params(path_or_dir: str) -> Dict[str, torch.Tensor]:
    """An EMA export's state dict, on the CPU. ``path_or_dir`` is a
    ``checkpoint-<step>-ema.pt`` file, or a training output directory, of
    which the newest step's export is read; ``FileNotFoundError`` when it
    holds none."""
    path = os.path.abspath(path_or_dir)
    if os.path.isdir(path):
        steps = [int(m.group(1)) for name in os.listdir(path)
                 if (m := re.fullmatch(r"checkpoint-(\d+)-ema\.pt", name))]
        if not steps:
            raise FileNotFoundError(f"no checkpoint-*-ema.pt under {path}")
        path = os.path.join(path, f"checkpoint-{max(steps)}-ema.pt")
    return torch.load(path, map_location="cpu", weights_only=True)
