"""JAX parameter trees -> state dicts of the port's modules.

The JAX package keeps flax variables as nested dicts; the port's modules are
keyed like the released torch checkpoint. These converters take the JAX
variables as nested dicts of numpy arrays and return state dicts that
``load_state_dict(strict=True)`` accepts:

* the scanned block stacks (a leading layer axis) become per-layer keys
  ``transformer_blocks.{i}.`` (the MMDiT's separate last block, too);
* Dense kernels ``[in, out]`` become Linear weights ``[out, in]``;
* conv kernels DHWIO become Conv3d weights OIDHW under ``<conv>.conv.``;
* norm ``scale`` becomes ``weight``;
* flax's flat names become the checkpoint's module paths (``resnets_0`` ->
  ``resnets.0``, ``attn/to_out`` -> ``attn.to_out.0``, ``ff/proj_in`` ->
  ``ff.net.0.proj``, ...).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["flux_state_dict_from_jax", "mmdit_state_dict_from_jax",
           "vae_state_dict_from_jax"]

_STACKED = ("transformer_blocks", "single_transformer_blocks")
_FLUX_RENAMES = {
    "timestep_embedder_1": "timestep_embedder.linear_1",
    "timestep_embedder_2": "timestep_embedder.linear_2",
    "text_embedder_1": "text_embedder.linear_1",
    "text_embedder_2": "text_embedder.linear_2",
    "to_out": "to_out.0",
}
_FF_RENAMES = {"proj_in": "net.0.proj", "proj_out": "net.2"}
_VAE_RENAMES = {
    "downsampler": "downsamplers.0",
    "temporal_downsampler": "temporal_downsamplers.0",
    "upsampler": "upsamplers.0",
    "temporal_upsampler": "temporal_upsamplers.0",
    "to_out": "to_out.0",
}


def _unwrap(params: dict) -> dict:
    return params["params"] if "params" in params else params


def _modules(tree: dict, path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], dict]]:
    """(path, leaves) of every flax module that holds arrays directly."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _modules(v, path + (k,))


def _module_entries(prefix: str, leaves: dict) -> Dict[str, np.ndarray]:
    """One flax module's arrays -> torch keys under ``prefix``."""
    out = {}
    kernel = leaves.get("kernel")
    if kernel is not None and kernel.ndim == 5:  # conv: DHWIO -> OIDHW
        out[f"{prefix}.conv.weight"] = kernel.transpose(4, 3, 0, 1, 2)
        if "bias" in leaves:
            out[f"{prefix}.conv.bias"] = leaves["bias"]
        return out
    if kernel is not None:  # Dense: [in, out] -> [out, in]
        out[f"{prefix}.weight"] = kernel.T
    if "scale" in leaves:  # RMSNorm / GroupNorm
        out[f"{prefix}.weight"] = leaves["scale"]
    if "bias" in leaves:
        out[f"{prefix}.bias"] = leaves["bias"]
    unknown = set(leaves) - {"kernel", "scale", "bias"}
    if unknown:
        raise KeyError(f"unexpected leaves {sorted(unknown)} at {prefix}")
    return out


def _to_torch(entries: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in entries.items()}


def _dit_entries(tree: dict, stacked: Tuple[str, ...] = _STACKED
                 ) -> Dict[str, np.ndarray]:
    """A DiT's flax modules -> torch keys; the subtrees named in ``stacked``
    carry a leading layer axis and become per-layer keys."""
    entries: Dict[str, np.ndarray] = {}
    for path, leaves in _modules(tree):
        names = []
        for i, seg in enumerate(path):
            if i > 0 and path[i - 1] in ("ff", "ff_context"):
                seg = _FF_RENAMES.get(seg, seg)
            names.append(_FLUX_RENAMES.get(seg, seg))
        if path[0] in stacked:
            n = next(iter(leaves.values())).shape[0]
            for layer in range(n):
                prefix = ".".join([names[0], str(layer)] + names[1:])
                entries.update(_module_entries(
                    prefix, {k: v[layer] for k, v in leaves.items()}))
        else:
            entries.update(_module_entries(".".join(names), leaves))
    return entries


def flux_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``PyramidFluxTransformer`` variables -> ``PyramidFluxTransformer``
    state dict (fp32 tensors)."""
    return _to_torch(_dit_entries(_unwrap(params)))


def mmdit_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``PyramidDiffusionMMDiT`` variables -> ``PyramidDiffusionMMDiT``
    state dict (fp32 tensors), keyed like the released checkpoint:

    * the scanned ``transformer_blocks`` become ``transformer_blocks.{i}``
      and ``final_block`` the last of them, ``transformer_blocks.{n-1}``;
    * ``pos_embed_proj`` (a Dense over ``(p1, p2, c)`` token features, patch
      2 as in every MMDiT config) becomes ``pos_embed.proj`` with the
      checkpoint's conv2d weight shape ``[D, C, 2, 2]``;
    * ``pos_embed_table`` ``[G, G, D]`` becomes ``pos_embed.pos_embed``
      ``[1, G*G, D]``."""
    tree = dict(_unwrap(params))
    table = np.asarray(tree.pop("pos_embed_table"))
    proj = tree.pop("pos_embed_proj")
    final = tree.pop("final_block")
    entries = _dit_entries(tree, stacked=("transformer_blocks",))
    _, leaves = next(_modules(tree["transformer_blocks"]))
    n = 1 + next(iter(leaves.values())).shape[0]
    entries.update(_dit_entries(
        {"transformer_blocks": {str(n - 1): final}}, stacked=()))
    kernel = np.asarray(proj["kernel"])
    entries["pos_embed.proj.weight"] = kernel.reshape(
        2, 2, kernel.shape[0] // 4, -1).transpose(3, 2, 0, 1)
    entries["pos_embed.proj.bias"] = proj["bias"]
    entries["pos_embed.pos_embed"] = table.reshape(1, -1, table.shape[-1])
    return _to_torch(entries)


def vae_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``CausalVideoVAE`` variables (encoder, ``quant_conv``,
    ``post_quant_conv`` and decoder) -> the port's ``CausalVideoVAE`` state
    dict (fp32 tensors)."""
    entries: Dict[str, np.ndarray] = {}
    for path, leaves in _modules(_unwrap(params)):
        names = [re.sub(r"^(\w+?)_(\d+)$", r"\1.\2",
                        _VAE_RENAMES.get(seg, seg)) for seg in path]
        entries.update(_module_entries(".".join(names), leaves))
    return _to_torch(entries)
