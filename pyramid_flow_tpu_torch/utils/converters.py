"""Checkpoint files -> state dicts, and JAX parameter trees -> state dicts.

Reading: :func:`load_state_dict` reads a checkpoint file or a component
directory of the released layout (safetensors, read by this module's own
reader, or torch pickles) into ``{key: tensor}`` in the stored dtypes;
:func:`strip_component_prefix` takes one component out of a trainer
checkpoint.

The JAX package keeps flax variables as nested dicts; the port's modules are
keyed like the released torch checkpoint. The ``*_from_jax`` converters take
the JAX variables as nested dicts of numpy arrays and return state dicts
that ``load_state_dict(strict=True)`` accepts:

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

import json
import math
import os
import re
import sys
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["load_state_dict", "read_safetensors", "strip_component_prefix",
           "flux_state_dict_from_jax", "mmdit_state_dict_from_jax",
           "vae_state_dict_from_jax", "t5_state_dict_from_jax",
           "clip_state_dict_from_jax", "lpips_state_dict_from_jax",
           "discriminator_state_dict_from_jax"]

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64,
                      "I32": torch.int32, "BOOL": torch.bool}
_TORCH_SUFFIXES = (".bin", ".pth", ".pt")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file, or every checkpoint file of a component directory
    in sorted order (so the shards of a sharded T5 read whole), as CPU
    tensors in their stored dtypes. ``*.safetensors`` go through
    :func:`read_safetensors`; ``.bin``/``.pth``/``.pt`` through
    ``torch.load(weights_only=True)``, a ``"state_dict"`` entry unwrapped."""
    if os.path.isdir(path):
        out: Dict[str, torch.Tensor] = {}
        for name in sorted(os.listdir(path)):
            f = os.path.join(path, name)
            if name.endswith(".safetensors"):
                out.update(read_safetensors(f))
            elif name.endswith(_TORCH_SUFFIXES):
                out.update(_load_torch(f))
        return out
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return _load_torch(path)


def _load_torch(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header of ``{name: {dtype, shape, data_offsets}}`` (and an optional
    ``__metadata__``), then the raw little-endian buffers. The file is read
    once into memory and each tensor is a ``torch.frombuffer`` view of it
    (a copy where its offset is not a multiple of its item size). Raises on
    a dtype outside ``SAFETENSORS_DTYPES`` and on a truncated file."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors buffers are little-endian; this "
                           "reader runs on little-endian hosts only")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        view, got = memoryview(data), 0
        while got < len(data):
            r = f.readinto(view[got:])
            if not r:
                raise ValueError(f"{path}: file ends before its data")
            got += r
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = info["shape"]
        begin, end = info["data_offsets"]
        numel, itemsize = math.prod(shape), dtype.itemsize
        if end - begin != numel * itemsize or end > len(data):
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} "
                             f"for {numel} x {itemsize} bytes in "
                             f"{len(data)}")
        if numel == 0:
            t = torch.empty(shape, dtype=dtype)
        elif begin % itemsize == 0:
            t = torch.frombuffer(data, dtype=dtype, count=numel,
                                 offset=begin)
        else:
            t = torch.frombuffer(data, dtype=torch.uint8, count=end - begin,
                                 offset=begin).clone().view(dtype)
        out[name] = t.reshape(shape)
    return out


def strip_component_prefix(sd: Dict[str, torch.Tensor], component: str
                           ) -> Dict[str, torch.Tensor]:
    """One component of a trainer checkpoint whose keys carry the wrapper's
    attribute (``dit.``, ``vae.``), with the prefix removed. For ``dit``,
    keys with no prefix pass through too, except the VAE's and the text
    encoders'."""
    prefix = component + "."
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
        elif component == "dit" and not k.startswith(("vae.", "text_encoder")):
            out[k] = v
    return out

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


def t5_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``T5Encoder`` variables -> the port's ``T5Encoder`` state dict
    (fp32 tensors), keyed like HF ``T5EncoderModel``."""
    p = _unwrap(params)
    attn = "encoder.block.{}.layer.0"
    ff = "encoder.block.{}.layer.1"
    out = {"shared.weight": p["embed_tokens"]["embedding"],
           attn.format(0) + ".SelfAttention.relative_attention_bias.weight":
               p["relative_attention_bias"],
           "encoder.final_layer_norm.weight": p["final_layer_norm"]["weight"]}
    i = 0
    while f"block_{i}" in p:
        blk = p[f"block_{i}"]
        for name in ("q", "k", "v", "o"):
            out[f"{attn.format(i)}.SelfAttention.{name}.weight"] = \
                blk["attn"][name]["kernel"].T
        out[f"{attn.format(i)}.layer_norm.weight"] = blk["ln_attn"]["weight"]
        for name in ("wi_0", "wi_1", "wo"):
            out[f"{ff.format(i)}.DenseReluDense.{name}.weight"] = \
                blk[name]["kernel"].T
        out[f"{ff.format(i)}.layer_norm.weight"] = blk["ln_ff"]["weight"]
        i += 1
    return _to_torch(out)


def clip_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextEncoder`` variables -> the port's ``CLIPTextEncoder``
    state dict (fp32 tensors), keyed like HF ``CLIPTextModel`` (and
    ``text_projection.weight`` when the tree has the projection)."""
    p = _unwrap(params)
    emb = "text_model.embeddings"
    out = {f"{emb}.token_embedding.weight": p["token_embedding"]["embedding"],
           f"{emb}.position_embedding.weight": p["position_embedding"]}
    out.update(_module_entries("text_model.final_layer_norm",
                               p["final_layer_norm"]))
    i = 0
    while f"layers_{i}" in p:
        layer, t = p[f"layers_{i}"], f"text_model.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out.update(_module_entries(f"{t}.self_attn.{name}",
                                       layer["self_attn"][name]))
        for name in ("layer_norm1", "layer_norm2"):
            out.update(_module_entries(f"{t}.{name}", layer[name]))
        for name in ("fc1", "fc2"):
            out.update(_module_entries(f"{t}.mlp.{name}", layer[name]))
        i += 1
    if "text_projection" in p:
        out.update(_module_entries("text_projection", p["text_projection"]))
    return _to_torch(out)


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax conv kernel (spatial axes, then in, then out) -> a torch
    conv weight ``[out, in, *spatial]``."""
    nd = kernel.ndim
    return np.asarray(kernel).transpose(nd - 1, nd - 2, *range(nd - 2))


def lpips_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS`` variables (``vgg/conv_{i}``, ``lin_{k}``) -> the
    port's ``LPIPS`` state dict, keyed like the reference's
    ``vgg_lpips.pth``: ``net.slice{s}.{idx}.weight|bias`` at VGG16's
    ``features`` numbering and ``lin{k}.model.1.weight`` (fp32 tensors)."""
    from ..models.vae.lpips import SLICES

    p = _unwrap(params)
    out, conv, idx = {}, 0, 0
    for s, channels in enumerate(SLICES):
        idx += s > 0  # the max-pool opening every slice after the first
        for _ in channels:
            leaves = p["vgg"][f"conv_{conv}"]
            out[f"net.slice{s + 1}.{idx}.weight"] = _conv_weight(
                leaves["kernel"])
            out[f"net.slice{s + 1}.{idx}.bias"] = leaves["bias"]
            conv, idx = conv + 1, idx + 2  # the conv and its ReLU
    for k in range(len(SLICES)):
        out[f"lin{k}.model.1.weight"] = _conv_weight(p[f"lin_{k}"]["kernel"])
    return _to_torch(out)


def discriminator_state_dict_from_jax(params: dict
                                      ) -> Dict[str, torch.Tensor]:
    """JAX ``PatchDiscriminator2D`` or ``PatchDiscriminator3D`` variables ->
    the port's state dict of the same class (``conv_{n}``/``conv_out``
    weights and biases, fp32 tensors)."""
    out = {}
    for name, leaves in _unwrap(params).items():
        out[f"{name}.weight"] = _conv_weight(leaves["kernel"])
        out[f"{name}.bias"] = leaves["bias"]
    return _to_torch(out)
