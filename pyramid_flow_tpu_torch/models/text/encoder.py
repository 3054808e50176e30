"""Text-encoder wrappers: prompts -> (prompt_embeds, attention_mask, pooled).

The port of the JAX package's ``models/text/encoder.py``:

* :class:`FluxTextEncoder`: CLIP-L pooled (768) + T5 sequence embeddings
  (4096 wide, at most 128 tokens);
* :class:`SD3TextEncoder`: CLIP-L + CLIP-G projected pooled (concatenated,
  2048) + T5 sequence embeddings.

Each returns ``(embeds, bool mask, pooled)`` on its encoders' device. The
tokenizers load from the checkpoint's ``tokenizer*/`` directories through
``transformers`` (host-side text processing), or come in through
``tokenizers=``; without ``transformers`` and without ``tokenizers=``
loading raises ``ImportError``. :func:`build_text_encoder` builds a
family's wrapper from the state dicts ``utils.checkpoint`` reads and the
checkpoint's ``text_encoder*/config.json``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple, Union

import torch

from .clip import CLIPTextConfig, CLIPTextEncoder
from .t5 import T5Config, T5Encoder

__all__ = ["FluxTextEncoder", "SD3TextEncoder", "build_text_encoder",
           "clip_config_from_dir", "t5_config_from_dir"]


def _load_tokenizer(path: str, kind: str):
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "loading the checkpoint's tokenizers needs the transformers "
            "package, which is not installed; install it or pass "
            "tokenizers=") from e
    if kind == "clip":
        return transformers.CLIPTokenizer.from_pretrained(path)
    return transformers.T5TokenizerFast.from_pretrained(path)


def _read_json(component_dir: Optional[str]):
    if not component_dir:
        return None
    p = os.path.join(component_dir, "config.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def clip_config_from_dir(component_dir: Optional[str],
                         use_projection: Optional[bool] = None
                         ) -> Optional[CLIPTextConfig]:
    """A :class:`CLIPTextConfig` from a HF ``text_encoder*/config.json``;
    None when the directory has none. ``use_projection`` defaults to whether
    ``architectures`` names a ``...WithProjection`` model."""
    raw = _read_json(component_dir)
    if raw is None:
        return None
    if use_projection is None:
        use_projection = "WithProjection" in str(raw.get("architectures", ""))
    base = CLIPTextConfig()
    return CLIPTextConfig(
        vocab_size=raw.get("vocab_size", base.vocab_size),
        hidden_size=raw.get("hidden_size", base.hidden_size),
        intermediate_size=raw.get("intermediate_size", base.intermediate_size),
        num_layers=raw.get("num_hidden_layers", base.num_layers),
        num_heads=raw.get("num_attention_heads", base.num_heads),
        max_position_embeddings=raw.get("max_position_embeddings",
                                        base.max_position_embeddings),
        layer_norm_eps=raw.get("layer_norm_eps", base.layer_norm_eps),
        eos_token_id=raw.get("eos_token_id", base.eos_token_id),
        hidden_act=raw.get("hidden_act", base.hidden_act),
        use_projection=use_projection,
        projection_dim=raw.get("projection_dim", base.projection_dim))


def t5_config_from_dir(component_dir: Optional[str]) -> Optional[T5Config]:
    """A :class:`T5Config` from a HF ``text_encoder*/config.json``; None
    when the directory has none."""
    raw = _read_json(component_dir)
    if raw is None:
        return None
    base = T5Config()
    return T5Config(
        vocab_size=raw.get("vocab_size", base.vocab_size),
        d_model=raw.get("d_model", base.d_model),
        d_kv=raw.get("d_kv", base.d_kv),
        d_ff=raw.get("d_ff", base.d_ff),
        num_layers=raw.get("num_layers", base.num_layers),
        num_heads=raw.get("num_heads", base.num_heads),
        relative_attention_num_buckets=raw.get(
            "relative_attention_num_buckets",
            base.relative_attention_num_buckets),
        relative_attention_max_distance=raw.get(
            "relative_attention_max_distance",
            base.relative_attention_max_distance),
        layer_norm_epsilon=raw.get("layer_norm_epsilon",
                                   base.layer_norm_epsilon))


def _subdir(model_path: Optional[str], name: str) -> Optional[str]:
    return os.path.join(model_path, name) if model_path else None


def _frozen(module, state_dict):
    """``module`` holding ``state_dict`` (copied in, strictly), frozen."""
    module.load_state_dict(state_dict, strict=True)
    return module.eval().requires_grad_(False)


def _ids(tokenizer, prompts: List[str], max_length: int, device):
    enc = tokenizer(prompts, padding="max_length", max_length=max_length,
                    truncation=True, return_tensors="np")
    return (torch.as_tensor(enc["input_ids"], device=device).long(),
            torch.as_tensor(enc["attention_mask"], device=device))


class FluxTextEncoder:
    """CLIP-L pooled + T5 sequence embeddings with mask.

    Args:
      clip, t5: the encoders (a :class:`CLIPTextEncoder` and a
        :class:`T5Encoder`).
      model_path: checkpoint root holding ``tokenizer/`` and
        ``tokenizer_2/``, as in the released layout; not needed with
        ``tokenizers=(clip_tokenizer, t5_tokenizer)``.
    """

    def __init__(self, clip: CLIPTextEncoder, t5: T5Encoder,
                 model_path: Optional[str] = None,
                 tokenizers: Optional[Tuple] = None,
                 max_sequence_length: int = 128):
        self.clip, self.t5 = clip, t5
        self.max_sequence_length = max_sequence_length
        if tokenizers is not None:
            self.clip_tokenizer, self.t5_tokenizer = tokenizers
        else:
            if model_path is None:
                raise ValueError("pass model_path or tokenizers")
            self.clip_tokenizer = _load_tokenizer(
                os.path.join(model_path, "tokenizer"), "clip")
            self.t5_tokenizer = _load_tokenizer(
                os.path.join(model_path, "tokenizer_2"), "t5")

    @classmethod
    def from_state_dicts(cls, clip_state, t5_state,
                         model_path: Optional[str] = None, *,
                         dtype: torch.dtype = torch.bfloat16, device="cuda",
                         **kwargs) -> "FluxTextEncoder":
        """The encoders built from their state dicts, sized by the
        checkpoint's ``text_encoder{,_2}/config.json``, else the released
        sizes."""
        cfg_clip = clip_config_from_dir(_subdir(model_path, "text_encoder")) \
            or CLIPTextConfig()
        cfg_t5 = t5_config_from_dir(_subdir(model_path, "text_encoder_2")) \
            or T5Config()
        kw = dict(dtype=dtype, device=device)
        return cls(_frozen(CLIPTextEncoder(cfg_clip, **kw), clip_state),
                   _frozen(T5Encoder(cfg_t5, **kw), t5_state), model_path,
                   **kwargs)

    @property
    def device(self) -> torch.device:
        return self.t5.shared.weight.device

    def tokenize(self, prompts: Union[str, List[str]]):
        """(CLIP ids, T5 ids, T5 mask) on the encoders' device."""
        if isinstance(prompts, str):
            prompts = [prompts]
        clip_ids, _ = _ids(self.clip_tokenizer, prompts,
                           self.clip_tokenizer.model_max_length, self.device)
        t5_ids, t5_mask = _ids(self.t5_tokenizer, prompts,
                               self.max_sequence_length, self.device)
        return clip_ids, t5_ids, t5_mask

    @torch.no_grad()
    def __call__(self, prompts: Union[str, List[str]]):
        clip_ids, t5_ids, t5_mask = self.tokenize(prompts)
        _, pooled = self.clip(clip_ids)
        embeds = self.t5(t5_ids, t5_mask)
        return embeds, t5_mask.bool(), pooled


class SD3TextEncoder:
    """CLIP-L + CLIP-G (projected pooled, concatenated: 2048) + T5 sequence
    embeddings. ``model_path`` holds ``tokenizer/``, ``tokenizer_2/`` and
    ``tokenizer_3/``; or ``tokenizers=(clip_l, clip_g, t5)``."""

    def __init__(self, clip_l: CLIPTextEncoder, clip_g: CLIPTextEncoder,
                 t5: T5Encoder, model_path: Optional[str] = None,
                 tokenizers: Optional[Tuple] = None,
                 max_sequence_length: int = 128):
        self.clip_l, self.clip_g, self.t5 = clip_l, clip_g, t5
        self.max_sequence_length = max_sequence_length
        if tokenizers is not None:
            self.tok_l, self.tok_g, self.tok_t5 = tokenizers
        else:
            if model_path is None:
                raise ValueError("pass model_path or tokenizers")
            self.tok_l = _load_tokenizer(
                os.path.join(model_path, "tokenizer"), "clip")
            self.tok_g = _load_tokenizer(
                os.path.join(model_path, "tokenizer_2"), "clip")
            self.tok_t5 = _load_tokenizer(
                os.path.join(model_path, "tokenizer_3"), "t5")

    @classmethod
    def from_state_dicts(cls, clip_l_state, clip_g_state, t5_state,
                         model_path: Optional[str] = None, *,
                         dtype: torch.dtype = torch.bfloat16, device="cuda",
                         **kwargs) -> "SD3TextEncoder":
        """The encoders built from their state dicts, sized by the
        checkpoint's ``text_encoder{,_2,_3}/config.json`` (both CLIPs
        projected), else the released sizes."""
        cfg_l = clip_config_from_dir(_subdir(model_path, "text_encoder"),
                                     use_projection=True) \
            or CLIPTextConfig(use_projection=True)
        cfg_g = clip_config_from_dir(_subdir(model_path, "text_encoder_2"),
                                     use_projection=True) \
            or CLIPTextConfig.clip_g()
        cfg_t5 = t5_config_from_dir(_subdir(model_path, "text_encoder_3")) \
            or T5Config()
        kw = dict(dtype=dtype, device=device)
        return cls(_frozen(CLIPTextEncoder(cfg_l, **kw), clip_l_state),
                   _frozen(CLIPTextEncoder(cfg_g, **kw), clip_g_state),
                   _frozen(T5Encoder(cfg_t5, **kw), t5_state), model_path,
                   **kwargs)

    @property
    def device(self) -> torch.device:
        return self.t5.shared.weight.device

    @torch.no_grad()
    def __call__(self, prompts: Union[str, List[str]]):
        if isinstance(prompts, str):
            prompts = [prompts]
        _, pooled_l = self.clip_l(_ids(self.tok_l, prompts, 77,
                                       self.device)[0])
        _, pooled_g = self.clip_g(_ids(self.tok_g, prompts, 77,
                                       self.device)[0])
        pooled = torch.cat([pooled_l, pooled_g], dim=-1)
        t5_ids, mask = _ids(self.tok_t5, prompts, self.max_sequence_length,
                            self.device)
        return self.t5(t5_ids, mask), mask.bool(), pooled


def build_text_encoder(components: dict, model_path: str,
                       model_name: str = "pyramid_flux", *,
                       dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The family's frozen text encoders from
    ``utils.checkpoint.load_text_components``' state dicts (taken out of
    ``components``), sized by the checkpoint's configs, with its tokenizers:
    :class:`FluxTextEncoder` (``clip``, ``t5``) for ``pyramid_flux``,
    :class:`SD3TextEncoder` (``clip``, ``clip_g``, ``t5``) otherwise. Raises
    ``FileNotFoundError`` naming any component missing."""
    from ...utils.checkpoint import require_components

    if model_name == "pyramid_flux":
        names, cls = ("clip", "t5"), FluxTextEncoder
    else:
        names, cls = ("clip", "clip_g", "t5"), SD3TextEncoder
    require_components(components, names, model_path)
    return cls.from_state_dicts(*(components.pop(n) for n in names),
                                model_path, dtype=dtype, device=device)
