"""CLIP text encoder: the pooled text encoder.

The port of the JAX package's ``models/text/clip.py``, keyed like HF
``CLIPTextModel`` (``text_model.*``) plus ``text_projection.weight`` when
``use_projection`` is set (``CLIPTextModelWithProjection``, SD3's two CLIPs),
so a released state dict loads with ``load_state_dict(strict=True)``.
CLIP-L: 12 layers of 768; CLIP-G (``CLIPTextConfig.clip_g()``): 32 of 1280,
projected to 1280.

* learned token and position embeddings (at most 77 positions);
* pre-LN transformer with causal attention (scores and softmax in fp32),
  then the final LayerNorm;
* pooled output: the final hidden state at the EOS token of each row.

Two rules follow HF's ``CLIPTextTransformer``, which the released weights
were trained with, where the JAX package departs from it:

* pooling: a config whose ``eos_token_id`` is 2 (the legacy value that the
  CLIP configs shipped with FLUX.1 and SD3 carry) pools at
  ``argmax(input_ids)``, the highest token id, as HF does for it. JAX pools
  at the first token equal to 2, position 0 when the prompt has none.
  Every other ``eos_token_id`` pools at its first occurrence in both.
* activation: ``hidden_act="gelu"`` (CLIP-G) is the exact erf GELU, as in
  HF. JAX uses ``nn.gelu``'s tanh approximation for it. ``quick_gelu``
  (CLIP-L) is the same in both.

Everything else follows the JAX package. Built on the CUDA device unless
``device=`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.devices import model_device

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "LEGACY_EOS_TOKEN_ID"]

# HF pools at argmax(input_ids) for this eos_token_id
LEGACY_EOS_TOKEN_ID = 2


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    hidden_act: str = "quick_gelu"  # CLIP-L; CLIP-G uses plain gelu
    # SD3's CLIPTextModelWithProjection: pooled -> text_projection (no bias)
    use_projection: bool = False
    projection_dim: int = 768

    @staticmethod
    def clip_g(use_projection: bool = True) -> "CLIPTextConfig":
        """OpenCLIP bigG (SD3's second encoder): 1280-d, 32 layers, 20
        heads."""
        return CLIPTextConfig(
            hidden_size=1280, intermediate_size=5120, num_layers=32,
            num_heads=20, hidden_act="gelu", use_projection=use_projection,
            projection_dim=1280)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


# the released CLIP-L's and CLIP-G's; "gelu" is the exact (erf) form
_ACTIVATIONS = {"quick_gelu": _quick_gelu, "gelu": F.gelu}


class _Attention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.num_heads = cfg.num_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)

    def forward(self, x, causal):
        b, l, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.view(b, l, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        scores = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
        scores = scores.masked_fill(~causal, -1e9)
        probs = scores.softmax(dim=-1).to(v.dtype)
        return self.out_proj((probs @ v).transpose(1, 2).reshape(b, l, d))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        if cfg.hidden_act not in _ACTIVATIONS:
            raise ValueError(f"hidden_act {cfg.hidden_act!r}: the port has "
                             f"{sorted(_ACTIVATIONS)}")
        self.act = _ACTIVATIONS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, h):
        return self.fc2(self.act(self.fc1(h)))


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.self_attn = _Attention(cfg, **kw)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        **kw)
        self.mlp = _MLP(cfg, **kw)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        **kw)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size, **kw)

    def forward(self, input_ids):
        l = input_ids.shape[1]
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[None, :l])


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, **kw)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **kw)
        self.encoder = _Encoder(cfg, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             cfg.layer_norm_eps, **kw)


class CLIPTextEncoder(nn.Module):
    """input_ids [B, L] -> (last hidden [B, L, D], pooled [B, D] or
    [B, projection_dim])."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig(), *,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=dtype, device=model_device(device, "CLIPTextEncoder"))
        self.text_model = _TextTransformer(cfg, **kw)
        if cfg.use_projection:
            self.text_projection = nn.Linear(cfg.hidden_size,
                                             cfg.projection_dim, bias=False,
                                             **kw)

    def eos_positions(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B] position pooled in each row (see the module docstring)."""
        if self.config.eos_token_id == LEGACY_EOS_TOKEN_ID:
            return input_ids.argmax(dim=-1)
        return (input_ids == self.config.eos_token_id).int().argmax(dim=-1)

    def forward(self, input_ids):
        tm = self.text_model
        x = tm.embeddings(input_ids)
        l = input_ids.shape[1]
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=x.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        rows = torch.arange(x.shape[0], device=x.device)
        pooled = x[rows, self.eos_positions(input_ids)]
        if self.config.use_projection:
            pooled = self.text_projection(pooled)
        return x, pooled
