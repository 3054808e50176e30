"""Port parity for the text encoders: T5, CLIP and the FLUX/SD3 wrappers.

Tiny configs in fp32 on the CPU. JAX weights are drawn from a numpy seed
and carried to the port by ``t5_state_dict_from_jax`` and
``clip_state_dict_from_jax`` (strict loads). The wrappers run both
packages on the same offline tokenizers (a char-level CLIP BPE vocabulary
and a word-level T5 ``tokenizer.json``, written here).

Two cases follow HF ``transformers`` instead of JAX, and are held to HF
(atol 2e-4, rtol 1e-3, fp32 sums in another order) with JAX shown to
differ: a CLIP config with the legacy ``eos_token_id=2`` (HF pools at
``argmax(input_ids)``, JAX at the first id 2) and ``hidden_act="gelu"``
(HF's exact erf GELU, JAX's tanh form). Everything else is held to JAX at
relative 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyramid_flow_tpu.models.text.clip import (
    CLIPTextConfig as JCLIPConfig, CLIPTextEncoder as JCLIP)
from pyramid_flow_tpu.models.text.encoder import (
    FluxTextEncoder as JFluxTE, SD3TextEncoder as JSD3TE)
from pyramid_flow_tpu.models.text.t5 import (
    T5Config as JT5Config, T5Encoder as JT5)
from pyramid_flow_tpu_torch.models.text.clip import (
    CLIPTextConfig, CLIPTextEncoder)
from pyramid_flow_tpu_torch.models.text.encoder import (
    FluxTextEncoder, SD3TextEncoder)
from pyramid_flow_tpu_torch.models.text.t5 import T5Config, T5Encoder
from pyramid_flow_tpu_torch.utils.converters import (
    clip_state_dict_from_jax, t5_state_dict_from_jax)

REL = 1e-4
HF_ATOL, HF_RTOL = 2e-4, 1e-3
T5_TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
               num_heads=4)
CLIP_VOCAB = 88  # the char-level tokenizer's vocabulary (see below)
CLIP_TINY = dict(vocab_size=CLIP_VOCAB, hidden_size=24, intermediate_size=48,
                 num_layers=2, num_heads=4, eos_token_id=1)
PROMPTS = ["a cat walks on grass", "", "waves at dusk, hyper quality"]


# ----------------------------------------------------- offline tokenizers
def write_clip_tokenizer(d):
    """Minimal offline CLIPTokenizer: char-level vocab, no merges."""
    os.makedirs(d, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789,.!?'- ":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 77}, f)
    return len(vocab)


def write_t5_tokenizer(d, vocab_size):
    """Minimal offline T5TokenizerFast: word-level tokenizer.json."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    os.makedirs(d, exist_ok=True)
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for w in ("a", "cat", "walks", "on", "grass", "hyper", "quality",
              "ultra", "hd", "8k"):
        vocab[w] = len(vocab)
    assert len(vocab) <= vocab_size
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 128, "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>",
                   "tokenizer_class": "T5TokenizerFast"}, f)


# ------------------------------------------------- HF-style config.json
def clip_config_json(cfg: CLIPTextConfig) -> dict:
    arch = ("CLIPTextModelWithProjection" if cfg.use_projection
            else "CLIPTextModel")
    return {"architectures": [arch], "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "layer_norm_eps": cfg.layer_norm_eps,
            "eos_token_id": cfg.eos_token_id, "hidden_act": cfg.hidden_act,
            "projection_dim": cfg.projection_dim}


def t5_config_json(cfg: T5Config) -> dict:
    return {"architectures": ["T5EncoderModel"], "vocab_size": cfg.vocab_size,
            "d_model": cfg.d_model, "d_kv": cfg.d_kv, "d_ff": cfg.d_ff,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "feed_forward_proj": "gated-gelu"}


def write_json(d, obj):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(obj, f)


# ------------------------------------------------------------ JAX weights
def draw(tree, rng, gain=1.0):
    """Redraw every leaf of a flax tree from ``rng``: kernels N(0, gain^2 /
    fan_in), embeddings N(0, 1), norm scales 1 + N(0, 0.1^2), biases and
    the relative bias table N(0, 0.1^2) and N(0, 0.5^2)."""
    def leaf(path, p):
        name = path[-1].key
        if name == "kernel":
            x = gain * rng.standard_normal(p.shape) / np.sqrt(p.shape[0])
        elif name in ("embedding", "position_embedding"):
            x = rng.standard_normal(p.shape)
        elif name == "relative_attention_bias":
            x = 0.5 * rng.standard_normal(p.shape)
        elif name in ("scale", "weight"):
            x = 1 + 0.1 * rng.standard_normal(p.shape)
        else:
            x = 0.1 * rng.standard_normal(p.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_t5(cfg: T5Config, seed: int):
    """(JAX module, numpy params) of a T5 at ``cfg``."""
    m = JT5(config=JT5Config(**vars(cfg)), dtype=jnp.float32)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32),
                            jnp.ones((1, 4), jnp.int32))
    return m, draw(shapes, np.random.default_rng(seed))


def jax_clip(cfg: CLIPTextConfig, seed: int, gain=1.0):
    m = JCLIP(config=JCLIPConfig(**vars(cfg)), dtype=jnp.float32)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    return m, draw(shapes, np.random.default_rng(seed), gain)


def port_t5(cfg, params):
    m = T5Encoder(cfg, device="cpu")
    m.load_state_dict(t5_state_dict_from_jax(params), strict=True)
    return m


def port_clip(cfg, params):
    m = CLIPTextEncoder(cfg, device="cpu")
    m.load_state_dict(clip_state_dict_from_jax(params), strict=True)
    return m


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def clip_ids(cfg, rows=3, length=12, seed=5):
    """Ids in [3, eos) with the config's EOS at a different place per row
    and EOS padding after it, as the CLIP tokenizer pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size - 1, (rows, length))
    for r, end in enumerate((4, 9, 11)[:rows]):
        ids[r, end:] = cfg.eos_token_id
    return ids


# ------------------------------------------------------------------ T5
def test_t5_matches_jax_with_padded_rows():
    cfg = T5Config(**T5_TINY)
    jm, params = jax_t5(cfg, seed=0)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (3, 20))
    mask = np.ones((3, 20), np.int32)
    mask[1, 7:] = 0
    mask[2, 15:] = 0
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = port_t5(cfg, params)(torch.from_numpy(ids),
                               torch.from_numpy(mask)).detach().numpy()
    assert got.shape == want.shape == (3, 20, 32)
    assert rel_err(got, want) < REL
    # every row, its padded positions included
    for r in range(3):
        assert rel_err(got[r], want[r]) < REL


def test_t5_state_dict_is_keyed_like_hf():
    from transformers import T5Config as HFT5, T5EncoderModel

    cfg = T5Config(**T5_TINY)
    hf = T5EncoderModel(HFT5(feed_forward_proj="gated-gelu", **T5_TINY))
    port = T5Encoder(cfg, device="cpu")
    hf_keys = set(hf.state_dict()) - {"encoder.embed_tokens.weight"}
    assert set(port.state_dict()) == hf_keys
    for k, v in port.state_dict().items():
        assert hf.state_dict()[k].shape == v.shape, k


def test_t5_matches_hf():
    """The same weights through HF's T5EncoderModel (its gated-gelu is the
    tanh form, as JAX's and the port's)."""
    from transformers import T5Config as HFT5, T5EncoderModel

    cfg = T5Config(**T5_TINY)
    _, params = jax_t5(cfg, seed=2)
    sd = t5_state_dict_from_jax(params)
    hf = T5EncoderModel(HFT5(feed_forward_proj="gated-gelu",
                             **T5_TINY)).eval()
    hf.load_state_dict({**sd, "encoder.embed_tokens.weight":
                        sd["shared.weight"]}, strict=True)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 16)))
    mask = torch.ones((2, 16), dtype=torch.long)
    mask[1, 10:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = port_t5(cfg, params)(ids, mask)
    valid = mask.bool()
    torch.testing.assert_close(got[valid], want[valid], atol=HF_ATOL,
                               rtol=HF_RTOL)


# ---------------------------------------------------------------- CLIP
@pytest.mark.parametrize("use_projection", [False, True])
def test_clip_matches_jax(use_projection):
    cfg = CLIPTextConfig(max_position_embeddings=16,
                         use_projection=use_projection, projection_dim=12,
                         **CLIP_TINY)
    jm, params = jax_clip(cfg, seed=4)
    ids = clip_ids(cfg)
    want_h, want_p = map(np.asarray, jm.apply(params, jnp.asarray(ids)))
    port = port_clip(cfg, params)
    assert ("text_projection.weight" in port.state_dict()) == use_projection
    got_h, got_p = port(torch.from_numpy(ids))
    assert got_p.shape == want_p.shape == (3, 12 if use_projection else 24)
    assert rel_err(got_h.detach(), want_h) < REL
    assert rel_err(got_p.detach(), want_p) < REL
    # pooled at each row's first EOS
    torch.testing.assert_close(
        port.eos_positions(torch.from_numpy(ids)), torch.tensor([4, 9, 11]))


def _hf_clip(cfg: CLIPTextConfig, sd):
    from transformers import CLIPTextConfig as HFClip
    from transformers import CLIPTextModel, CLIPTextModelWithProjection

    hf_cfg = HFClip(**{k: v for k, v in clip_config_json(cfg).items()
                       if k != "architectures"}, bos_token_id=0,
                    pad_token_id=1)
    cls = (CLIPTextModelWithProjection if cfg.use_projection
           else CLIPTextModel)
    hf = cls(hf_cfg).eval()
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {
        "text_model.embeddings.position_ids"}
    return hf


def _hf_outputs(hf, ids):
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(ids))
    pooled = out.text_embeds if hasattr(out, "text_embeds") \
        else out.pooler_output
    return out.last_hidden_state.numpy(), pooled.numpy()


def test_clip_legacy_eos_pools_like_hf_not_jax():
    """``eos_token_id=2``: HF (and the port) pool at argmax(input_ids), the
    highest id, which the CLIP tokenizer gives its EOS; JAX pools at the
    first id 2, position 0 when the prompt has none."""
    cfg = CLIPTextConfig(**{**CLIP_TINY, "eos_token_id": 2},
                         max_position_embeddings=16)
    jm, params = jax_clip(cfg, seed=6)
    rng = np.random.default_rng(7)
    ids = rng.integers(3, cfg.vocab_size - 1, (3, 12))
    for r, end in enumerate((4, 9, 11)):
        ids[r, end:] = cfg.vocab_size - 1  # the highest id: the real EOS
    sd = clip_state_dict_from_jax(params)
    want_h, want_p = _hf_outputs(_hf_clip(cfg, sd), ids)
    port = port_clip(cfg, params)
    got_h, got_p = (t.detach().numpy() for t in port(torch.from_numpy(ids)))
    np.testing.assert_allclose(got_h, want_h, atol=HF_ATOL, rtol=HF_RTOL)
    np.testing.assert_allclose(got_p, want_p, atol=HF_ATOL, rtol=HF_RTOL)
    # JAX: same hidden states, pooled at position 0
    jax_h, jax_p = map(np.asarray, jm.apply(params, jnp.asarray(ids)))
    assert rel_err(got_h, jax_h) < REL
    np.testing.assert_allclose(jax_p, jax_h[:, 0], atol=1e-6)
    assert not np.allclose(jax_p, want_p, atol=HF_ATOL, rtol=HF_RTOL)
    assert np.abs(jax_p - want_p).max() > 0.5


def test_clip_g_gelu_is_exact_like_hf_not_jax():
    """``hidden_act="gelu"`` (CLIP-G): HF's and the port's exact GELU;
    JAX's tanh form misses HF by more than the absolute tolerance and by
    over 50x the port's error (a wide MLP and 3x gains spread the
    pre-activations over |x| ~ 2-3, where the two forms differ most)."""
    cfg = CLIPTextConfig(**{**CLIP_TINY, "eos_token_id": CLIP_VOCAB - 1,
                            "intermediate_size": 256},
                         hidden_act="gelu", max_position_embeddings=16,
                         use_projection=True, projection_dim=12)
    jm, params = jax_clip(cfg, seed=8, gain=3.0)
    ids = clip_ids(cfg, seed=9)
    sd = clip_state_dict_from_jax(params)
    want_h, want_p = _hf_outputs(_hf_clip(cfg, sd), ids)
    got_h, got_p = (t.detach().numpy()
                    for t in port_clip(cfg, params)(torch.from_numpy(ids)))
    np.testing.assert_allclose(got_h, want_h, atol=HF_ATOL, rtol=HF_RTOL)
    np.testing.assert_allclose(got_p, want_p, atol=HF_ATOL, rtol=HF_RTOL)
    jax_h, jax_p = map(np.asarray, jm.apply(params, jnp.asarray(ids)))
    # the tanh form's error stands far above the port's fp32 noise
    for jax_out, got, want in ((jax_h, got_h, want_h),
                               (jax_p, got_p, want_p)):
        jax_err = np.abs(jax_out - want).max()
        assert jax_err > HF_ATOL
        assert jax_err > 50 * np.abs(got - want).max()


def test_clip_state_dict_is_keyed_like_hf():
    from transformers import CLIPTextConfig as HFClip
    from transformers import CLIPTextModelWithProjection

    cfg = CLIPTextConfig(use_projection=True, projection_dim=12,
                         **CLIP_TINY)
    hf = CLIPTextModelWithProjection(HFClip(
        vocab_size=CLIP_VOCAB, hidden_size=24, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, projection_dim=12))
    port = CLIPTextEncoder(cfg, device="cpu")
    hf_sd = hf.state_dict()
    hf_sd.pop("text_model.embeddings.position_ids", None)
    assert set(port.state_dict()) == set(hf_sd)
    for k, v in port.state_dict().items():
        assert hf_sd[k].shape == v.shape, k


# ------------------------------------------------------------ wrappers
def write_tokenizers(root, model_name):
    """The released tokenizer layout: CLIP under ``tokenizer/``, then T5
    under ``tokenizer_2/`` (flux), or CLIP-G there and T5 under
    ``tokenizer_3/`` (MMDiT)."""
    assert write_clip_tokenizer(os.path.join(root, "tokenizer")) == CLIP_VOCAB
    t5 = "tokenizer_2"
    if model_name == "pyramid_mmdit":
        write_clip_tokenizer(os.path.join(root, "tokenizer_2"))
        t5 = "tokenizer_3"
    write_t5_tokenizer(os.path.join(root, t5), T5_TINY["vocab_size"])


def _assert_same_features(got, want):
    emb, mask, pooled = got
    jemb, jmask, jpooled = (np.asarray(x) for x in want)
    assert emb.dtype == torch.float32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert 0 < jmask.sum() < jmask.size  # padded rows
    assert rel_err(emb.numpy(), jemb) < REL
    assert rel_err(pooled.numpy(), jpooled) < REL


def test_flux_text_encoder_matches_jax(tmp_path):
    """CLIP-L pooled + T5, sized by the checkpoint's config.json files (the
    JAX wrapper reads them too)."""
    write_tokenizers(str(tmp_path), "pyramid_flux")
    clip_cfg = CLIPTextConfig(**CLIP_TINY)
    t5_cfg = T5Config(**T5_TINY)
    write_json(str(tmp_path / "text_encoder"), clip_config_json(clip_cfg))
    write_json(str(tmp_path / "text_encoder_2"), t5_config_json(t5_cfg))
    _, clip_params = jax_clip(clip_cfg, seed=10)
    _, t5_params = jax_t5(t5_cfg, seed=11)
    jte = JFluxTE(clip_params, t5_params, str(tmp_path), dtype=jnp.float32)
    te = FluxTextEncoder.from_state_dicts(
        clip_state_dict_from_jax(clip_params),
        t5_state_dict_from_jax(t5_params), str(tmp_path),
        dtype=torch.float32, device="cpu")
    assert (te.clip.config, te.t5.config) == (clip_cfg, t5_cfg)
    got = te(PROMPTS)
    assert got[0].shape == (3, 128, 32) and got[2].shape == (3, 24)
    _assert_same_features(got, jte(PROMPTS))


def test_sd3_text_encoder_matches_jax(tmp_path):
    """CLIP-L + CLIP-G projected (concatenated pooled) + T5, sized by the
    checkpoint's config.json files, as both packages read them."""
    root = tmp_path
    write_tokenizers(str(root), "pyramid_mmdit")
    cfg_l = CLIPTextConfig(use_projection=True, projection_dim=12,
                           **CLIP_TINY)
    # quick-GELU: the GELU divergence has its own test
    cfg_g = CLIPTextConfig(**{**CLIP_TINY, "hidden_size": 32},
                           use_projection=True, projection_dim=16)
    cfg_t5 = T5Config(**T5_TINY)
    write_json(str(root / "text_encoder"), clip_config_json(cfg_l))
    write_json(str(root / "text_encoder_2"), clip_config_json(cfg_g))
    write_json(str(root / "text_encoder_3"), t5_config_json(cfg_t5))
    _, pl = jax_clip(cfg_l, seed=12)
    _, pg = jax_clip(cfg_g, seed=13)
    _, pt = jax_t5(cfg_t5, seed=14)
    te = SD3TextEncoder.from_state_dicts(
        clip_state_dict_from_jax(pl), clip_state_dict_from_jax(pg),
        t5_state_dict_from_jax(pt), str(root), dtype=torch.float32,
        device="cpu")
    assert te.clip_g.config == cfg_g
    got = te(PROMPTS)
    assert got[2].shape == (3, 28)
    want = JSD3TE(pl, pg, pt, str(root), dtype=jnp.float32)(PROMPTS)
    _assert_same_features(got, want)


def test_tokenizers_argument_and_missing_transformers(monkeypatch):
    """``tokenizers=`` skips loading; without it and without transformers,
    loading raises ImportError (no other tokenizer is tried)."""
    import builtins
    from pyramid_flow_tpu_torch.models.text import encoder

    clip = CLIPTextEncoder(CLIPTextConfig(**CLIP_TINY), device="cpu")
    t5 = T5Encoder(T5Config(**T5_TINY), device="cpu")
    te = FluxTextEncoder(clip, t5, tokenizers=("c", "t"))
    assert (te.clip_tokenizer, te.t5_tokenizer) == ("c", "t")

    real_import = builtins.__import__

    def no_transformers(name, *args, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("No module named 'transformers'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="tokenizers="):
        encoder._load_tokenizer("/nonexistent", "clip")
    with pytest.raises(ImportError, match="transformers"):
        FluxTextEncoder(clip, t5, model_path="/nonexistent")
