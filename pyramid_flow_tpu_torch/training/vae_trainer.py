"""The GAN-VAE training step: the generator (the VAE and a learned scalar
``logvar``) and a PatchGAN discriminator, each with its own optimizer.

The counterpart of the JAX package's ``training/vae_trainer.py``, term for
term, its context-parallel branch included:

* generator: per frame of the flattened ``(B * T)`` frames,
  ``nll = (pixel_weight * MSE + perceptual_weight * LPIPS) / exp(logvar) +
  logvar``, averaged; plus ``kl_weight`` times the posterior's KL to N(0, 1)
  (summed per clip, averaged over the batch); plus, once ``step >=
  disc_start``, the hinge generator loss ``-mean(D(recon))`` times the
  adaptive weight ``clip(|d nll / d w| / (|d g / d w| + 1e-4), 0, 1e4) *
  disc_weight``, where ``w`` is the decoder's ``conv_out`` weight. The VAE
  decodes up to that conv (``decode_features``) and the step applies it, so
  both norms are ``torch.autograd.grad`` on that weight alone (the
  reference's last-layer gradients, with the graph retained);
  ``freeze_encoder`` detaches the moments;
* discriminator: ``0.5 * (mean relu(1 - D(real)) + mean relu(1 + D(fake)))``
  on the detached reconstruction, applied only once ``step >= disc_start``;
  before that its optimizer takes zero gradients, as JAX's does (its count
  and moments advance, and a weight decay of ``lr * wd = 1e-8`` rounds away
  in fp32);
* each optimizer is optax's ``clip_by_global_norm(max_grad_norm)`` then
  ``adamw`` with no decay mask: every parameter decays, biases and
  ``logvar`` too (``torch.optim.AdamW`` with one group, which is optax's
  update; not the DiT train state's ``ndim > 1`` mask).

The posterior noise of a step is ``draws.fold_in(state.step).normal(...)``
(JAX's ``fold_in(rng, step)``), so a draw source over JAX keys replays
JAX's draws. ``compute_dtype=torch.bfloat16`` runs the losses under
autocast with fp32 parameters; MSE, KL, LPIPS's sums, the logits' means and
the adaptive weight's norms stay fp32. On the card the VAE's admitted convs
take the conv kernel by that compute dtype (``CausalConv3d.uses_kernel``),
54 launches per step on the release VAE.

Context parallelism (``mesh``, a ("dp", "cp") ``DeviceMesh``,
``parallel.cp.make_cp_mesh``): each rank holds ``T / cp`` frames of its dp
slice of the batch, and every causal conv takes the previous cp rank's last
two frames as its front frames (``parallel.cp``; the conv kernel's
``front``). As in JAX: clips are continuations (``is_init=False``, ``T %
(8 cp) == 0``); the posterior noise is drawn at the global latent shape and
sharded; the KL sums each clip's frames over the cp ranks; MSE, LPIPS and
the 2D discriminator run on each rank's frames and are averaged; the 3D
discriminator sees the clip gathered over cp; the adaptive weight's norms
are of the global gradients. Each rank differentiates its own share of the
global loss and the gradients are averaged over every rank (the halo's
gradient returns to the rank it came from inside the backward).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from ..models.vae.model import gaussian_kl, gaussian_sample
from ..parallel.cp import cp_context, gather_time
from ..pipeline.noising import GeneratorDraws
from .train_state import clip_by_global_norm_

__all__ = ["VAETrainConfig", "VAETrainState", "create_vae_train_state",
           "make_vae_train_step", "AdaptiveLossWeight"]


class AdaptiveLossWeight:
    """Timestep-bucketed loss reweighter (reference ``modeling_loss.py:10-22``;
    defined there but unused, kept for parity with the JAX package): an EMA
    of per-bucket loss magnitudes, and per sample the clipped inverse of its
    bucket's."""

    def __init__(self, timestep_range=(0.0, 1.0), buckets: int = 30,
                 weight_range=(1e-7, 1e7), decay: float = 0.99):
        self.bucket_ranges = torch.linspace(
            timestep_range[0], timestep_range[1], buckets - 1)
        self.bucket_losses = torch.ones((buckets,), dtype=torch.float32)
        self.weight_range = weight_range
        self.decay = decay

    def weight(self, timestep: torch.Tensor) -> torch.Tensor:
        idx = torch.searchsorted(self.bucket_ranges, timestep)
        return (1.0 / self.bucket_losses[idx]).clamp(*self.weight_range)

    def update(self, timestep: torch.Tensor, loss: torch.Tensor) -> None:
        idx = torch.searchsorted(self.bucket_ranges, timestep)
        self.bucket_losses[idx] = (self.decay * self.bucket_losses[idx]
                                   + (1 - self.decay) * loss)


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 1e-4
    disc_learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    # loss weights (the reference's scripts/train_causal_video_vae.sh)
    kl_weight: float = 1e-12
    pixel_weight: float = 10.0
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_start: int = 250_000
    logvar_init: float = 0.0


class VAETrainState:
    """``step``, the VAE, the scalar ``logvar``, the discriminator (all fp32
    parameters) and their two AdamW optimizers."""

    def __init__(self, vae: nn.Module, disc: nn.Module, logvar: nn.Parameter,
                 gen_optimizer: torch.optim.Optimizer,
                 disc_optimizer: torch.optim.Optimizer,
                 config: VAETrainConfig):
        self.vae, self.disc, self.logvar = vae, disc, logvar
        self.gen_optimizer, self.disc_optimizer = gen_optimizer, disc_optimizer
        self.config = config
        self.step = 0

    @property
    def gen_params(self) -> List[nn.Parameter]:
        """The generator's parameters: the VAE's, then ``logvar``."""
        return list(self.vae.parameters()) + [self.logvar]

    def state_dict(self) -> dict:
        return {"step": self.step, "vae": self.vae.state_dict(),
                "logvar": self.logvar.detach().clone(),
                "disc": self.disc.state_dict(),
                "gen_optimizer": self.gen_optimizer.state_dict(),
                "disc_optimizer": self.disc_optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.vae.load_state_dict(state["vae"])
        self.disc.load_state_dict(state["disc"])
        with torch.no_grad():
            self.logvar.copy_(state["logvar"])
        self.gen_optimizer.load_state_dict(state["gen_optimizer"])
        self.disc_optimizer.load_state_dict(state["disc_optimizer"])
        self.step = int(state["step"])


def create_vae_train_state(vae: nn.Module, disc: nn.Module,
                           config: VAETrainConfig = VAETrainConfig()
                           ) -> VAETrainState:
    """The train state over ``vae`` and ``disc``, whose parameters must be
    fp32: a ``logvar`` of ``config.logvar_init`` on the VAE's device and two
    AdamW optimizers (betas, eps 1e-8, weight decay on every parameter). On
    CUDA they use PyTorch's fused AdamW step."""
    for module in (vae, disc):
        for name, p in module.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"parameter {name} is {p.dtype}; training "
                                "keeps fp32 parameters")
    device = next(vae.parameters()).device
    logvar = nn.Parameter(torch.tensor(config.logvar_init,
                                       dtype=torch.float32, device=device))

    def adamw(params, lr):
        return torch.optim.AdamW(
            params, lr=lr, betas=(config.beta1, config.beta2), eps=1e-8,
            weight_decay=config.weight_decay, fused=device.type == "cuda")

    return VAETrainState(
        vae, disc, logvar,
        adamw(list(vae.parameters()) + [logvar], config.learning_rate),
        adamw(list(disc.parameters()), config.disc_learning_rate), config)


def _flatten_t(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [(B T), ...]"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.float())


def _grads(loss: torch.Tensor, params: List[nn.Parameter]
           ) -> List[torch.Tensor]:
    """``d loss / d params``; a parameter the loss does not reach gets
    zeros (its optimizer still steps, as optax's does)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _apply(optimizer: torch.optim.Optimizer, params: List[nn.Parameter],
           grads: List[torch.Tensor], max_norm: float) -> None:
    clip_by_global_norm_(grads, max_norm)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


def make_vae_train_step(vae, lpips, disc, *, use_3d_disc: bool = False,
                        freeze_encoder: bool = False,
                        compute_dtype: Optional[torch.dtype] = None,
                        grads_only: bool = False, is_init: bool = True,
                        mesh=None):
    """Build the GAN-VAE step.

    ``step(state, video, draws) -> metrics`` takes ``video`` ``[B, T, H, W,
    3]`` in [-1, 1] on the VAE's device (``T = 1 + 8k``), updates ``state``
    (a :func:`create_vae_train_state` of this ``vae`` and ``disc``) in place
    and returns JAX's metrics as floats: ``vae/nll_loss``, ``vae/kl_loss``,
    ``vae/rec_loss``, ``vae/perception_loss``, ``vae/g_loss``,
    ``vae/d_weight``, ``vae/logvar``, ``vae/total_loss``, ``vae/disc_loss``,
    ``vae/logits_real`` and ``vae/logits_fake``. ``draws`` is the run's draw
    source (a ``torch.Generator`` is wrapped in ``GeneratorDraws``).
    ``use_3d_disc``: the discriminator judges whole clips, else each frame.
    ``grads_only=True``: the step returns ``(gen_grads, disc_grads,
    metrics)`` before the clip and changes nothing; ``gen_grads`` is
    ``{"vae": {name: grad}, "logvar": grad}``, ``disc_grads`` ``{name:
    grad}``, as JAX's ``grads_only``. ``is_init=False`` codes each clip as a
    continuation (no lone first frame; ``T % 8 == 0``).

    ``mesh``: a ("dp", "cp") mesh; ``video`` is then this rank's ``T / cp``
    frames of its dp slice, ``is_init`` must be False when cp > 1, and the
    metrics and (averaged) gradients are the global step's on every rank."""
    cp_group, cp, world = None, 1, 1
    if mesh is not None:
        cp, world = mesh.size(mesh.mesh_dim_names.index("cp")), mesh.size()
        if cp > 1 and is_init:
            raise ValueError("context-parallel training codes continuation "
                             "clips: pass is_init=False (T % (8 cp) == 0)")
        cp_group = mesh.get_group("cp") if cp > 1 else None
    dp = world // cp

    def mean_all(t: torch.Tensor) -> torch.Tensor:
        """The mean over every rank of a per-rank value (itself alone)."""
        if mesh is None:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t / world

    def disc_input(x):
        if not use_3d_disc:
            return _flatten_t(x)
        return x if cp == 1 else gather_time(x, cp_group)

    def autocast(device):
        if compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=compute_dtype)

    def nll_of(recon, video, logvar, cfg):
        x, y = _flatten_t(video), _flatten_t(recon)
        rec = (x.float() - y.float()).square().mean(dim=(1, 2, 3),
                                                    keepdim=True)
        p = lpips(x, y)  # [N, 1, 1, 1], fp32
        nll = cfg.pixel_weight * rec + cfg.perceptual_weight * p
        nll = nll / logvar.exp() + logvar
        return nll.sum() / nll.shape[0], rec.mean(), p.mean()

    def latent_noise(video, draws):
        """Drawn at the global latent shape and cut to this rank's shard,
        so the sharded step draws what the global one does."""
        ds = vae.config.downsample_scale
        b, t, h, w, _ = video.shape
        shape = (b * dp, (t * cp - 1) // ds + 1, h // ds, w // ds,
                 vae.config.latent_channels)
        noise = draws.normal(shape)
        if mesh is not None:
            d, c = mesh.get_coordinate()
            tl = shape[1] // cp
            noise = noise[d * b:(d + 1) * b, c * tl:(c + 1) * tl]
        return noise.to(video.device)

    def gan_grads(state: VAETrainState, video: torch.Tensor, draws):
        if state.vae is not vae or state.disc is not disc:
            raise ValueError("the state was not created over this step's "
                             "vae and disc")
        cfg = state.config
        if isinstance(draws, torch.Generator):
            draws = GeneratorDraws(draws)
        disc_on = state.step >= cfg.disc_start
        noise = latent_noise(video, draws.fold_in(state.step))
        w_last = vae.decoder.conv_out.conv.weight
        gen_params, disc_params = state.gen_params, list(disc.parameters())

        # ---------------- generator ----------------
        # per rank: its frames' means (nll, g_loss), its clips' KL sums over
        # its frames; the global values are their means over the ranks (the
        # KL's sum over cp)
        with autocast(video.device), cp_context(cp_group):
            moments = vae.encode(video, is_init=is_init)
            if freeze_encoder:
                moments = moments.detach()
            feats = vae.decode_features(gaussian_sample(moments, noise),
                                        is_init=is_init)
            recon = vae.decoder.conv_out(feats).permute(0, 2, 3, 4, 1)
            nll, rec_m, p_m = nll_of(recon, video, state.logvar, cfg)
            kl = gaussian_kl(moments).mean()
            g_loss = -disc(disc_input(recon)).float().mean()
        loss = nll + cfg.kl_weight * cp * kl
        d_weight = torch.zeros((), device=video.device)
        if disc_on:
            g_nll, = torch.autograd.grad(nll, w_last, retain_graph=True)
            g_g, = torch.autograd.grad(g_loss, w_last, retain_graph=True)
            d_weight = ((_norm(mean_all(g_nll))
                         / (_norm(mean_all(g_g)) + 1e-4)).clamp(0.0, 1e4)
                        * cfg.disc_weight)
            loss = loss + d_weight * g_loss
        gen_grads = [mean_all(g) for g in _grads(loss, gen_params)]

        # -------------- discriminator --------------
        fake = disc_input(recon.detach())
        with torch.set_grad_enabled(disc_on), autocast(video.device):
            logits_real = disc(disc_input(video)).float()
            logits_fake = disc(fake).float()
            d_loss = 0.5 * (F.relu(1.0 - logits_real).mean()
                            + F.relu(1.0 + logits_fake).mean())
        if disc_on:
            disc_grads = [mean_all(g) for g in _grads(d_loss, disc_params)]
        else:
            disc_grads = [torch.zeros_like(p) for p in disc_params]

        nll, kl, g_loss = mean_all(nll), mean_all(kl) * cp, mean_all(g_loss)
        metrics = {
            "vae/nll_loss": nll, "vae/kl_loss": kl,
            "vae/rec_loss": mean_all(rec_m),
            "vae/perception_loss": mean_all(p_m), "vae/g_loss": g_loss,
            "vae/d_weight": d_weight, "vae/logvar": state.logvar,
            "vae/total_loss": nll + cfg.kl_weight * kl + d_weight * g_loss,
            "vae/disc_loss": mean_all(d_loss),
            "vae/logits_real": mean_all(logits_real.mean()),
            "vae/logits_fake": mean_all(logits_fake.mean())}
        metrics = {k: v.item() for k, v in metrics.items()}
        return gen_grads, disc_grads, metrics

    def step(state: VAETrainState, video: torch.Tensor, draws):
        gen_grads, disc_grads, metrics = gan_grads(state, video, draws)
        if grads_only:
            names = [n for n, _ in vae.named_parameters()]
            return ({"vae": dict(zip(names, gen_grads[:-1])),
                     "logvar": gen_grads[-1]},
                    dict(zip([n for n, _ in disc.named_parameters()],
                             disc_grads)), metrics)
        cfg = state.config
        _apply(state.gen_optimizer, state.gen_params, gen_grads,
               cfg.max_grad_norm)
        _apply(state.disc_optimizer, list(disc.parameters()), disc_grads,
               cfg.max_grad_norm)
        state.step += 1
        return metrics

    return step
