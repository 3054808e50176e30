"""Train state: global-norm clipping, AdamW, the anomaly gate and the EMA.

The counterpart of the JAX package's ``training/train_state.py`` and its
optax chain, with the same math:

* ``clip_by_global_norm(max_grad_norm)``: ``g * max_norm / |g|`` when
  ``|g| >= max_norm``, optax's formula (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* AdamW with betas (0.9, 0.95), eps 1e-8 and weight decay 1e-4 on
  parameters with ``ndim > 1`` only: ``torch.optim.AdamW`` with two
  parameter groups, which is algebraically optax's update;
* the learning rate read from the schedule at the optimizer's own count,
  which starts at 0 and advances only with applied updates;
* the anomaly gate: when the loss is not finite or not below the threshold,
  neither the parameters nor the optimizer state (and with it the schedule's
  count) change;
* ``step`` advances on every call, and the fp32 EMA ``ema = d * ema + (1 - d)
  * params`` runs every ``ema_interval`` steps of it, gated steps included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

__all__ = ["TrainConfig", "TrainState", "create_train_state", "global_norm",
           "clip_by_global_norm_"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    max_grad_norm: float = 1.0
    anomaly_loss_threshold: float = 2.0
    ema_decay: float = 0.9999
    ema_interval: int = 1
    lr_schedule: Optional[Callable[[int], float]] = None  # None = constant


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of all tensors together, a 0-dim tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> float:
    """optax's ``clip_by_global_norm``, in place: ``g * max_norm / |g|``
    when ``|g| >= max_norm``. Returns the norm before the clip."""
    norm = global_norm(grads).item()
    if not norm < max_norm:
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)
    return norm


class TrainState:
    """``step``, the model's fp32 parameters, the AdamW state and the fp32
    EMA of the parameters (a dict keyed like ``model.state_dict()``)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: Dict[str, torch.Tensor], config: TrainConfig):
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.config = config
        self.step = 0
        self.opt_count = 0  # applied updates: the schedule's step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def learning_rate(self) -> float:
        cfg = self.config
        if cfg.lr_schedule is None:
            return cfg.learning_rate
        return float(cfg.lr_schedule(self.opt_count))

    def apply_gradients(self, grads: Union[Mapping[str, torch.Tensor],
                                           Sequence[torch.Tensor]],
                        loss) -> bool:
        """Clip, gate, update and refresh the EMA. ``grads`` maps parameter
        names to gradients (or lists them in ``named_parameters`` order); they
        are clipped in place. Returns whether the update was applied."""
        cfg = self.config
        params = self.params
        if isinstance(grads, Mapping):
            grads = [grads[name] for name in params]
        grads = list(grads)
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             "parameters")
        loss = float(loss)
        ok = math.isfinite(loss) and loss < cfg.anomaly_loss_threshold
        if ok:
            clip_by_global_norm_(grads, cfg.max_grad_norm)
            for p, g in zip(params.values(), grads):
                p.grad = g
            lr = self.learning_rate()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.opt_count += 1
        self.step += 1
        if self.step % cfg.ema_interval == 0:
            ema = [self.ema[name] for name in params]
            values = [p.detach() for p in params.values()]
            torch._foreach_mul_(ema, cfg.ema_decay)
            torch._foreach_add_(ema, values, alpha=1 - cfg.ema_decay)
        return ok

    def state_dict(self) -> dict:
        return {"step": self.step, "opt_count": self.opt_count,
                "params": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        for name, t in state["ema"].items():
            self.ema[name].copy_(t)
        self.step = int(state["step"])
        self.opt_count = int(state["opt_count"])


def create_train_state(model: nn.Module,
                       config: TrainConfig = TrainConfig()) -> TrainState:
    """AdamW over ``model``'s parameters (weight decay on ``ndim > 1`` only)
    and an fp32 EMA initialised to a copy of them. The parameters must be
    fp32. On CUDA the optimizer uses PyTorch's fused AdamW step, which keeps
    no parameter-sized temporaries."""
    named = list(model.named_parameters())
    for name, p in named:
        if p.dtype != torch.float32:
            raise TypeError(f"parameter {name} is {p.dtype}; training keeps "
                            "fp32 parameters")
    decay = [p for _, p in named if p.ndim > 1]
    no_decay = [p for _, p in named if p.ndim <= 1]
    device = named[0][1].device
    optimizer = torch.optim.AdamW(
        [{"params": decay, "weight_decay": config.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=config.learning_rate, betas=(config.beta1, config.beta2),
        eps=1e-8, fused=device.type == "cuda")
    ema = {name: p.detach().clone() for name, p in named}
    return TrainState(model, optimizer, ema, config)
