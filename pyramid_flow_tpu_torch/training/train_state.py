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

Under FSDP2 (``parallel.mesh.param_sharding``) the parameters, gradients,
optimizer moments and EMA are DTensor shards: the global norm is the whole
model's (a DTensor norm made full), and ``state_dict``/``load_state_dict``
gather to and scatter from the one-device layout, so a checkpoint moves
between world sizes. ``save_sharded``/``load_sharded`` write and read a
``torch.distributed.checkpoint`` directory instead (the counterpart of the
JAX package's Orbax checkpoints): each rank writes its own shards, and the
directory loads at any mesh, or on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..utils.profiling import span

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


def _is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of all tensors together, a 0-dim tensor; of the
    whole tensors where they are DTensor shards."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    total = torch.linalg.vector_norm(torch.stack(norms))
    return total.full_tensor() if _is_sharded(total) else total


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> float:
    """optax's ``clip_by_global_norm``, in place: ``g * max_norm / |g|``
    when ``|g| >= max_norm``. Returns the norm before the clip."""
    with span("train.sync", read="clip_norm"):
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

    @property
    def sharded(self) -> bool:
        """Whether the parameters are FSDP2 shards."""
        return any(_is_sharded(p) for p in self.model.parameters())

    def state_dict(self) -> dict:
        """The one-device layout. Sharded, this is a collective: every rank
        calls it, and rank 0 receives the whole state on the CPU (the
        others an empty params, optimizer and EMA)."""
        if not self.sharded:
            return {"step": self.step, "opt_count": self.opt_count,
                    "params": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "ema": self.ema}
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict, get_optimizer_state_dict)
        opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
        params = get_model_state_dict(self.model, options=opts)
        optim = get_optimizer_state_dict(self.model, self.optimizer,
                                         options=opts)
        ema = {n: t.full_tensor().cpu() if _is_sharded(t) else t.cpu()
               for n, t in self.ema.items()}
        if torch.distributed.get_rank() != 0:
            return {"step": self.step, "opt_count": self.opt_count,
                    "params": {}, "optimizer": {}, "ema": {}}
        return {"step": self.step, "opt_count": self.opt_count,
                "params": params, "ema": ema,
                "optimizer": self._by_index(optim)}

    def inference_tensors(self, use_ema: bool = False
                          ) -> Iterator[Tuple[str, torch.Tensor]]:
        """(name, tensor) of every parameter, or of its EMA, whole, then of
        the model's persistent buffers: what the model's state dict holds.
        Sharded, a collective (each tensor is all-gathered as it comes):
        every rank iterates in step and receives the whole tensors. Nothing
        of the state changes."""
        params = self.params
        src = self.ema if use_ema else {n: p.detach()
                                        for n, p in params.items()}
        for name, t in src.items():
            yield name, t.full_tensor() if _is_sharded(t) else t
        for name, t in self.model.state_dict().items():
            if name not in params:
                yield name, t

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The inference weights: the EMA of every parameter and the
        persistent buffers, keyed like ``model.state_dict()``. Sharded, a
        collective: rank 0 receives the whole tensors on the CPU, the
        others an empty dict."""
        if not self.sharded:
            return dict(self.inference_tensors(use_ema=True))
        out = {n: t.cpu() for n, t in self.inference_tensors(use_ema=True)}
        return out if torch.distributed.get_rank() == 0 else {}

    def _dcp_state(self) -> dict:
        """The state as ``torch.distributed.checkpoint`` saves and loads it:
        the model's and the optimizer's state dicts keyed by parameter name
        (DTensor shards where sharded), the EMA, and (step, opt_count)."""
        from torch.distributed.checkpoint.state_dict import get_state_dict
        model, optim = get_state_dict(self.model, self.optimizer)
        return {"model": model, "optim": optim, "ema": dict(self.ema),
                "counts": torch.tensor([self.step, self.opt_count])}

    def save_sharded(self, path: str) -> None:
        """Write the state to the directory ``path`` with
        ``torch.distributed.checkpoint``: each rank its own shards, nothing
        gathered. Sharded, a collective."""
        import torch.distributed.checkpoint as dcp
        dcp.save(self._dcp_state(), checkpoint_id=path)

    def load_sharded(self, path: str) -> None:
        """Restore a :meth:`save_sharded` directory, written at any mesh,
        into this state, sharded or on one device. Sharded, a
        collective."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import set_state_dict
        state = self._dcp_state()
        dcp.load(state, checkpoint_id=path)
        set_state_dict(self.model, self.optimizer,
                       model_state_dict=state["model"],
                       optim_state_dict=state["optim"])
        for name, t in state["ema"].items():
            if t is not self.ema[name]:
                self.ema[name].copy_(t)
        self.step, self.opt_count = (int(c) for c in state["counts"])

    def _param_order(self) -> List[str]:
        """Parameter names in the optimizer's order, the numbering of
        ``optimizer.state_dict()``."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]

    def _by_index(self, optim: dict) -> dict:
        """An optimizer state dict keyed by parameter name -> keyed by the
        optimizer's parameter numbering."""
        index = {n: i for i, n in enumerate(self._param_order())}
        return {"state": {index[n]: v for n, v in optim["state"].items()},
                "param_groups": [{**g, "params": [index[n]
                                                  for n in g["params"]]}
                                 for g in optim["param_groups"]]}

    def load_state_dict(self, state: dict) -> None:
        """Load the one-device layout (sharded: on every rank, each keeping
        its shards)."""
        if self.sharded:
            from torch.distributed.checkpoint.state_dict import (
                StateDictOptions, set_model_state_dict,
                set_optimizer_state_dict)
            from torch.distributed.tensor import distribute_tensor
            opts = StateDictOptions(full_state_dict=True)
            # (copied: the loader replaces the dict's tensors by shards)
            set_model_state_dict(self.model, dict(state["params"]),
                                 options=opts)
            order = self._param_order()
            optim = state["optimizer"]
            set_optimizer_state_dict(self.model, self.optimizer, {
                "state": {order[i]: v for i, v in optim["state"].items()},
                "param_groups": [{**g, "params": [order[i]
                                                  for i in g["params"]]}
                                 for g in optim["param_groups"]]},
                options=opts)
            for name, t in state["ema"].items():
                e = self.ema[name]
                e.copy_(distribute_tensor(t.to(e.device), e.device_mesh,
                                          e.placements))
        else:
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
    no parameter-sized temporaries (also on FSDP2 shards)."""
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
