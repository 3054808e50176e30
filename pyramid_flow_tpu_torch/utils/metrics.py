"""Training metrics: windowed smoothing and step logging.

The port's copy of the JAX package's numpy-only ``utils/metrics.py`` (the
port imports nothing of that package). ``SmoothedValue``/``MetricLogger``
follow the reference's ``trainer_misc/utils.py:253-396``: windowed
median/avg semantics, optional TensorBoard and wandb scalars, and a JSON-lines
epoch log (the reference's ``log.txt``).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = ["SmoothedValue", "MetricLogger"]


class SmoothedValue:
    """Track a series with a window median/avg and global stats."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def median(self):
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self):
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.window) if self.window else 0.0

    @property
    def value(self):
        return self.window[-1] if self.window else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class MetricLogger:
    """Windowed metric aggregation + periodic printing + JSONL epoch log +
    optional TensorBoard scalars (reference uses tensorboardX/accelerator.log,
    `trainer_misc/fsdp_trainer.py:130`)."""

    def __init__(self, delimiter: str = "  ", log_file: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None, print_fn=print,
                 wandb_project: Optional[str] = None,
                 wandb_config: Optional[dict] = None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log_file = log_file
        self.print_fn = print_fn
        # scalar sinks (reference: tensorboardX via accelerator.log,
        # `trainer_misc/fsdp_trainer.py:130`; wandb optional,
        # `train/train_pyramid_flow.py:332-335`). torch's SummaryWriter is
        # in the base image; tensorflow is the fallback; both degrade to
        # JSONL-only with a notice rather than failing the run.
        self._tb = self._tb_kind = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
                self._tb_kind = "torch"
            except Exception:
                try:
                    import tensorflow as tf
                    self._tb = tf.summary.create_file_writer(tensorboard_dir)
                    self._tb_kind = "tf"
                except Exception:
                    print_fn("MetricLogger: no tensorboard writer available; "
                             "scalars go to JSONL only")
        self._wandb = None
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project,
                                         config=wandb_config or {})
            except Exception:
                print_fn("MetricLogger: wandb unavailable; skipping")

    def update(self, step: Optional[int] = None, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v)
        if step is None:
            return
        if self._tb_kind == "torch":
            for k, v in kwargs.items():
                self._tb.add_scalar(k, float(v), step)
        elif self._tb_kind == "tf":
            import tensorflow as tf
            with self._tb.as_default():
                for k, v in kwargs.items():
                    tf.summary.scalar(k, float(v), step=step)
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in kwargs.items()},
                            step=step)

    def __getattr__(self, name):
        if name in ("meters", "delimiter", "log_file", "print_fn"):
            raise AttributeError(name)
        return self.meters[name]

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Wrap an iterable: yields items, prints meters + timing stats
        (reference log_every :352-396)."""
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                msg = (f"{header} [{i}"
                       + (f"/{total}" if total else "") + "]  "
                       + str(self)
                       + f"  iter_t: {iter_time}  data_t: {data_time}")
                self.print_fn(msg)
            end = time.time()
        self.print_fn(f"{header} done in {time.time()-start:.1f}s")

    def write_epoch_log(self, epoch: int, extra: Optional[dict] = None):
        """Append one JSON line per epoch (reference log.txt,
        `train/train_pyramid_flow.py:596-598`)."""
        if not self.log_file:
            return
        entry = {f"train_{k}": m.global_avg for k, m in self.meters.items()}
        entry["epoch"] = epoch
        if extra:
            entry.update(extra)
        os.makedirs(os.path.dirname(self.log_file) or ".", exist_ok=True)
        with open(self.log_file, "a") as f:
            f.write(json.dumps(entry) + "\n")
