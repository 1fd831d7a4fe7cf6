"""Training state: step count, model, optimizer and lr schedule
(counterpart of ``nerf_downstream_tpu/train/state.py``). The model holds
the parameters and the BatchNorm running statistics; the optimizer holds
its momentum buffers."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable | None = None

    def lr(self, base_lr: float) -> float:
        """The lr of the update at ``step`` (the count before it)."""
        return float(self.schedule(self.step)) if self.schedule else base_lr
