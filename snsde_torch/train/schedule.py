"""Host-side learning-rate schedules (counterpart of
snsde/train/schedule.py:19-80).

`ReduceLROnPlateau` is a copy of the JAX package's logic rather than
`torch.optim.lr_scheduler.ReduceLROnPlateau`, so the two packages cut the
rate on the same epochs; the training loop writes the rate it returns into
the optimizer's parameter group. `StepLR` (the robustness harness's)
multiplies the rate by gamma every step_size calls of `step`.
`CosineAnnealingLR` (the interpolation harness's) is the closed form
eta_min + (base - eta_min)(1 + cos(pi epoch / t_max)) / 2 of the epoch
count, which keeps going past t_max as JAX's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["ReduceLROnPlateau", "StepLR", "CosineAnnealingLR"]


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"           # 'min' (loss) or 'max' (accuracy/AUROC)
    factor: float = 0.1
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=None)  # type: ignore
    num_bad: int = 0

    def __post_init__(self):
        if self.best is None:
            self.best = math.inf if self.mode == "min" else -math.inf

    def _improved(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr


@dataclass
class StepLR:
    lr: float
    step_size: int = 10
    gamma: float = 0.5
    epoch: int = 0

    def step(self, metric: float = None) -> float:
        self.epoch += 1
        if self.epoch % self.step_size == 0:
            self.lr *= self.gamma
        return self.lr


@dataclass
class CosineAnnealingLR:
    lr: float
    t_max: int
    eta_min: float = 0.0
    epoch: int = 0
    base_lr: float = field(default=None)  # type: ignore

    def __post_init__(self):
        if self.base_lr is None:
            self.base_lr = self.lr

    def step(self, metric: float = None) -> float:
        self.epoch += 1
        self.lr = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / self.t_max))
        return self.lr
