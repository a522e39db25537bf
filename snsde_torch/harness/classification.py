"""Sepsis classification harness (counterpart of
snsde/harness/classification.py:44-56, 110-252).

The model name resolves to an (input_option, noise_option) pair of the
7x20 grid; the sepsis model maps the static features to z0 through a
two-layer encoder and reads the NeuralSDE's terminal state out through a
BatchNorm head; training is binary BCE with pos_weight 10, selected on val
AUROC, with the 100x gradient hook on the readout's last linear. The
harness runs on synthetic sepsis-shaped data by default.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.common import preprocess_classification, stratified_split
from ..data.synthetic import synthetic_sepsis
from ..fields import MODEL_NAME_GRID, DiffusionField
from ..models.neuralsde import NeuralSDE
from ..nn.layers import make_linear
from ..train.loop import (FitResult, TrainConfig, fit_classifier,
                          readout_grad_hook)

__all__ = ["parse_model_name", "make_sde_model", "InitialValueModel",
           "HarnessConfig", "run_sepsis"]

_NEURALSDE_RE = re.compile(r"^neuralsde_(\d+)_(\d+)$")


def parse_model_name(name: str) -> Tuple[int, int]:
    """(input_option, noise_option) of a named alias or of the
    `neuralsde_{i}_{j}` DSL."""
    if name in MODEL_NAME_GRID:
        return MODEL_NAME_GRID[name]
    m = _NEURALSDE_RE.match(name)
    if m:
        i, j = int(m.group(1)), int(m.group(2))
        if not (0 <= i <= 6 and 0 <= j <= 19):
            raise ValueError(f"{name}: options out of range (0-6 × 0-19)")
        return i, j
    raise ValueError(f"unknown SDE model name {name!r}")


def make_sde_model(name: str, input_channels: int, hidden_channels: int,
                   hidden_hidden_channels: int, num_hidden_layers: int,
                   output_channels: int, initial: bool = True,
                   method: str = "euler", *,
                   generator: Optional[torch.Generator] = None,
                   device=None):
    """(NeuralSDE, reg_subtree_fn) for any grid model name."""
    io, no = parse_model_name(name)
    field = DiffusionField(input_channels, hidden_channels,
                           hidden_hidden_channels, num_hidden_layers,
                           input_option=io, noise_option=no,
                           generator=generator, device=device)
    model = NeuralSDE(field, input_channels, hidden_channels,
                      output_channels, initial=initial, method=method,
                      generator=generator, device=device)
    return model, (lambda m: m.func)


class InitialValueModel(nn.Module):
    """Static-feature encoder -> z0, then the NeuralSDE."""

    def __init__(self, static_dim: int, hidden_channels: int,
                 sde: NeuralSDE, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.linear1 = make_linear(static_dim, 256, generator=generator,
                                   device=device)
        self.linear2 = make_linear(256, hidden_channels, generator=generator,
                                   device=device)
        self.sde = sde

    def forward(self, times, coeffs, static, final_index, *,
                generator=None, **kw):
        z0 = self.linear2(torch.relu(self.linear1(static)))
        return self.sde(times, coeffs, final_index, generator=generator,
                        z0=z0, **kw)


@dataclass
class HarnessConfig:
    model_name: str = "neurallnsde"
    hidden_channels: int = 49
    hidden_hidden_channels: int = 49
    num_hidden_layers: int = 2
    lr: float = 1e-3
    batch_size: int = 1024
    max_epochs: int = 200
    use_intensity: bool = True
    method: str = "euler"
    seed: int = 0
    # seed of the dataset draw and split; defaults to `seed`
    data_seed: Optional[int] = None

    @property
    def dseed(self) -> int:
        return self.seed if self.data_seed is None else self.data_seed


def build_sepsis_model(cfg: HarnessConfig, input_channels: int,
                       static_dim: int, device) -> InitialValueModel:
    """The sepsis model, drawn on the CPU from a generator seeded with
    cfg.seed (the same weights on every device), then moved to `device`."""
    gen = torch.Generator().manual_seed(cfg.seed)
    sde, _ = make_sde_model(
        cfg.model_name, input_channels, cfg.hidden_channels,
        cfg.hidden_hidden_channels, cfg.num_hidden_layers,
        output_channels=1, initial=False, method=cfg.method, generator=gen)
    model = InitialValueModel(static_dim, cfg.hidden_channels, sde,
                              generator=gen)
    return model.to(device)


def run_sepsis(cfg: HarnessConfig = HarnessConfig(), n: int = 4096,
               data_fn: Callable = synthetic_sepsis,
               max_epochs: Optional[int] = None,
               device=None) -> FitResult:
    """Sepsis classification: binary, AUROC-selected, static -> z0. Runs on
    CUDA unless `device` says otherwise."""
    dev = resolve_device(device)
    X, static, y, lengths, _ = data_fn(n=n, seed=cfg.dseed)
    data = preprocess_classification(
        X, y, lengths, use_intensity=cfg.use_intensity, seed=cfg.dseed,
        times=np.arange(X.shape[1], dtype=np.float32))
    tr, va, te = data["train"], data["val"], data["test"]
    for split, idx in zip((tr, va, te), stratified_split(y, seed=cfg.dseed)):
        split["static"] = static[idx]

    model = build_sepsis_model(cfg, data["input_channels"], static.shape[-1],
                               dev)
    times = data["times"]

    def apply_fn(m, batch, generator):
        logits = m(times, batch["coeffs"], batch["static"],
                   batch["final_index"], generator=generator)
        return logits[..., 0]

    tc = TrainConfig(lr=cfg.lr, batch_size=cfg.batch_size,
                     max_epochs=max_epochs or cfg.max_epochs, num_classes=2,
                     pos_weight=10.0, step_mode="valauc", seed=cfg.seed)
    return fit_classifier(model, apply_fn, lambda m: m.sde.func, tr, va, te,
                          tc, grad_hook=readout_grad_hook("sde.readout.linear2"))
