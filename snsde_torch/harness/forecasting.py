"""MuJoCo forecasting harness (counterpart of snsde/harness/forecasting.py:
34-277).

Windows of 50 input rows -> 10 target rows (14 channels), an optional time
channel, natural cubic spline coefficients of the inputs, a sequential
70/15/15 split, and `NeuralSDEForecasting` trained on MSE or Huber plus an
L1/L2 penalty on the vector field, with coupled-L2 Adam (weight decay
1e-5), ReduceLROnPlateau on the val or train MSE, a best-val restore and
the plateau-terminate rule, all with the reference's 1.0001 improvement
factor.

Two choices follow the JAX package, not the reference's smaller last batch
(ROADMAP Queue 3): the last partial batch is padded by wrap-around to the
full batch, and the training loss is the plain mean over the padded batch,
with no mask; an evaluation weighs each padded batch's mean MSE by its
count of valid rows.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.common import inject_missingness
from ..data.mujoco import get_data
from ..fields import DiffusionField
from ..models.neuralsde import NeuralSDEForecasting
from ..ops.interp import natural_cubic_coeffs
from ..train.loop import iterate_batches, train_step, weight_regularization
from ..train.schedule import ReduceLROnPlateau
from .classification import parse_model_name

__all__ = ["ForecastConfig", "run_mujoco", "make_forecast_model",
           "resolve_sde_method"]


def resolve_sde_method(method: str) -> str:
    """rk4 is not an SDE method and maps to euler; the SDE methods are
    euler, srk, milstein and heun (euler and srk through the EM and SRK
    kernels on the card, milstein and heun through the eager sdeint, as
    the JAX package solves them)."""
    if method == "rk4":
        return "euler"
    if method not in ("euler", "srk", "milstein", "heun"):
        raise ValueError(f"unsupported SDE method {method!r}")
    return method


def make_forecast_model(name: str, input_channels: int, hidden_channels: int,
                        hidden_hidden_channels: int, num_hidden_layers: int,
                        output_channels: int, output_time: int,
                        method: str = "euler", *,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """(NeuralSDEForecasting, reg_subtree_fn) for any grid model name."""
    io, no = parse_model_name(name)
    field = DiffusionField(input_channels, hidden_channels,
                           hidden_hidden_channels, num_hidden_layers,
                           input_option=io, noise_option=no,
                           generator=generator, device=device)
    model = NeuralSDEForecasting(field, input_channels, hidden_channels,
                                 output_channels, output_time=output_time,
                                 method=resolve_sde_method(method),
                                 generator=generator, device=device)
    return model, (lambda m: m.func)


@dataclass
class ForecastConfig:
    """The reference CLI's defaults: lr 1e-4, Adam weight_decay 1e-5
    (coupled L2), mse + l2 penalty 0.01, ReduceLROnPlateau(patience=5) on
    the val loss, plateau-terminate 50, a time channel (--intensity)."""

    model_name: str = "neurallnsde"
    hidden_channels: int = 16
    hidden_hidden_channels: int = 16
    num_hidden_layers: int = 1
    lr: float = 1e-4
    weight_decay: float = 1e-5
    batch_size: int = 1024
    max_epochs: int = 100
    time_seq: int = 50
    y_seq: int = 10
    missing_rate: float = 0.0
    loss: str = "mse"            # mse | huber
    reg: str = "l2"              # none | l1 | l2
    reg_scale: float = 0.01
    method: str = "euler"
    step_mode: str = "valloss"   # valloss | trainloss | none
    time_augment: bool = True
    plateau_patience: int = 5
    plateau_terminate: int = 50
    npy_path: Optional[str] = None   # None: synthetic windows
    seed: int = 0
    verbose: bool = True


def _base_loss(kind: str) -> Callable:
    if kind == "mse":
        return lambda p, t: torch.mean((p - t) ** 2)
    if kind == "huber":
        def huber(p, t, delta=1.0):
            d = torch.abs(p - t)
            return torch.mean(torch.where(d <= delta, 0.5 * d * d,
                                          delta * (d - 0.5 * delta)))
        return huber
    raise ValueError(f"unknown loss {kind!r}")


def _penalty(kind: str, scale: float) -> Callable:
    if kind == "l2":
        return lambda field: weight_regularization(field, scale)
    if kind == "l1":
        return lambda field: scale * sum(p.abs().sum()
                                         for p in field.parameters())
    if kind == "none":
        return lambda field: 0.0
    raise ValueError(f"unknown regularisation {kind!r}")


def forecast_coeffs(cfg: ForecastConfig, X_in: np.ndarray,
                    times: np.ndarray) -> np.ndarray:
    """Packed natural cubic coefficients [N, time_seq-1, 4C'] of the input
    windows, with the time channel first when cfg.time_augment."""
    if cfg.time_augment:
        tchan = np.broadcast_to(times[None, :, None], X_in.shape[:2] + (1,))
        X_in = np.concatenate([tchan, X_in], axis=-1)
    return natural_cubic_coeffs(torch.as_tensor(times),
                                torch.as_tensor(X_in), pack=True).numpy()


def run_mujoco(cfg: ForecastConfig = ForecastConfig(), n: int = 2048,
               data_fn: Optional[Callable] = None,
               max_epochs: Optional[int] = None, device=None) -> Dict:
    """Train and evaluate a forecasting model; runs on CUDA unless `device`
    says otherwise. The windows come from data_fn(n=, length=, seed=) ->
    (X [n, time_seq + y_seq, C], t) when given (cfg.missing_rate then
    masks per channel), else from `data.mujoco.get_data` (the trajectory
    bank at cfg.npy_path, or n synthetic windows). Returns {"model",
    "history" (per epoch: train/val/test MSE and the rate), "test_mse"
    (after the best-val restore), "best_val_mse", "steps", "wall_time"}."""
    dev = resolve_device(device)
    if data_fn is not None:
        X, _ = data_fn(n=n, length=cfg.time_seq + cfg.y_seq, seed=cfg.seed)
        X_in = inject_missingness(X[:, :cfg.time_seq], cfg.missing_rate)
        y_out = X[:, cfg.time_seq:]
        times = np.arange(cfg.time_seq, dtype=np.float32)
    else:
        X_in, y_out, times = get_data(
            npy_path=cfg.npy_path, time_seq=cfg.time_seq, y_seq=cfg.y_seq,
            missing_rate=cfg.missing_rate, n_synthetic=n, seed=cfg.seed)
    coeffs = forecast_coeffs(cfg, X_in, times)
    C = X_in.shape[-1]

    # sequential split: windows of one trajectory must not straddle splits
    n_total = X_in.shape[0]
    n_tr, n_va = int(0.7 * n_total), int(0.15 * n_total)
    bounds = {"train": (0, n_tr), "val": (n_tr, n_tr + n_va),
              "test": (n_tr + n_va, n_total)}
    datasets = {k: {"coeffs": torch.as_tensor(coeffs[a:b], device=dev),
                    "y": torch.as_tensor(y_out[a:b], device=dev)}
                for k, (a, b) in bounds.items()}

    gen = torch.Generator().manual_seed(cfg.seed)
    model, reg_fn = make_forecast_model(
        cfg.model_name, C + int(cfg.time_augment), cfg.hidden_channels,
        cfg.hidden_hidden_channels, cfg.num_hidden_layers,
        output_channels=C, output_time=cfg.y_seq, method=cfg.method,
        generator=gen)
    model = model.to(dev)
    base = _base_loss(cfg.loss)
    penalty = _penalty(cfg.reg, cfg.reg_scale)

    def loss_fn(m, batch, generator):
        pred = m(times, batch["coeffs"], generator=generator)
        return base(pred, batch["y"]) + penalty(reg_fn(m)), pred

    # torch.optim.Adam(weight_decay=) adds wd * p to the gradient before the
    # moments: the reference's coupled L2
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 weight_decay=cfg.weight_decay)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    rng = np.random.default_rng(cfg.seed)

    def evaluate(data) -> float:
        model.eval()
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        cnt = 0
        with torch.no_grad():
            for batch, nv in iterate_batches(data, cfg.batch_size):
                pred = model(times, batch["coeffs"], generator=generator)
                tot += torch.mean((pred - batch["y"]) ** 2).double() * nv
                cnt += nv
        model.train()
        return float(tot) / cnt

    sched = ReduceLROnPlateau(lr=cfg.lr, mode="min",
                              patience=cfg.plateau_patience)
    lr = cfg.lr
    history = []
    best_val, best_train, best_train_epoch = np.inf, np.inf, 0
    best_state = copy.deepcopy(model.state_dict())
    steps = 0
    t0 = time.time()
    for epoch in range(max_epochs or cfg.max_epochs):
        for batch, _ in iterate_batches(datasets["train"], cfg.batch_size,
                                        rng=rng):
            train_step(model, optimizer, loss_fn, batch, generator)
            steps += 1
        mses = {k: evaluate(datasets[k]) for k in ("train", "val", "test")}
        if mses["train"] * 1.0001 < best_train:
            best_train, best_train_epoch = mses["train"], epoch
        if mses["val"] * 1.0001 < best_val:
            best_val = mses["val"]
            best_state = copy.deepcopy(model.state_dict())
        metric = {"valloss": mses["val"],
                  "trainloss": mses["train"]}.get(cfg.step_mode)
        if metric is not None:
            lr = sched.step(metric)
            for group in optimizer.param_groups:
                group["lr"] = lr
        history.append({"epoch": epoch, "lr": lr, **mses})
        if cfg.verbose:
            print(f"epoch {epoch}: train {mses['train']:.4f} val "
                  f"{mses['val']:.4f} test {mses['test']:.4f} lr {lr:.1e}",
                  flush=True)
        if epoch > best_train_epoch + cfg.plateau_terminate:
            if cfg.verbose:
                print("early stop: training-loss plateau", flush=True)
            break
    wall = time.time() - t0
    model.load_state_dict(best_state)
    return {"model": model, "history": history,
            "test_mse": evaluate(datasets["test"]), "best_val_mse": best_val,
            "steps": steps, "wall_time": wall}
