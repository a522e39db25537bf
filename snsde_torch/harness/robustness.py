"""Robustness-to-missingness sweep (counterpart of
snsde/harness/robustness.py:48-446, the solo loop).

  * `ISTSClassifier`: seq layer (any name `registry.PORTED_NAMES` holds:
    the Neural SDEs, the Neural CDEs and the plain recurrent baselines) ->
    last step -> BatchNorm -> ReLU(fc1) -> fc2, nan_to_num on the logits;
  * `train_ists_model`: softmax cross-entropy, the 100x gradient hook on fc2
    before a global-norm clip at 10 (optax's rule), Adam without weight
    decay, StepLR(10, 0.5) stepped once per epoch, patience-10 early stop
    on val accuracy and a restore of the best model (weights and BatchNorm
    statistics; strictly greater accuracy counts as better);
  * stratified 70/15/15 splits per seed, (x, mask, delta) preprocessing
    with seeded missingness, per-(missing rate, model, seed) JSON records
    with skip-if-exists resume; every exception of a run becomes an
    "error" record, as in the reference sweep;
  * the run's seed drives, as the JAX package's key per run does, the
    initial weights and one generator on the model's device that draws
    the training-time noise (an SDE's Brownian paths, a stacked SeqRNN's
    dropout) in training and evaluation; test predictions draw from their
    own generator of that seed.

Batches follow the JAX package, not the reference's smaller last batch
(ROADMAP Queue 3): the last partial batch is padded by wrap-around, the
training loss is the plain mean over the padded batch (BatchNorm sees the
duplicates), and an evaluation weighs each batch's mean loss by its count
of valid rows. The seed-packed ensemble route (`pack_seeds=True`) is not
ported yet.
"""

from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.common import inject_missingness, stratified_split
from ..data.synthetic import synthetic_uea
from ..nn.layers import BatchNorm, make_linear
from ..ops.interp import hermite_cubic_coeffs, natural_cubic_coeffs
from ..registry import make_seq_layer
from ..train.loop import (iterate_batches, readout_grad_hook,
                          softmax_cross_entropy, train_step)
from ..train.metrics import classification_metrics
from ..train.schedule import StepLR

__all__ = ["ISTSClassifier", "SweepConfig", "coeff_family",
           "preprocess_ists", "make_fixed_splits", "train_ists_model",
           "ists_train_step", "predict_ists", "run_robustness_sweep"]

CLIP_NORM = 10.0


def coeff_family(model_name: str) -> str:
    """The coefficient family a registry model consumes: 'natural' for the
    CDE and ODE-hybrid family, 'hermite' otherwise."""
    if model_name in ("gru-dt", "gru-d", "gru-ode", "ode-rnn", "ncde",
                      "neuralcde", "neuralcde-c", "ancde", "exit"):
        return "natural"
    return "hermite"


def preprocess_ists(X: np.ndarray, missing_rate: float = 0.0,
                    interpolation: str = "hermite", seed: int = 56789):
    """X [B, L, D] -> {"seq" [B, 3, L, D] (x with NaN as 0, mask, delta),
    "coeffs" (packed spline coefficients over time ‖ x, NaN = missing),
    "times" linspace(0, 1, L)}, with seeded missingness."""
    B, L, D = X.shape
    Xm = inject_missingness(X, missing_rate, seed=seed)
    mask = np.isfinite(Xm).astype(np.float32)
    times = np.linspace(0.0, 1.0, L, dtype=np.float32)

    # delta: per-channel time since the last observation
    delta = np.zeros((B, L, D), np.float32)
    dt = np.diff(times, prepend=times[0])
    for l in range(1, L):
        delta[:, l] = dt[l] + (1.0 - mask[:, l - 1]) * delta[:, l - 1]

    x_filled = np.nan_to_num(Xm, nan=0.0).astype(np.float32)
    seq = np.stack([x_filled, mask, delta], axis=1)      # [B, 3, L, D]

    tchan = np.broadcast_to(times[None, :, None], (B, L, 1))
    vals = torch.as_tensor(np.concatenate([tchan, Xm], axis=-1))
    tt = torch.as_tensor(times)
    if interpolation == "hermite":
        coeffs = hermite_cubic_coeffs(tt, vals)
    else:
        coeffs = natural_cubic_coeffs(tt, vals, pack=True)
    return {"seq": seq, "coeffs": coeffs.numpy(), "times": times}


class ISTSClassifier(nn.Module):
    """seq layer -> last-step output -> BatchNorm -> ReLU(fc1) -> fc2.

    forward(seq [B, 3, L, D], coeffs [B, L-1, 4(D+1)]) -> logits [B, K]."""

    def __init__(self, model_name: str, input_dim: int, seq_len: int,
                 hidden_dim: int, num_classes: int,
                 hidden_hidden_dim: Optional[int] = None, num_layers: int = 1,
                 num_hidden_layers: int = 1, method: Optional[str] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.layer = make_seq_layer(model_name, input_dim, seq_len,
                                    hidden_dim, hidden_hidden_dim, num_layers,
                                    num_hidden_layers, method=method,
                                    generator=generator, device=device)
        self.norm = BatchNorm(hidden_dim, device=device)
        self.fc1 = make_linear(hidden_dim, hidden_dim, generator=generator,
                               device=device)
        self.fc2 = make_linear(hidden_dim, num_classes, generator=generator,
                               device=device)

    def forward(self, seq, coeffs, *,
                generator: Optional[torch.Generator] = None,
                use_fused: bool = True):
        out = self.layer(seq, coeffs, generator=generator,
                         use_fused=use_fused)[0][:, -1, :]
        h = torch.relu(self.fc1(self.norm(out)))
        return torch.nan_to_num(self.fc2(h))


def make_fixed_splits(y: np.ndarray, seeds=(0, 1, 2, 3, 4),
                      path: Optional[str] = None):
    """Stratified 70/15/15 per seed, optionally written as JSON."""
    splits = {s: stratified_split(y, seed=s) for s in seeds}
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({str(s): [np.asarray(ix).tolist() for ix in sp]
                       for s, sp in splits.items()}, f)
    return splits


@dataclass
class SweepConfig:
    models: tuple = ("neuralsde_4_17", "neuralcde", "gru")
    missing_rates: tuple = (0.0, 0.3, 0.5, 0.7)
    seeds: tuple = (0,)
    hidden_dim: int = 16
    lr: float = 1e-3
    batch_size: int = 64
    max_epochs: int = 30
    patience: int = 10
    out_dir: str = "out"
    # None -> each model family's default (rk4 for the CDE names)
    method: object = None
    # write the test predictions (y_true, y_pred, logits) as .npz beside
    # each JSON record
    save_preds: bool = False


def ists_train_step(model: ISTSClassifier, optimizer, batch,
                    use_fused: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """One update: cross-entropy over the whole (padded) batch, backward
    (the fc2 hook, when registered, fires here), the global-norm clip at
    CLIP_NORM, Adam. `generator` draws the model's training-time noise (a
    stacked SeqRNN's inter-layer dropout). Returns the loss (no host
    synchronisation)."""

    def loss_fn(m, b, gen):
        logits = m(b["seq"], b["coeffs"], generator=gen, use_fused=use_fused)
        return softmax_cross_entropy(logits, b["y"]), logits

    return train_step(model, optimizer, loss_fn, batch, generator,
                      clip_norm=CLIP_NORM)


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def train_ists_model(model: ISTSClassifier, data: Dict, y: np.ndarray,
                     splits, lr: float = 1e-3, batch_size: int = 64,
                     max_epochs: int = 30, patience: int = 10,
                     verbose: bool = False, seed: int = 0):
    """Train one classifier on its device; returns (the best-val model,
    its test metrics). `seed` seeds the batch order and the generator of
    the model's noise in training and evaluation."""
    device = next(model.parameters()).device
    arrays = {"seq": data["seq"], "coeffs": data["coeffs"],
              "y": y.astype(np.int64)}
    split_data = {name: _to_device({k: v[idx] for k, v in arrays.items()},
                                   device)
                  for name, idx in zip(("train", "val", "test"), splits)}
    num_classes = int(y.max()) + 1
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    hooks = readout_grad_hook("fc2")(model)

    def evaluate(d):
        model.eval()
        logits_all, ys, losses, ns = [], [], [], []
        with torch.no_grad():
            for batch, nv in iterate_batches(d, batch_size):
                lo = model(batch["seq"], batch["coeffs"], generator=gen)
                losses.append(softmax_cross_entropy(lo, batch["y"]) * nv)
                logits_all.append(lo[:nv])
                ys.append(batch["y"][:nv])
                ns.append(nv)
        model.train()
        return classification_metrics(
            torch.cat(ys).cpu().numpy(), torch.cat(logits_all).cpu().numpy(),
            float(torch.stack(losses).sum()) / sum(ns), num_classes)

    sched = StepLR(lr=lr, step_size=10, gamma=0.5)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    best_val, stale = -np.inf, 0
    best_state = copy.deepcopy(model.state_dict())
    for epoch in range(max_epochs):
        for batch, _ in iterate_batches(split_data["train"], batch_size,
                                        rng=rng):
            ists_train_step(model, optimizer, batch, generator=gen)
        for group in optimizer.param_groups:
            group["lr"] = sched.step()
        val_m = evaluate(split_data["val"])
        if verbose:
            print(f"  epoch {epoch}: val acc {val_m.accuracy:.3f}",
                  flush=True)
        if val_m.accuracy > best_val:
            best_val, stale = val_m.accuracy, 0
            best_state = copy.deepcopy(model.state_dict())
        else:
            stale += 1
            if stale >= patience:
                break
    for h in hooks:
        h.remove()
    model.load_state_dict(best_state)
    return model, evaluate(split_data["test"])


def predict_ists(model: ISTSClassifier, data: Dict, y: np.ndarray, idx,
                 batch_size: int = 64, seed: int = 0):
    """Test-split predictions (y_true, y_pred, logits) of a trained
    classifier; an SDE's Brownian paths drawn from a generator of
    `seed` on the model's device."""
    device = next(model.parameters()).device
    d = _to_device({"seq": data["seq"][idx], "coeffs": data["coeffs"][idx]},
                   device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model.eval()
    logits = []
    with torch.no_grad():
        for batch, nv in iterate_batches(d, batch_size):
            logits.append(model(batch["seq"], batch["coeffs"],
                                generator=gen)[:nv])
    logits = torch.cat(logits).cpu().numpy()
    return y.astype(np.int64)[idx], logits.argmax(-1), logits


def run_robustness_sweep(cfg: SweepConfig = SweepConfig(), n: int = 256,
                         data_fn=synthetic_uea,
                         dataset_name: str = "synthetic_uea",
                         verbose: bool = True, pack_seeds: bool = False,
                         device=None,
                         models: Optional[Dict] = None) -> List[Dict]:
    """The sweep loop: missing_rate x model x seed with skip-if-exists
    resume and JSON result records under cfg.out_dir/dataset/rate/; runs
    on CUDA unless `device` says otherwise. The seed drives the split, the
    missingness draw and the initial weights. When `models` is a dict,
    each classifier trained in this call is stored in it under
    (missing_rate, model name, seed)."""
    if pack_seeds:
        raise NotImplementedError(
            "pack_seeds=True (seed-packed ensembles) is not ported yet "
            "(ROADMAP Queue 1 item 11)")
    dev = resolve_device(device)
    X, y, _ = data_fn(n=n)
    results = []
    data_cache: Dict = {}

    def _data(rate, seed, family):
        k = (rate, seed, family)
        if k not in data_cache:
            data_cache[k] = preprocess_ists(X, missing_rate=rate, seed=seed,
                                            interpolation=family)
        return data_cache[k]

    for rate in cfg.missing_rates:
        for model_name in cfg.models:
            for seed in cfg.seeds:
                out_path = os.path.join(cfg.out_dir, dataset_name,
                                        str(int(rate * 100)),
                                        f"{model_name}_{seed}.json")
                if os.path.exists(out_path):            # resume
                    with open(out_path) as f:
                        results.append(json.load(f))
                    continue
                splits = stratified_split(y, seed=seed)
                t0 = time.time()
                try:
                    data = _data(rate, seed, coeff_family(model_name))
                    model = ISTSClassifier(
                        model_name, X.shape[-1], X.shape[1], cfg.hidden_dim,
                        int(y.max()) + 1, method=cfg.method,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
                    model, test_m = train_ists_model(
                        model, data, y, splits, lr=cfg.lr,
                        batch_size=cfg.batch_size, max_epochs=cfg.max_epochs,
                        patience=cfg.patience, seed=seed)
                    if models is not None:
                        models[(rate, model_name, seed)] = model
                    rec = {"dataset": dataset_name, "missing_rate": rate,
                           "model": model_name, "seed": seed,
                           "accuracy": float(test_m.accuracy),
                           "f1_weighted": float(test_m.f1_weighted),
                           "wall_time": time.time() - t0,
                           "method": getattr(model.layer.inner, "method",
                                             None)}
                    if cfg.save_preds:
                        yt, yp, lo = predict_ists(model, data, y, splits[2],
                                                  cfg.batch_size, seed)
                        os.makedirs(os.path.dirname(out_path), exist_ok=True)
                        np.savez(out_path[:-5] + ".npz", y_true=yt,
                                 y_pred=yp, logits=lo)
                except Exception as e:  # the reference sweep's blanket skip
                    rec = {"dataset": dataset_name, "missing_rate": rate,
                           "model": model_name, "seed": seed,
                           "error": repr(e)}
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                with open(out_path, "w") as f:
                    json.dump(rec, f)
                results.append(rec)
                if verbose:
                    print(rec, flush=True)
    return results
