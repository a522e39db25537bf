"""Robustness-to-missingness sweep (counterpart of
snsde/harness/robustness.py:48-720: the solo loop and the seed-packed
ensembles).

  * `ISTSClassifier`: seq layer (any registry name: the Neural SDEs, the
    LatentSDE, the Neural CDEs and RDEs, ANCDE, EXIT, LEAP, the neural
    flows, the recurrent and ODE-RNN baselines, mTAN, SAnD, MIAM, the
    convolutions and the transformer) -> last step -> BatchNorm ->
    ReLU(fc1) -> fc2, nan_to_num on the logits; the LatentSDE's layer also
    gives its KL term, and LEAP's its divergence term;
  * `train_ists_model`: softmax cross-entropy (plus kl_weight x the
    layer's auxiliary term for the LatentSDE names and `leap`, in training
    and evaluation, as the JAX loss :186-191), the 100x gradient hook on
    fc2
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
of valid rows.

`pack_seeds=True` trains a cell's seeds of an SDE grid name, `neuralcde`
or `gru-ode` at once as an `ISTSSeedEnsembleSDE` (`train_ists_ensemble`):
each seed its own split, missingness and control path; the SDE members'
solve one member-axis launch on CUDA (models/ensemble.py), the CDE
members' (FinalTanh, GRU-ODE) one launch of the member-axis CDE kernels.
It follows the JAX package's ensemble trainer: member k's batches in the
order of numpy's default_rng(k), each member's masked mean loss, a shared
StepLR decay, per-member early stop and restore; a member that stopped
keeps its parameters and BatchNorm statistics while its Adam state
advances.
"""

from __future__ import annotations

import copy
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.common import inject_missingness, stratified_split
from ..data.synthetic import synthetic_uea
from ..models.ensemble import packed_cde_solve, packed_solve
from ..models.neuralcde import NeuralCDEStream, _build_path
from ..models.neuralsde import resolve_dt
from ..nn.layers import BatchNorm, make_linear
from ..ops.interp import (CubicPath, hermite_cubic_coeffs,
                          natural_cubic_coeffs)
from ..registry import make_seq_layer
from ..train.ensemble_loop import ensemble_step, member_generators
from ..train.loop import (_padded_grid, iterate_batches, readout_grad_hook,
                          softmax_cross_entropy, train_step)
from ..train.metrics import classification_metrics
from ..train.schedule import StepLR

__all__ = ["ISTSClassifier", "SweepConfig", "coeff_family",
           "preprocess_ists", "make_fixed_splits", "train_ists_model",
           "ists_loss", "ists_train_step", "predict_ists",
           "run_robustness_sweep", "ISTSSeedEnsembleSDE",
           "train_ists_ensemble"]

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
                use_fused: bool = True, with_aux: bool = False):
        """logits [B, K]; with `with_aux`, (logits, the layer's aux: the
        LatentSDE's KL term or LEAP's divergence term, else None)."""
        res = self.layer(seq, coeffs, generator=generator,
                         use_fused=use_fused)
        h = torch.relu(self.fc1(self.norm(res[0][:, -1, :])))
        logits = torch.nan_to_num(self.fc2(h))
        if with_aux:
            return logits, res[2] if len(res) == 3 else None
        return logits


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
    # the auxiliary term's weight in the loss of the LatentSDE names (their
    # KL) and of leap (its divergence)
    kl_weight: float = 1e-4
    # None -> each model family's default (rk4 for the CDE names)
    method: object = None
    # write the test predictions (y_true, y_pred, logits) as .npz beside
    # each JSON record
    save_preds: bool = False


def ists_loss(model: ISTSClassifier, batch, generator=None,
              use_fused: bool = True, kl_weight: float = 1e-4):
    """(cross-entropy over the batch + kl_weight x the layer's auxiliary
    term when it has one: the LatentSDE's KL, LEAP's divergence, logits)."""
    logits, aux = model(batch["seq"], batch["coeffs"], generator=generator,
                        use_fused=use_fused, with_aux=True)
    loss = softmax_cross_entropy(logits, batch["y"])
    if aux is not None:
        loss = loss + kl_weight * aux
    return loss, logits


def ists_train_step(model: ISTSClassifier, optimizer, batch,
                    use_fused: bool = True,
                    generator: Optional[torch.Generator] = None,
                    kl_weight: float = 1e-4) -> torch.Tensor:
    """One update: cross-entropy over the whole (padded) batch (plus the
    weighted auxiliary term of a LatentSDE or LEAP), backward (the fc2
    hook, when registered, fires here), the global-norm clip at
    CLIP_NORM, Adam. `generator` draws the model's training-time noise (an
    SDE's Brownian paths, dropout masks, the probes of EXIT and LEAP,
    mTAN's sample). Returns the loss (no host synchronisation)."""

    def loss_fn(m, b, gen):
        return ists_loss(m, b, gen, use_fused, kl_weight)

    return train_step(model, optimizer, loss_fn, batch, generator,
                      clip_norm=CLIP_NORM)


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def train_ists_model(model: ISTSClassifier, data: Dict, y: np.ndarray,
                     splits, lr: float = 1e-3, batch_size: int = 64,
                     max_epochs: int = 30, patience: int = 10,
                     verbose: bool = False, seed: int = 0,
                     kl_weight: float = 1e-4):
    """Train one classifier on its device; returns (the best-val model,
    its test metrics). `seed` seeds the batch order and the generator of
    the model's noise in training and evaluation; `kl_weight` weighs a
    LatentSDE's KL term or LEAP's divergence term in the loss."""
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
                loss, lo = ists_loss(model, batch, gen, kl_weight=kl_weight)
                losses.append(loss * nv)
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
            ists_train_step(model, optimizer, batch, generator=gen,
                            kl_weight=kl_weight)
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
    (missing_rate, model name, seed). With pack_seeds a cell's pending
    seeds of an SDE grid name, `neuralcde` or `gru-ode` train as one
    ISTSSeedEnsembleSDE (train_ists_ensemble, seeded by the first of them;
    the other models keep the solo loop); an exception there writes an
    error record for each seed whose record it has not written."""
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

    def _write(rec, out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f)
        results.append(rec)
        if verbose:
            print(rec, flush=True)

    for rate in cfg.missing_rates:
        for model_name in cfg.models:
            pending = []
            for seed in cfg.seeds:
                out_path = os.path.join(cfg.out_dir, dataset_name,
                                        str(int(rate * 100)),
                                        f"{model_name}_{seed}.json")
                if os.path.exists(out_path):            # resume
                    with open(out_path) as f:
                        results.append(json.load(f))
                    continue
                pending.append((seed, out_path))
            if (pack_seeds and len(pending) > 1
                    and (_SDE_GRID_RE.match(model_name)
                         or model_name in ("neuralcde", "gru-ode"))):
                _packed_cell(cfg, X, y, _data, model_name, rate, pending,
                             dataset_name, dev, models, _write)
                continue
            for seed, out_path in pending:
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
                        patience=cfg.patience, seed=seed,
                        kl_weight=cfg.kl_weight)
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
                _write(rec, out_path)
    return results


_SDE_GRID_RE = re.compile(r"^neuralsde_\d+_\d+$")


def _packed_cell(cfg, X, y, data_of, model_name, rate, pending,
                 dataset_name, dev, models, write) -> None:
    """One cell's pending seeds as one ISTSSeedEnsembleSDE
    (robustness.py:344-399): records as the solo loop's, with `packed`,
    the members' count; an exception writes an error record for every
    seed whose record was not written yet."""
    seeds = [s for s, _ in pending]
    t0 = time.time()
    written = set()
    try:
        datas = [data_of(rate, s, coeff_family(model_name)) for s in seeds]
        splits_list = [stratified_split(y, seed=s) for s in seeds]
        model = ISTSSeedEnsembleSDE.create(
            model_name, X.shape[-1], X.shape[1], cfg.hidden_dim,
            int(y.max()) + 1, len(seeds), method=cfg.method,
            generator=torch.Generator().manual_seed(seeds[0])).to(dev)
        model, test_ms = train_ists_ensemble(
            model, datas, y, splits_list, lr=cfg.lr,
            batch_size=cfg.batch_size, max_epochs=cfg.max_epochs,
            patience=cfg.patience, seed=seeds[0])
        wall = time.time() - t0
        for k, ((seed, out_path), tm) in enumerate(zip(pending, test_ms)):
            if models is not None:
                models[(rate, model_name, seed)] = model.members[k]
            if cfg.save_preds:
                yt, yp, lo = predict_ists(model.members[k], datas[k], y,
                                          splits_list[k][2], cfg.batch_size,
                                          seed)
                os.makedirs(os.path.dirname(out_path), exist_ok=True)
                np.savez(out_path[:-5] + ".npz", y_true=yt, y_pred=yp,
                         logits=lo)
            write({"dataset": dataset_name, "missing_rate": rate,
                   "model": model_name, "seed": seed,
                   "accuracy": float(tm.accuracy),
                   "f1_weighted": float(tm.f1_weighted),
                   "wall_time": wall / len(seeds), "packed": len(seeds),
                   "method": model.method}, out_path)
            written.add(out_path)
    except Exception as e:  # the reference sweep's blanket skip
        for seed, out_path in pending:
            if out_path not in written:
                write({"dataset": dataset_name, "missing_rate": rate,
                       "model": model_name, "seed": seed,
                       "error": repr(e)}, out_path)


class ISTSSeedEnsembleSDE(nn.Module):
    """K seeds of one `neuralsde_{i}_{jj}`, `neuralcde` or `gru-ode`
    classifier (robustness.py:454-540), each member an ISTSClassifier
    with its own control path (the seed changes the split and the
    missingness, so members see different data). The SDE members' solve
    is one member-axis launch on CUDA (`packed_solve` with per-member
    paths), the CDE members' too (`packed_cde_solve`); the heads run per
    member. The head draws no dropout.

    forward(seqs [K, B, 3, L, D], coeffs [K, B, L-1, 4C], *, generators)
    -> logits [K, B, classes]."""

    def __init__(self, members):
        super().__init__()
        self.members = nn.ModuleList(members)
        # the members' stream solver (srk for the SDE names by default)
        self.method = self.members[0].layer.inner.method

    @classmethod
    def create(cls, model_name: str, input_dim: int, seq_len: int,
               hidden_dim: int, num_classes: int, n_members: int,
               hidden_hidden_dim: Optional[int] = None, num_layers: int = 1,
               num_hidden_layers: int = 1, method: Optional[str] = None, *,
               generator: Optional[torch.Generator] = None, device=None
               ) -> "ISTSSeedEnsembleSDE":
        """K members of one name and width, drawn one after another from
        `generator` (the sweep's packed cell)."""
        return cls([ISTSClassifier(model_name, input_dim, seq_len,
                                   hidden_dim, num_classes, hidden_hidden_dim,
                                   num_layers, num_hidden_layers,
                                   method=method, generator=generator,
                                   device=device)
                    for _ in range(n_members)])

    @property
    def n_members(self) -> int:
        return len(self.members)

    def member(self, k: int) -> nn.Module:
        return self.members[k]

    def forward(self, seqs, coeffs, *,
                generators: Sequence[torch.Generator],
                use_fused: bool = True):
        K, L = self.n_members, seqs.shape[3]
        times = np.linspace(0.0, 1.0, L).astype(np.float32)
        streams = [m.layer.inner for m in self.members]
        cde = isinstance(streams[0], NeuralCDEStream)
        paths = [_build_path(coeffs[k], times, streams[k].control) if cde
                 else CubicPath(coeffs[k], times) for k in range(K)]
        y0s = torch.stack([s.initial_network(paths[k].evaluate(
            paths[k].times[0])) for k, s in enumerate(streams)])
        if cde:
            zs = packed_cde_solve([s.func for s in streams], paths[0], times,
                                  y0s, method=self.method,
                                  dt=resolve_dt(times, floor=0.0),
                                  paths=paths, use_fused=use_fused)
        else:
            zs = packed_solve([s.func for s in streams], paths[0], times,
                              y0s, generators, method=self.method,
                              dt=resolve_dt(times), paths=paths)
        logits = []
        for k, m in enumerate(self.members):
            out = streams[k].linear(zs[k].movedim(0, 1))[:, -1, :]
            h = torch.relu(m.fc1(m.norm(out)))
            logits.append(torch.nan_to_num(m.fc2(h)))
        return torch.stack(logits)


def train_ists_ensemble(model: ISTSSeedEnsembleSDE, datas, y: np.ndarray,
                        splits_list, lr: float = 1e-3, batch_size: int = 64,
                        max_epochs: int = 30, patience: int = 10,
                        verbose: bool = False, seed: int = 0, lrs=None):
    """Train K sweep seeds at once (robustness.py:543-720). datas: the K
    members' preprocessed dicts (each seed's missingness); splits_list:
    their (train, val, test) index triples, of equal sizes. Per member, as
    train_ists_model: softmax cross-entropy (its masked mean over the
    batch), the 100x fc2 hook before a global-norm clip at 10 on its own
    gradients, Adam, patience-10 early stop on val accuracy and a restore
    of its best state. The StepLR(10, 0.5) decay is shared; `lrs` gives
    each member its own base rate. Member k's batches follow numpy's
    default_rng(k), as the JAX trainer's; the members' noise comes from
    member_generators(seed). Returns (the model, each member's test
    metrics)."""
    K = model.n_members
    device = next(model.parameters()).device
    lr_base = np.asarray(lrs if lrs is not None else [lr] * K, np.float64)
    if lr_base.shape != (K,):
        raise ValueError("lrs needs one rate per member")
    num_classes = int(y.max()) + 1
    n_tr = len(splits_list[0][0])
    if any(len(sp[0]) != n_tr for sp in splits_list):
        raise ValueError("the members' train splits must be of one size")
    seqs = torch.as_tensor(np.stack([d["seq"] for d in datas]),
                           device=device)
    coeffs = torch.as_tensor(np.stack([d["coeffs"] for d in datas]),
                             device=device)
    ylab = torch.as_tensor(y.astype(np.int64), device=device)
    members = torch.arange(K, device=device)[:, None]
    params = [[p for p in model.member(k).parameters() if p.requires_grad]
              for k in range(K)]
    opts = [torch.optim.Adam(ps, lr=float(lr_base[k]))
            for k, ps in enumerate(params)]
    hooks = []
    for k in range(K):
        hooks += readout_grad_hook("fc2")(model.member(k))
    gens = member_generators(seed, K, device)

    def loss_fn(batch):
        bidx, mask = batch
        logits = model(seqs[members, bidx], coeffs[members, bidx],
                       generators=gens)                     # [K, B, C]
        logp = torch.log_softmax(logits, dim=-1)
        per = -torch.gather(logp, -1, ylab[bidx][..., None])[..., 0]
        m = mask[None]
        return (per * m).sum(1) / m.sum(1).clamp_min(1.0), logits

    def grid(which, rngs=None):
        """Each member's padded index grid [nb, K, B] and the shared mask
        [nb, B]."""
        perms = []
        for k, sp in enumerate(splits_list):
            ix = np.asarray(sp[which])
            if rngs is not None:
                ix = rngs[k].permutation(ix)
            g, mask = _padded_grid(ix, batch_size)
            perms.append(g)
        return np.stack(perms, axis=1), mask

    def evaluate(which):
        perm, masks = grid(which)
        model.eval()
        logits, losses = [], []
        with torch.no_grad():
            for bidx, mask in zip(perm, masks):
                ml, lo = loss_fn((torch.as_tensor(bidx, device=device),
                                  torch.as_tensor(mask, device=device)))
                logits.append(lo)
                losses.append(ml)
        model.train()
        logits = torch.stack(logits).cpu().numpy()      # [nb, K, B, C]
        losses = torch.stack(losses).cpu().numpy()      # [nb, K]
        valid = masks.reshape(-1) > 0
        n_valid = masks.sum(axis=1)
        out = []
        for k in range(K):
            idx = perm[:, k].reshape(-1)[valid]
            lo = logits[:, k].reshape(-1, num_classes)[valid]
            loss = float((losses[:, k] * n_valid).sum() / n_valid.sum())
            out.append(classification_metrics(y.astype(np.int64)[idx], lo,
                                              loss, num_classes))
        return out

    sched = StepLR(lr=1.0, step_size=10, gamma=0.5)
    rngs = [np.random.default_rng(k) for k in range(K)]
    best_val = np.full(K, -np.inf)
    best_state = [copy.deepcopy(model.member(k).state_dict())
                  for k in range(K)]
    stale = np.zeros(K, int)
    active = np.ones(K, bool)
    for epoch in range(max_epochs):
        perm, masks = grid(0, rngs)
        for bidx, mask in zip(perm, masks):
            ensemble_step(model, opts, params, loss_fn,
                          (torch.as_tensor(bidx, device=device),
                           torch.as_tensor(mask, device=device)),
                          active, clip_norm=CLIP_NORM)
        decay = sched.step()
        for k in range(K):
            for group in opts[k].param_groups:
                group["lr"] = float(lr_base[k]) * decay
        val_ms = evaluate(1)
        for k in range(K):
            if not active[k]:
                continue
            if val_ms[k].accuracy > best_val[k]:
                best_val[k], stale[k] = val_ms[k].accuracy, 0
                best_state[k] = copy.deepcopy(model.member(k).state_dict())
            else:
                stale[k] += 1
                if stale[k] >= patience:
                    active[k] = False
        if verbose:
            accs = " ".join(f"{v.accuracy:.3f}" for v in val_ms)
            print(f"  epoch {epoch}: val acc [{accs}]", flush=True)
        if not active.any():
            break
    for h in hooks:
        h.remove()
    for k in range(K):
        model.member(k).load_state_dict(best_state[k])
    return model, evaluate(2)
