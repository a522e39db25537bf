"""Sepsis and Speech Commands classification harnesses (counterpart of
snsde/harness/classification.py:44-56, 110-475).

The model name resolves to an (input_option, noise_option) pair of the
7x20 grid; `make_model` also builds the baseline twins of the JAX
registry (`ncde`, `gruode`: the CDE kernels on the card; `dt`, `decay`,
`odernn`: the GRU kernels' obs, decay-row and evolve modes). The sepsis model maps the static features to z0 through a
two-layer encoder and reads the NeuralSDE's terminal state out through a
BatchNorm head; training is binary BCE with pos_weight 10, selected on val
AUROC, with the 100x gradient hook on the readout's last linear. The
speech model takes z0 from its initial network on the first observation
(no static features, no intensity channels: 20 MFCC coefficients and
time) and ten classes; training is softmax cross-entropy selected on val
accuracy, with the same hook. The harnesses run on synthetic data of the
benchmarks' shapes by default.

`run_sepsis_ensemble` and `run_speech_ensemble` train the reference's
repeats of one cell (same data and split, fresh initial weights and
training noise each) as one seed ensemble, its solve one member-axis
launch; `run_all` walks the reference's experiment grid, the repeats of a
sepsis cell solo or packed, those of a speech cell solo (as the JAX
package's run_all, which packs only sepsis cells).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.common import preprocess_classification, stratified_split
from ..data.synthetic import synthetic_sepsis, synthetic_speech
from ..fields import MODEL_NAME_GRID, DiffusionField
from ..models.ensemble import InitialValueSeedEnsemble, SeedEnsemble
from ..models.neuralsde import NeuralSDE
from ..nn.layers import make_linear
from ..train.ensemble_loop import fit_classifier_ensemble
from ..train.loop import (FitResult, TrainConfig, fit_classifier,
                          readout_grad_hook)

__all__ = ["parse_model_name", "make_model", "make_sde_model", "InitialValueModel",
           "HarnessConfig", "run_sepsis", "run_sepsis_ensemble",
           "run_speech", "run_speech_ensemble", "run_all"]

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


def make_model(name: str, input_channels: int, hidden_channels: int,
               hidden_hidden_channels: int, num_hidden_layers: int,
               output_channels: int, use_intensity: bool = False,
               initial: bool = True, method: str = "euler", *,
               generator: Optional[torch.Generator] = None, device=None):
    """(model, reg_subtree_fn) of the classification registry
    (snsde/harness/classification.py:58-107): the SDE grid's names, and
    the baseline twins `ncde` (FinalTanh) and `gruode` (the GRU-ODE field)
    in a NeuralCDE, `dt` (GRUdt), `decay` (GRUD) and `odernn` (ODERNN).
    The last three read the intensity-augmented stream [time ‖ K
    intensities ‖ K values] and raise ValueError on an even channel
    count. The weights are drawn from `generator` in construction order."""
    kw = dict(generator=generator, device=device)
    if name in ("ncde", "gruode"):
        from ..models.neuralcde import FinalTanh, GRUODEField, NeuralCDE

        field = (FinalTanh(input_channels, hidden_channels,
                           hidden_hidden_channels, num_hidden_layers, **kw)
                 if name == "ncde" else
                 GRUODEField(input_channels, hidden_channels, **kw))
        model = NeuralCDE(field, input_channels, hidden_channels,
                          output_channels, initial=initial, **kw)
        return model, (lambda m: m.func)
    if name in ("dt", "decay", "odernn"):
        from ..models.rnn import GRUD, ODERNN, GRUdt

        if input_channels % 2 != 1:
            raise ValueError(
                f"{name} requires the intensity-augmented channel layout "
                f"[time ‖ K intensity ‖ K values] (odd channel count; got "
                f"{input_channels}): preprocess with use_intensity=True")
        if name == "odernn":
            model = ODERNN(input_channels, hidden_channels, output_channels,
                           hidden_hidden_channels, num_hidden_layers,
                           use_intensity=use_intensity, **kw)
        else:
            model = (GRUdt if name == "dt" else GRUD)(
                input_channels, hidden_channels, output_channels,
                use_intensity=use_intensity, **kw)
        return model, (lambda m: m)
    return make_sde_model(name, input_channels, hidden_channels,
                          hidden_hidden_channels, num_hidden_layers,
                          output_channels, initial=initial, method=method,
                          **kw)


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
    # where run_sepsis and run_sepsis_ensemble write their records
    results_dir: Optional[str] = None

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


def _sepsis_data(cfg: HarnessConfig, n: int, data_fn: Callable):
    """The preprocessed splits (each with its static features), the input
    channels and the static width."""
    X, static, y, lengths, _ = data_fn(n=n, seed=cfg.dseed)
    data = preprocess_classification(
        X, y, lengths, use_intensity=cfg.use_intensity, seed=cfg.dseed,
        times=np.arange(X.shape[1], dtype=np.float32))
    for split, idx in zip((data["train"], data["val"], data["test"]),
                          stratified_split(y, seed=cfg.dseed)):
        split["static"] = static[idx]
    return data, static.shape[-1]


def _sepsis_config(cfg: HarnessConfig, max_epochs) -> TrainConfig:
    return TrainConfig(lr=cfg.lr, batch_size=cfg.batch_size,
                       max_epochs=max_epochs or cfg.max_epochs,
                       num_classes=2, pos_weight=10.0, step_mode="valauc",
                       seed=cfg.seed)


def _save_results(results_dir: str, name: str, result: FitResult) -> None:
    """One run's record as results_dir/name/<next number> (JSON), as the
    JAX harness writes it (classification.py:180-205)."""
    os.makedirs(os.path.join(results_dir, name), exist_ok=True)
    nums = [int(f) for f in os.listdir(os.path.join(results_dir, name))
            if f.isdigit()]
    payload = {
        "name": name, "history": result.history,
        "train_metrics": result.train_metrics.as_dict(),
        "val_metrics": result.val_metrics.as_dict(),
        "test_metrics": (result.test_metrics.as_dict()
                         if result.test_metrics else None),
        "wall_time": result.wall_time, "steps_per_sec": result.steps_per_sec,
        "memory_usage": result.memory_usage,
        "parameters": result.parameters}
    with open(os.path.join(results_dir, name,
                           str(max(nums) + 1 if nums else 0)), "w") as f:
        json.dump(payload, f)


def run_sepsis(cfg: HarnessConfig = HarnessConfig(), n: int = 4096,
               data_fn: Callable = synthetic_sepsis,
               max_epochs: Optional[int] = None,
               device=None, mesh=None) -> FitResult:
    """Sepsis classification: binary, AUROC-selected, static -> z0. Runs on
    CUDA unless `device` says otherwise; with a `parallel.Mesh`, on the
    mesh's device, data-parallel over its ranks (fit_classifier(mesh=):
    the result is the single process's, every rank calling run_sepsis
    alike)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    data, static_dim = _sepsis_data(cfg, n, data_fn)
    tr, va, te = data["train"], data["val"], data["test"]
    model = build_sepsis_model(cfg, data["input_channels"], static_dim, dev)
    times = data["times"]

    def apply_fn(m, batch, generator):
        logits = m(times, batch["coeffs"], batch["static"],
                   batch["final_index"], generator=generator)
        return logits[..., 0]

    result = fit_classifier(
        model, apply_fn, lambda m: m.sde.func, tr, va, te,
        _sepsis_config(cfg, max_epochs), mesh=mesh,
        grad_hook=readout_grad_hook("sde.readout.linear2"))
    if cfg.results_dir and (mesh is None or mesh.rank == 0):
        _save_results(cfg.results_dir, f"sepsis-{cfg.model_name}", result)
    return result


def build_sepsis_ensemble(cfg: HarnessConfig, input_channels: int,
                          static_dim: int, repeats: int,
                          device) -> InitialValueSeedEnsemble:
    """`repeats` members of the sepsis model, drawn on the CPU from one
    generator seeded with cfg.seed (member after member), then moved to
    `device`."""
    io, no = parse_model_name(cfg.model_name)
    gen = torch.Generator().manual_seed(cfg.seed)

    def make_field(g):
        return DiffusionField(input_channels, cfg.hidden_channels,
                              cfg.hidden_hidden_channels,
                              cfg.num_hidden_layers, input_option=io,
                              noise_option=no, generator=g)

    model = InitialValueSeedEnsemble(make_field, static_dim,
                                     cfg.hidden_channels, 1, repeats,
                                     method=cfg.method, generator=gen)
    return model.to(device)


def run_sepsis_ensemble(cfg: HarnessConfig = HarnessConfig(),
                        repeats: int = 5, n: int = 4096,
                        data_fn: Callable = synthetic_sepsis,
                        max_epochs: Optional[int] = None,
                        device=None) -> List[FitResult]:
    """The reference's repeats of one sepsis cell (same data and split,
    fresh initial weights and training noise each repeat) trained as one
    seed ensemble (classification.py:297-353): its solve one launch of the
    member-axis kernels on CUDA. Returns one FitResult per repeat."""
    dev = resolve_device(device)
    data, static_dim = _sepsis_data(cfg, n, data_fn)
    model = build_sepsis_ensemble(cfg, data["input_channels"], static_dim,
                                  repeats, dev)
    times = data["times"]

    def apply_fn(m, batch, generators):
        logits = m(times, batch["coeffs"], batch["static"],
                   batch["final_index"], generators=generators)
        return logits[..., 0]                                # [K, B]

    results = fit_classifier_ensemble(
        model, apply_fn, data["train"], data["val"], data["test"],
        _sepsis_config(cfg, max_epochs),
        member_grad_hook=readout_grad_hook("readout.linear2"))
    if cfg.results_dir:
        for res in results:
            _save_results(cfg.results_dir,
                          f"sepsis-{cfg.model_name}-packed", res)
    return results


SPEECH_CLASSES = 10


def _speech_data(cfg: HarnessConfig, n: int, data_fn: Callable):
    """The preprocessed speech splits: no intensity channels, unit time
    steps (classification.py:263-268)."""
    X, y, lengths, _ = data_fn(n=n, seed=cfg.dseed)
    return preprocess_classification(
        X, y, lengths, use_intensity=False, seed=cfg.dseed,
        times=np.arange(X.shape[1], dtype=np.float32))


def _speech_config(cfg: HarnessConfig, max_epochs) -> TrainConfig:
    return TrainConfig(lr=cfg.lr, batch_size=cfg.batch_size,
                       max_epochs=max_epochs or cfg.max_epochs,
                       num_classes=SPEECH_CLASSES, step_mode="valaccuracy",
                       seed=cfg.seed)


def build_speech_model(cfg: HarnessConfig, input_channels: int, device):
    """(NeuralSDE with z0 from its initial network, reg_subtree_fn), drawn
    on the CPU from a generator seeded with cfg.seed, then moved to
    `device`."""
    gen = torch.Generator().manual_seed(cfg.seed)
    model, reg_fn = make_sde_model(
        cfg.model_name, input_channels, cfg.hidden_channels,
        cfg.hidden_hidden_channels, cfg.num_hidden_layers,
        output_channels=SPEECH_CLASSES, initial=True, method=cfg.method,
        generator=gen)
    return model.to(device), reg_fn


def run_speech(cfg: HarnessConfig = HarnessConfig(), n: int = 2048,
               data_fn: Callable = synthetic_speech,
               max_epochs: Optional[int] = None,
               device=None) -> FitResult:
    """Speech Commands classification (classification.py:255-288): ten
    classes, selected on val accuracy, z0 from the first observation. Runs
    on CUDA unless `device` says otherwise."""
    dev = resolve_device(device)
    data = _speech_data(cfg, n, data_fn)
    model, reg_fn = build_speech_model(cfg, data["input_channels"], dev)
    times = data["times"]

    def apply_fn(m, batch, generator):
        return m(times, batch["coeffs"], batch["final_index"],
                 generator=generator)

    result = fit_classifier(
        model, apply_fn, reg_fn, data["train"], data["val"], data["test"],
        _speech_config(cfg, max_epochs),
        grad_hook=readout_grad_hook("readout.linear2"))
    if cfg.results_dir:
        _save_results(cfg.results_dir, f"speech-{cfg.model_name}", result)
    return result


def build_speech_ensemble(cfg: HarnessConfig, input_channels: int,
                          repeats: int, device) -> SeedEnsemble:
    """`repeats` members of the speech model, drawn on the CPU from one
    generator seeded with cfg.seed (member after member), then moved to
    `device`."""
    io, no = parse_model_name(cfg.model_name)
    gen = torch.Generator().manual_seed(cfg.seed)

    def make_field(g):
        return DiffusionField(input_channels, cfg.hidden_channels,
                              cfg.hidden_hidden_channels,
                              cfg.num_hidden_layers, input_option=io,
                              noise_option=no, generator=g)

    model = SeedEnsemble(make_field, input_channels, cfg.hidden_channels,
                         SPEECH_CLASSES, repeats, method=cfg.method,
                         generator=gen)
    return model.to(device)


def run_speech_ensemble(cfg: HarnessConfig = HarnessConfig(),
                        repeats: int = 5, n: int = 2048,
                        data_fn: Callable = synthetic_speech,
                        max_epochs: Optional[int] = None,
                        device=None) -> List[FitResult]:
    """The reference's repeats of one speech cell (same data and split,
    fresh initial weights and training noise each repeat) trained as one
    seed ensemble (classification.py:356-413): its solve one launch of the
    member-axis kernels on CUDA. The 100x hook scales each member's
    readouts[k].linear2 (member(k)'s module 2). Returns one FitResult per
    repeat."""
    dev = resolve_device(device)
    data = _speech_data(cfg, n, data_fn)
    model = build_speech_ensemble(cfg, data["input_channels"], repeats, dev)
    times = data["times"]

    def apply_fn(m, batch, generators):
        return m(times, batch["coeffs"], batch["final_index"],
                 generators=generators)                      # [K, B, 10]

    results = fit_classifier_ensemble(
        model, apply_fn, data["train"], data["val"], data["test"],
        _speech_config(cfg, max_epochs),
        member_grad_hook=readout_grad_hook("2.linear2"))
    if cfg.results_dir:
        for res in results:
            _save_results(cfg.results_dir,
                          f"speech-{cfg.model_name}-packed", res)
    return results


def run_all(task: str = "sepsis", models=("staticsde", "naivesde",
            "neurallsde", "neurallnsde", "neuralgsde"),
            hidden_list=(16, 32, 64, 128), layer_list=(1, 2, 3, 4),
            repeats: int = 1, intensities=(True, False), n: int = 2048,
            max_epochs: int = 50, results_dir: str = "results-sde",
            pack_repeats: bool = False, device=None):
    """The reference's experiment grid (classification.py:416-475):
    layers x hidden x models x repeats x {intensity, no intensity}, with
    skip-if-exists resume through the records under `results_dir`, for
    task 'sepsis' (run_sepsis) or 'speech' (run_speech, which takes no
    intensity channels either way). With pack_repeats a sepsis cell's
    `repeats` replicas train as one seed ensemble (run_sepsis_ensemble);
    else, and for every speech cell, each repeat solo, seed = its number,
    on the data of seed 0. Returns [(cell name, test metrics)]."""
    if task not in ("sepsis", "speech"):
        raise ValueError(f"run_all task {task!r}: 'sepsis' or 'speech'")
    runner = run_sepsis if task == "sepsis" else run_speech
    results = []
    for use_intensity in intensities:
        for num_layers in layer_list:
            for hidden in hidden_list:
                for model_name in models:
                    name = (f"{task}-{model_name}-h{hidden}-l{num_layers}"
                            f"-i{int(use_intensity)}")
                    base = dict(model_name=model_name, hidden_channels=hidden,
                                hidden_hidden_channels=hidden,
                                num_hidden_layers=num_layers,
                                use_intensity=use_intensity,
                                max_epochs=max_epochs)
                    if pack_repeats and task == "sepsis" and repeats > 1:
                        if os.path.exists(os.path.join(results_dir, name,
                                                       "0")):
                            continue
                        for res in run_sepsis_ensemble(
                                HarnessConfig(seed=0, **base), repeats=repeats,
                                n=n, device=device):
                            _save_results(results_dir, name, res)
                            results.append(
                                (name, res.test_metrics.as_dict()))
                        continue
                    for rep in range(repeats):
                        if os.path.exists(os.path.join(results_dir, name,
                                                       str(rep))):
                            continue
                        res = runner(HarnessConfig(seed=rep, data_seed=0,
                                                   **base),
                                     n=n, device=device)
                        _save_results(results_dir, name, res)
                        results.append((name, res.test_metrics.as_dict()))
    return results
