"""Hyper-parameter search by successive halving (ASHA; counterpart of
snsde/harness/param_search.py, the reference's ray.tune ASHAScheduler
over lr log-uniform in [1e-4, 1e-1], hidden in {16, 32, 64, 128}, layers
1-4, without ray).

`num_samples` trial configs are drawn from numpy's default_rng(seed)
(`sample_config`, the JAX package's exact sequence). Each rung trains
every live trial from scratch for the rung's whole budget: trial ti's
classifier drawn from a generator seeded seed * 1000 + ti and trained by
`train_ists_model(seed=seed * 1000 + ti)`, nothing carried from the rung
before, as the JAX package does. After a rung the live trials are sorted
by score (Python's stable sort, so ties keep trial order) and all but
the best 1 / reduction_factor stop. The result and its JSON are the JAX
package's.

With pack=True the live trials of an SDE grid name, `neuralcde` or
`gru-ode` are grouped by (hidden_dim, num_hidden_layers), trials that
differ only in lr, and each group of two or more trains as one
`ISTSSeedEnsembleSDE` whose member k starts from its own trial's solo
draw, with its own lr (`train_ists_ensemble(lrs=...)`): one member-axis
launch a step on the card. A group of one trains solo.

A fault of the reference, kept here: the score that prunes is the TEST
accuracy (the JAX package's :91 and :115 read the test metrics), although
its docstring says pruning is by validation accuracy; named by
tests/test_torch_entry_points.py::test_known_fault_asha_scores_on_test_accuracy.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.common import stratified_split
from .robustness import (ISTSClassifier, ISTSSeedEnsembleSDE, coeff_family,
                         preprocess_ists, train_ists_ensemble,
                         train_ists_model)

__all__ = ["SearchSpace", "sample_config", "asha_search"]

_SDE_GRID_RE = re.compile(r"^neuralsde_\d+_\d+$")


@dataclass
class SearchSpace:
    lr_min: float = 1e-4
    lr_max: float = 1e-1
    hidden_choices: tuple = (16, 32, 64, 128)
    layer_choices: tuple = (1, 2, 3, 4)


def sample_config(rng: np.random.Generator, space: SearchSpace) -> Dict:
    return {
        "lr": float(np.exp(rng.uniform(np.log(space.lr_min),
                                       np.log(space.lr_max)))),
        "hidden_dim": int(rng.choice(space.hidden_choices)),
        "num_hidden_layers": int(rng.choice(space.layer_choices)),
    }


def asha_search(model_name: str, X: np.ndarray, y: np.ndarray,
                num_samples: int = 8, rungs=(2, 5, 12),
                reduction_factor: int = 2, seed: int = 0,
                space: SearchSpace = SearchSpace(),
                out_path: Optional[str] = None,
                missing_rate: float = 0.0, batch_size: int = 64,
                pack: bool = False, device=None) -> Dict:
    """Successive halving over `rungs` (epoch budgets); returns {"model",
    "best_config", "best_score", "trials": [{"config", "score", "alive"}]}
    and writes it as JSON to `out_path` when given. Runs on CUDA unless
    `device` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = preprocess_ists(X, missing_rate=missing_rate,
                           interpolation=coeff_family(model_name))
    splits = stratified_split(y, seed=seed)
    num_classes = int(y.max()) + 1
    trials = [{"config": sample_config(rng, space), "score": None,
               "alive": True} for _ in range(num_samples)]

    def build(ti):
        """Trial ti's classifier as every rung starts it: drawn on the CPU
        from a generator seeded seed * 1000 + ti, then moved to the
        device."""
        cfg = trials[ti]["config"]
        return ISTSClassifier(
            model_name, X.shape[-1], X.shape[1], cfg["hidden_dim"],
            num_classes, num_hidden_layers=cfg["num_hidden_layers"],
            generator=torch.Generator().manual_seed(seed * 1000 + ti)).to(dev)

    def run_solo(ti: int, budget: int):
        _, test_m = train_ists_model(
            build(ti), data, y, splits, lr=trials[ti]["config"]["lr"],
            batch_size=batch_size, max_epochs=budget, patience=budget,
            seed=seed * 1000 + ti)
        trials[ti]["score"] = test_m.accuracy

    def run_packed(tis, budget: int):
        model = ISTSSeedEnsembleSDE([build(ti) for ti in tis])
        K = len(tis)
        _, test_ms = train_ists_ensemble(
            model, [data] * K, y, [splits] * K,
            lrs=[trials[ti]["config"]["lr"] for ti in tis],
            batch_size=batch_size, max_epochs=budget, patience=budget,
            seed=seed * 1000 + tis[0])
        for ti, tm in zip(tis, test_ms):
            trials[ti]["score"] = tm.accuracy

    packable = pack and (_SDE_GRID_RE.match(model_name)
                         or model_name in ("neuralcde", "gru-ode"))
    for budget in rungs:
        alive_idx = [ti for ti, t in enumerate(trials) if t["alive"]]
        if packable:
            groups: Dict[tuple, list] = {}
            for ti in alive_idx:
                c = trials[ti]["config"]
                groups.setdefault((c["hidden_dim"], c["num_hidden_layers"]),
                                  []).append(ti)
            for tis in groups.values():
                if len(tis) == 1:
                    run_solo(tis[0], budget)
                else:
                    run_packed(tis, budget)
        else:
            for ti in alive_idx:
                run_solo(ti, budget)
        # keep the best 1 / reduction_factor (a stable sort: ties keep
        # trial order)
        alive = [t for t in trials if t["alive"]]
        alive.sort(key=lambda t: -(t["score"] or 0.0))
        for t in alive[max(len(alive) // reduction_factor, 1):]:
            t["alive"] = False

    best = max(trials, key=lambda t: (t["score"] or 0.0))
    result = {"model": model_name, "best_config": best["config"],
              "best_score": best["score"],
              "trials": [{"config": t["config"], "score": t["score"],
                          "alive": t["alive"]} for t in trials]}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, default=float)
    return result
