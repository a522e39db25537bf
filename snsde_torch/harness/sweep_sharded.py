"""Sharded sweep cells — independent training runs over the ranks of a
process mesh (counterpart of snsde/harness/sweep_sharded.py).

The reference parallelises its robustness sweep at the OS level: one
process per seed, each on its own GPU (`torch-ists/model_run.py`). The JAX
package runs the (missing_rate, seed) cells of one model as one SPMD
program, a cell a device. Here every rank of a `parallel.Mesh` (one
process a device) trains its own cells — rank r the cells r, r + W, … —
each through the port's own `train_ists_model` on the rank's device, so
every registry family runs sharded, each on its kernels. Cells are
independent: the only collective is the gather of the results (each
cell's test metrics and weights), after which every rank holds every
cell.

Each cell is its sequential run (`run_robustness_sweep`'s) exactly: the
seed drives the split, the missingness draw, the initial weights, the
batch order and the generator of the training noise, so on the same
device a sharded cell's test metrics and weights equal its sequential
run's bit for bit. The JAX contract is the same (`sweep_sharded.py:21-23`);
the one departure is the batch order, which comes from the cell's seed as
in the port's sequential sweep (JAX shuffles every cell with
`default_rng(0)`, the known fault of `snsde/harness/robustness.py:237`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.common import stratified_split
from ..data.synthetic import synthetic_uea
from ..parallel.mesh import make_mesh
from .robustness import (ISTSClassifier, SweepConfig, coeff_family,
                         predict_ists, preprocess_ists, train_ists_model)

__all__ = ["train_ists_cells_sharded", "run_robustness_sweep_sharded",
           "extract_cell"]


def extract_cell(models: Sequence[ISTSClassifier], c: int) -> ISTSClassifier:
    """Cell c's trained classifier."""
    return models[c]


def _gather(obj, mesh) -> List:
    """Every rank's object, in rank order."""
    if mesh.group is None or mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _broadcast(obj, mesh):
    """Rank 0's object on every rank."""
    if mesh.group is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def train_ists_cells_sharded(
    model_name: str,
    X: np.ndarray,
    y: np.ndarray,
    cells: Sequence[Tuple[float, int]],
    *,
    mesh=None,
    hidden_dim: int = 16,
    lr: float = 1e-3,
    batch_size: int = 64,
    max_epochs: int = 30,
    patience: int = 10,
    kl_weight: float = 1e-4,
    method: Optional[str] = None,
    interpolation: Optional[str] = None,
    verbose: bool = False,
    datas: Optional[List[Dict]] = None,
    device=None,
):
    """Train one registry model config on its (missing_rate, seed) cells,
    rank r of `mesh` the cells r, r + W, … on its device; every rank calls
    it with the same arguments. Without a mesh, the single process on
    `device` (CUDA unless told otherwise) trains every cell.

    `datas` optionally supplies the `preprocess_ists` dicts (one per cell,
    same order). Returns (the per-cell classifiers on this rank's device,
    [per-cell test ClassificationMetrics], info dict with `devices`,
    `cells`, `datas` and `splits`), the same on every rank; `extract_cell`
    takes a cell's classifier out. A cell that raises on any rank makes
    every rank raise, after the gather."""
    mesh = mesh if mesh is not None else make_mesh(("cells",),
                                                   devices=device)
    W = mesh.size
    cells = list(cells)
    if not cells:
        return [], [], {"devices": W, "cells": [], "datas": [],
                        "splits": []}
    yi = np.asarray(y).ravel().astype(np.int64)
    num_classes = int(yi.max()) + 1
    _, L, C = X.shape
    family = interpolation or coeff_family(model_name)
    if datas is None:
        cache: Dict = {}
        datas = []
        for rate, seed in cells:
            if (rate, seed) not in cache:
                cache[(rate, seed)] = preprocess_ists(
                    X, missing_rate=rate, seed=seed, interpolation=family)
            datas.append(cache[(rate, seed)])
    splits = [stratified_split(yi, seed=s) for _, s in cells]

    def new_model(seed):
        return ISTSClassifier(
            model_name, C, L, hidden_dim, num_classes, method=method,
            generator=torch.Generator().manual_seed(seed)).to(mesh.device)

    mine: Dict[int, object] = {}
    trained: Dict[int, ISTSClassifier] = {}
    for c in range(mesh.rank, len(cells), W):
        rate, seed = cells[c]
        try:
            model, test_m = train_ists_model(
                new_model(seed), datas[c], yi, splits[c], lr=lr,
                batch_size=batch_size, max_epochs=max_epochs,
                patience=patience, verbose=verbose, seed=seed,
                kl_weight=kl_weight)
            trained[c] = model
            mine[c] = (test_m, {k: v.detach().cpu()
                                for k, v in model.state_dict().items()})
        except Exception as e:        # raised below on every rank alike
            mine[c] = repr(e)
    results: Dict[int, object] = {}
    for part in _gather(mine, mesh):
        results.update(part)
    failed = {c: r for c, r in results.items() if isinstance(r, str)}
    if failed:
        raise RuntimeError(
            "sharded cells failed: " + "; ".join(
                f"{cells[c]}: {failed[c]}" for c in sorted(failed)))
    models, test_ms = [], []
    for c, (rate, seed) in enumerate(cells):
        test_m, state = results[c]
        if c not in trained:
            trained[c] = new_model(seed)
            trained[c].load_state_dict(state)
        models.append(trained[c])
        test_ms.append(test_m)
    return models, test_ms, {"devices": W, "cells": cells, "datas": datas,
                             "splits": splits}


def run_robustness_sweep_sharded(
    cfg: Optional[SweepConfig] = None, n: int = 256, data_fn=synthetic_uea,
    dataset_name: str = "synthetic_uea", mesh=None, verbose: bool = True,
    device=None,
) -> List[Dict]:
    """`run_robustness_sweep` with each model's (rate x seed) cells over
    the mesh's ranks (JAX's `run_robustness_sweep_sharded`, :346-419): the
    same JSON records and paths (out_dir/dataset/rate/model_seed.json),
    skip-if-exists resume, `"cells_sharded"` (the cells of the chunk) in
    each record and an `"error"` record for every cell of a chunk that
    failed. The pending cells are chunked to the mesh size; rank 0 alone
    writes, and every rank returns rank 0's records. Every rank calls it
    with the same arguments; without a mesh, the single process on
    `device` (CUDA unless told otherwise)."""
    cfg = cfg if cfg is not None else SweepConfig()
    mesh = mesh if mesh is not None else make_mesh(("cells",),
                                                   devices=device)
    D = mesh.size
    lead = mesh.rank == 0
    X, y, _ = data_fn(n=n)
    results: List[Dict] = []

    def _write(rec, out_path):
        results.append(rec)
        if not lead:
            return
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f)
        if verbose:
            print(rec, flush=True)

    for model_name in cfg.models:
        pending, resumed = [], []
        if lead:
            for rate in cfg.missing_rates:
                for seed in cfg.seeds:
                    out_path = os.path.join(
                        cfg.out_dir, dataset_name, str(int(rate * 100)),
                        f"{model_name}_{seed}.json")
                    if os.path.exists(out_path):            # resume
                        with open(out_path) as f:
                            resumed.append(json.load(f))
                        continue
                    pending.append((rate, seed, out_path))
        pending, resumed = _broadcast((pending, resumed), mesh)
        results.extend(resumed)
        for i in range(0, len(pending), D):
            chunk = pending[i:i + D]
            cells = [(r, s) for r, s, _ in chunk]
            t0 = time.time()
            try:
                models, test_ms, info = train_ists_cells_sharded(
                    model_name, X, y, cells, mesh=mesh,
                    hidden_dim=cfg.hidden_dim, lr=cfg.lr,
                    batch_size=cfg.batch_size, max_epochs=cfg.max_epochs,
                    patience=cfg.patience, kl_weight=cfg.kl_weight,
                    method=cfg.method)
                wall = (time.time() - t0) / len(chunk)
                for c, ((rate, seed, out_path), tm) in enumerate(
                        zip(chunk, test_ms)):
                    if cfg.save_preds and lead:
                        yt, yp, lo = predict_ists(
                            extract_cell(models, c), info["datas"][c], y,
                            info["splits"][c][2], cfg.batch_size, seed)
                        os.makedirs(os.path.dirname(out_path),
                                    exist_ok=True)
                        np.savez(out_path[:-5] + ".npz", y_true=yt,
                                 y_pred=yp, logits=lo)
                    _write({
                        "dataset": dataset_name, "missing_rate": rate,
                        "model": model_name, "seed": seed,
                        "accuracy": float(tm.accuracy),
                        "f1_weighted": float(tm.f1_weighted),
                        "wall_time": wall,
                        "cells_sharded": len(chunk),
                    }, out_path)
            except Exception as e:  # blanket skip, as model_run.py
                for rate, seed, out_path in chunk:
                    _write({
                        "dataset": dataset_name, "missing_rate": rate,
                        "model": model_name, "seed": seed,
                        "error": repr(e),
                    }, out_path)
    return _broadcast(results, mesh)
