"""The rank side of the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_sweep_sharded.py).

Each test file spawns two ranks once (torch.multiprocessing.spawn, a
`file://` store under the test's tmp_path, gloo on the CPU, one intra-op
thread); each rank runs every multi-process case of its file and saves
what it saw with torch.save, and the test process holds those records
against the single-process port. This module imports torch and
snsde_torch only, so the ranks start without JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

WORLD = 2

# the data-parallel sepsis cases: a small LNSDE (H=8, two hidden layers) on
# synthetic_sepsis(n=128), 89 training rows: batches of 32 (16 a rank), the
# last padded by wrap-around
DP = dict(H=8, layers=2, n=128, batch=32, uneven_batch=31, epochs=2)
BN_ROWS, BN_CH, BN_LEN = 16, 5, 3


def sepsis_config(batch=DP["batch"]):
    from snsde_torch.harness.classification import HarnessConfig

    return HarnessConfig(hidden_channels=DP["H"],
                         hidden_hidden_channels=DP["H"],
                         num_hidden_layers=DP["layers"], batch_size=batch)


def sepsis_step(mesh=None, batch=DP["batch"]):
    """One training step of the sepsis model on the first batch of the
    fit's epoch-0 order (the fit's loss, hook, optimizer and generator), on
    the CPU; data-parallel over `mesh` when given. Returns (this rank's
    loss, {name: gradient}, {name: parameter after Adam})."""
    from snsde_torch.data.synthetic import synthetic_sepsis
    from snsde_torch.harness.classification import (_sepsis_config,
                                                    _sepsis_data,
                                                    build_sepsis_model)
    from snsde_torch.parallel import replicate, shard_rows, sharded
    from snsde_torch.train.loop import (_to_device, make_loss_fn,
                                        make_optimizer, padded_index_grid,
                                        rank_batch, readout_grad_hook,
                                        train_step)

    cfg = sepsis_config(batch)
    data, static_dim = _sepsis_data(cfg, DP["n"], synthetic_sepsis)
    model = build_sepsis_model(cfg, data["input_channels"], static_dim,
                               "cpu")
    if mesh is not None:
        replicate(model, mesh)
    times = data["times"]

    def apply_fn(m, b, generator):
        return m(times, b["coeffs"], b["static"], b["final_index"],
                 generator=generator)[..., 0]

    tc = _sepsis_config(cfg, 1)
    loss_fn = make_loss_fn(apply_fn, lambda m: m.sde.func, tc)
    opt = make_optimizer(model, tc)
    readout_grad_hook("sde.readout.linear2")(model)
    gen = torch.Generator().manual_seed(tc.seed)
    rng = np.random.default_rng(tc.seed)
    dtrain = _to_device(data["train"], "cpu")
    n_train = next(iter(data["train"].values())).shape[0]
    perm, masks, _ = padded_index_grid(rng.permutation(n_train), batch)
    split = sharded(mesh, batch)
    with shard_rows(mesh, batch):
        loss = train_step(model, opt, loss_fn,
                          rank_batch(dtrain, perm[0], masks[0], mesh), gen,
                          grad_group=mesh.group if split else None)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return float(loss), grads, params


def bn_inputs(three_d: bool):
    """x, dy of the global batch (numpy seeded), [16, 5] or [16, 5, 3]."""
    rng = np.random.default_rng(7)
    shape = (BN_ROWS, BN_CH) + ((BN_LEN,) if three_d else ())
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return torch.as_tensor(x), torch.as_tensor(dy)


def bn_module():
    from snsde_torch.nn.layers import BatchNorm

    bn = BatchNorm(BN_CH)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, BN_CH))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, BN_CH))
    return bn


def _bn_case(mesh, three_d):
    from snsde_torch.parallel import shard_batch, shard_rows

    x, dy = bn_inputs(three_d)
    x = shard_batch(x, mesh).clone().requires_grad_(True)
    dy = shard_batch(dy, mesh)
    bn = bn_module()
    with shard_rows(mesh, BN_ROWS):
        y = bn(x)
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def _local_batchnorm(x, bn, shard):
    return torch.nn.BatchNorm1d.forward(bn, x)


def _local_draw(draw, shape, dim=0):
    return draw(tuple(shape))


def parallel_rank(rank, store, out):
    """Every multi-process case of tests/test_torch_parallel.py on this
    rank; saves rank<r>.pt in `out`."""
    torch.set_num_threads(1)
    import snsde_torch.nn.layers as layers
    import snsde_torch.ops.brownian as brownian
    from snsde_torch.harness.classification import run_sepsis
    from snsde_torch.parallel import (init_multihost, make_mesh, replicate,
                                      shard_batch)

    backend = init_multihost(f"file://{store}", WORLD, rank)
    mesh = make_mesh(("data",), devices="cpu")
    rec = {"backend": backend, "rank": mesh.rank, "size": mesh.size}
    rec["shard_even"] = shard_batch(
        {"a": np.arange(8), "t": torch.arange(12).reshape(4, 3),
         "s": np.float32(3.0)}, mesh)
    rec["shard_uneven"] = shard_batch(np.arange(7), mesh)
    rec["replicate_tensor"] = replicate(
        {"v": torch.full((3,), float(rank))}, mesh)["v"]
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank + 1))
    replicate(lin, mesh)
    rec["replicate_module"] = lin.weight.detach().clone()
    rec["bn"] = {d: _bn_case(mesh, d) for d in (False, True)}
    rec["step"] = sepsis_step(mesh)
    saved = (layers.global_batch_norm, layers.draw_rows, brownian.draw_rows)
    layers.global_batch_norm = _local_batchnorm
    rec["step_local_bn"] = sepsis_step(mesh)
    layers.global_batch_norm = saved[0]
    layers.draw_rows = brownian.draw_rows = _local_draw
    rec["step_local_noise"] = sepsis_step(mesh)
    layers.draw_rows, brownian.draw_rows = saved[1:]
    rec["uneven_shard"] = shard_batch(np.arange(DP["uneven_batch"]), mesh)
    rec["step_uneven"] = sepsis_step(mesh, DP["uneven_batch"])
    res = run_sepsis(sepsis_config(), n=DP["n"], max_epochs=DP["epochs"],
                     device="cpu", mesh=mesh)
    rec["fit"] = fit_record(res)
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def fit_record(res):
    """What the tests compare of a FitResult."""
    return {"history": res.history,
            "test": res.test_metrics.as_dict(),
            "val": res.val_metrics.as_dict(),
            "memory_usage": res.memory_usage,
            "state": {k: v.clone() for k, v in res.model.state_dict().items()}}


# the sharded sweep cases: JAX's tests/test_sweep_sharded.py settings
SWEEP_N, SWEEP_L, SWEEP_C = 64, 16, 2
SWEEP_CELLS = [(0.0, 0), (0.5, 1), (0.3, 2)]
STOP_CELLS = [(0.0, 0), (0.7, 1)]
RUNNER = dict(models=("gru",), missing_rates=(0.0, 0.3), seeds=(0, 1),
              hidden_dim=8, batch_size=16, max_epochs=2, n=48)


def sweep_data():
    from snsde_torch.data.synthetic import synthetic_uea

    X, y, _ = synthetic_uea(n=SWEEP_N, length=SWEEP_L, channels=SWEEP_C)
    return X, y


def runner_config(out_dir):
    from snsde_torch.harness.robustness import SweepConfig

    kw = {k: v for k, v in RUNNER.items() if k != "n"}
    return SweepConfig(out_dir=out_dir, **kw)


def _cells_record(models, test_ms, info):
    return {"test": [(m.accuracy, m.loss, m.f1_weighted) for m in test_ms],
            "state": [{k: v.clone() for k, v in m.state_dict().items()}
                      for m in models],
            "devices": info["devices"], "cells": info["cells"],
            "splits": info["splits"]}


def sweep_rank(rank, store, out):
    """Every multi-process case of tests/test_torch_sweep_sharded.py on
    this rank; saves rank<r>.pt in `out` (the runner writes under
    out/port)."""
    torch.set_num_threads(1)
    from snsde_torch.harness.sweep_sharded import (
        run_robustness_sweep_sharded, train_ists_cells_sharded)
    from snsde_torch.parallel import init_multihost, make_mesh

    init_multihost(f"file://{store}", WORLD, rank)
    mesh = make_mesh(("cells",), devices="cpu")
    X, y = sweep_data()
    rec = {"cells": _cells_record(*train_ists_cells_sharded(
        "gru", X, y, SWEEP_CELLS, mesh=mesh, hidden_dim=8, batch_size=16,
        max_epochs=3, patience=10))}
    rec["stop"] = _cells_record(*train_ists_cells_sharded(
        "gru", X, y, STOP_CELLS, mesh=mesh, hidden_dim=8, batch_size=16,
        max_epochs=6, patience=1))
    cfg = runner_config(os.path.join(out, "port"))
    rec["runner"] = run_robustness_sweep_sharded(cfg, n=RUNNER["n"],
                                                 mesh=mesh, verbose=False)
    rec["mtimes"] = _mtimes(cfg.out_dir)
    rec["resumed"] = run_robustness_sweep_sharded(cfg, n=RUNNER["n"],
                                                  mesh=mesh, verbose=False)
    rec["mtimes_after"] = _mtimes(cfg.out_dir)
    try:
        train_ists_cells_sharded("no-such-model", X, y, SWEEP_CELLS,
                                 mesh=mesh, hidden_dim=8, max_epochs=1)
        rec["failure"] = None
    except RuntimeError as e:
        rec["failure"] = str(e)
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def _mtimes(root):
    return {os.path.relpath(os.path.join(d, f), root):
            os.path.getmtime(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs}


def spawn(fn, tmp_path):
    """Run fn(rank, store, out) on WORLD ranks; returns each rank's saved
    record."""
    import torch.multiprocessing as mp

    out = str(tmp_path)
    mp.spawn(fn, args=(os.path.join(out, "store"), out), nprocs=WORLD)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]

