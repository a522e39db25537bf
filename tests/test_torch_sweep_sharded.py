"""The sharded sweep of the port (snsde_torch/harness/sweep_sharded.py) on
two CPU ranks.

Two ranks are spawned once for the whole file (tests/torch_dp_ranks.py:
gloo, a file:// store under tmp_path); rank r trains the cells r, r + 2, …
Each cell must be its sequential `train_ists_model` run bit for bit (test
metrics and every weight), early stopping included. The JAX parity is held
through the sequential sweep, which tests/test_torch_sweep_parity.py holds
against JAX's `train_ists_model` at seed 0 (the seeds' batch orders part
by design, ROADMAP Queue 3); here the runner's records and paths are held
to the keys and paths of JAX's `run_robustness_sweep_sharded` on the same
tiny config over two devices.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import json
import os

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from snsde_torch.data.common import stratified_split
from snsde_torch.harness.robustness import (ISTSClassifier, preprocess_ists,
                                            train_ists_model)
from snsde_torch.harness.sweep_sharded import (extract_cell,
                                               run_robustness_sweep_sharded,
                                               train_ists_cells_sharded)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sweep")


@pytest.fixture(scope="module")
def ranks(out_dir):
    return R.spawn(R.sweep_rank, out_dir)


def sequential(X, y, rate, seed, **kw):
    """The port's sequential sweep run of one cell (run_robustness_sweep's
    construction), on the CPU."""
    data = preprocess_ists(X, missing_rate=rate, seed=seed,
                           interpolation="hermite")
    model = ISTSClassifier("gru", X.shape[-1], X.shape[1], 8,
                           int(y.max()) + 1,
                           generator=torch.Generator().manual_seed(seed))
    return train_ists_model(model, data, y, stratified_split(y, seed=seed),
                            batch_size=16, seed=seed, **kw)


def _same_as_sequential(rec, cells, **kw):
    X, y = R.sweep_data()
    for c, (rate, seed) in enumerate(cells):
        model, tm = sequential(X, y, rate, seed, **kw)
        assert rec["test"][c] == (tm.accuracy, tm.loss, tm.f1_weighted), c
        state = model.state_dict()
        assert rec["state"][c].keys() == state.keys()
        for k, v in state.items():
            assert torch.equal(rec["state"][c][k], v), (c, k)


def test_cells_bit_for_bit_their_sequential_runs(ranks):
    for rec in ranks:
        assert rec["cells"]["devices"] == 2
        assert rec["cells"]["cells"] == R.SWEEP_CELLS
    _same_as_sequential(ranks[0]["cells"], R.SWEEP_CELLS, max_epochs=3,
                        patience=10)


def test_cells_early_stop_parity(ranks):
    """Patience 1 over 6 epochs: every cell stops when its sequential run
    does and restores the same best state."""
    _same_as_sequential(ranks[0]["stop"], R.STOP_CELLS, max_epochs=6,
                        patience=1)


def test_every_rank_holds_every_cell(ranks):
    a, b = ranks[0]["cells"], ranks[1]["cells"]
    assert a["test"] == b["test"]
    for sa, sb in zip(a["state"], b["state"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k])
    for pa, pb in zip(a["splits"], b["splits"]):
        for ia, ib in zip(pa, pb):
            np.testing.assert_array_equal(ia, ib)


def test_a_failed_cell_fails_every_rank(ranks):
    for rec in ranks:
        assert rec["failure"] is not None
        assert "sharded cells failed" in rec["failure"]


def test_single_process_trains_every_cell():
    """Without a process group the one process trains the cells in order;
    extract_cell gives each classifier."""
    X, y = R.sweep_data()
    models, test_ms, info = train_ists_cells_sharded(
        "gru", X, y, R.SWEEP_CELLS[:2], hidden_dim=8, batch_size=16,
        max_epochs=1, device="cpu")
    assert info["devices"] == 1 and len(test_ms) == 2
    assert isinstance(extract_cell(models, 1), ISTSClassifier)
    _, tm = sequential(X, y, *R.SWEEP_CELLS[1], max_epochs=1)
    assert (test_ms[1].accuracy, test_ms[1].loss) == (tm.accuracy, tm.loss)


def _records(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f)) as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = json.load(fh)
    return out


@pytest.fixture(scope="module")
def jax_records(out_dir):
    import jax

    from snsde.harness.robustness import SweepConfig as JaxSweepConfig
    from snsde.harness.sweep_sharded import \
        run_robustness_sweep_sharded as jax_runner
    from snsde.parallel import make_mesh as jax_make_mesh

    kw = {k: v for k, v in R.RUNNER.items() if k != "n"}
    cfg = JaxSweepConfig(out_dir=str(out_dir / "jax"), **kw)
    mesh = jax_make_mesh(("cells",), devices=jax.devices()[:R.WORLD])
    jax_runner(cfg, n=R.RUNNER["n"], mesh=mesh, verbose=False)
    return _records(cfg.out_dir)


def test_runner_records_and_paths_match_jax(ranks, out_dir, jax_records):
    port = _records(out_dir / "port")
    assert port.keys() == jax_records.keys()
    assert len(port) == 4
    for path, rec in port.items():
        assert rec.keys() == jax_records[path].keys(), path
        assert "error" not in rec
        assert rec["cells_sharded"] == jax_records[path]["cells_sharded"] == 2
        for k in ("dataset", "missing_rate", "model", "seed"):
            assert rec[k] == jax_records[path][k]
        assert 0.0 <= rec["accuracy"] <= 1.0
    # every rank returns rank 0's records, in the written order
    assert ranks[0]["runner"] == ranks[1]["runner"]
    assert sorted(json.dumps(r, sort_keys=True) for r in ranks[0]["runner"]) \
        == sorted(json.dumps(r, sort_keys=True) for r in port.values())


def test_runner_resumes_without_retraining(ranks):
    rec = ranks[0]
    assert rec["mtimes"] == rec["mtimes_after"]
    assert rec["resumed"] == rec["runner"]


def test_runner_records_equal_their_sequential_cells(ranks):
    """A runner record's accuracy and F1 are its cell's sequential run's."""
    from snsde_torch.data.synthetic import synthetic_uea

    X, y, _ = synthetic_uea(n=R.RUNNER["n"])
    for rec in ranks[0]["runner"]:
        data = preprocess_ists(X, missing_rate=rec["missing_rate"],
                               seed=rec["seed"], interpolation="hermite")
        model = ISTSClassifier(
            "gru", X.shape[-1], X.shape[1], R.RUNNER["hidden_dim"],
            int(y.max()) + 1,
            generator=torch.Generator().manual_seed(rec["seed"]))
        _, tm = train_ists_model(
            model, data, y, stratified_split(y, seed=rec["seed"]),
            batch_size=R.RUNNER["batch_size"],
            max_epochs=R.RUNNER["max_epochs"], seed=rec["seed"])
        assert (rec["accuracy"], rec["f1_weighted"]) == \
            (float(tm.accuracy), float(tm.f1_weighted))


def test_runner_writes_error_records(tmp_path):
    """An exception of a chunk writes an "error" record for each of its
    cells, and a rerun resumes them."""
    cfg = R.runner_config(str(tmp_path))
    cfg.models = ("no-such-model",)
    cfg.missing_rates = (0.0,)
    recs = run_robustness_sweep_sharded(cfg, n=R.RUNNER["n"], verbose=False,
                                        device="cpu")
    assert len(recs) == 2 and all("error" in r for r in recs)
    assert all(r["model"] == "no-such-model" for r in recs)
    again = run_robustness_sweep_sharded(cfg, n=R.RUNNER["n"],
                                         verbose=False, device="cpu")
    assert again == recs
