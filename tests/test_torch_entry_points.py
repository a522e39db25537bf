"""The port's entry points against the JAX package, on the CPU:
`snsde_torch.configs` (JSON both ways, dotted argv, the dispatch of each
task), `make_model`'s baseline twins (forward and every gradient, weights
carried across), and the ASHA search (`sample_config`'s sequence, the
trial records under a shared stub score, a packed member's initial
weights, a real tiny search).

The twins are held as tests/torch_zoo.py holds the model zoo: outputs to
1e-5 of max(1, the reference's largest entry) (tests/test_torch_gruode.py's
bar: the GRU-ODE field amplifies), each gradient to 1e-4 of its scale; the port runs its eager loop
and its fused route (the kernels' plain versions), the JAX package its
scan. JAX's own `asha_search` runs only under the stub score (no JAX
training), to keep the file to a few seconds of JAX work.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import copy
import dataclasses
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde import configs as jcfg
from snsde.harness import classification as jcls
from snsde.harness import param_search as jps
from snsde.ops.interp import hermite_cubic_coeffs

from snsde_torch import configs as tcfg
from snsde_torch.data.synthetic import synthetic_uea
from snsde_torch.harness import classification as tcls
from snsde_torch.harness import param_search as tps
from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.models import neuralcde as tcde
from snsde_torch.models import rnn as trnn

from torch_zoo import (assert_close, assert_grads_match, carry,
                       jax_value_and_grads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("sepsis", "speech", "mujoco", "interpolation", "sweep")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _jax_config():
    """A JAX ExperimentConfig off its defaults in every section."""
    c = jcfg.ExperimentConfig()
    return dataclasses.replace(
        c, task="mujoco", seed=3, n_samples=77, results_dir="res",
        classification=dataclasses.replace(
            c.classification, model_name="neuralgsde", hidden_channels=12,
            data_seed=5),
        forecasting=dataclasses.replace(c.forecasting, lr=3e-4,
                                        method="srk", npy_path="x.npy"),
        interpolation=dataclasses.replace(c.interpolation, dec="rnn3",
                                          niters=7),
        sweep=dataclasses.replace(c.sweep, models=("gru", "neuralcde"),
                                  missing_rates=(0.3,), seeds=(1, 2),
                                  method="rk4"))


def test_config_fields_match_jax():
    for name in ("ExperimentConfig", "HarnessConfig", "ForecastConfig",
                 "InterpolationConfig", "SweepConfig"):
        jf = [f.name for f in dataclasses.fields(getattr(jcfg, name))]
        tf = [f.name for f in dataclasses.fields(getattr(tcfg, name))]
        assert jf == tf, name


def test_json_round_trips_between_the_packages():
    text = jcfg.to_json(_jax_config())
    ours = tcfg.from_json(text)
    assert tcfg.to_json(ours) == text
    assert ours.sweep.models == ("gru", "neuralcde")
    assert jcfg.to_json(jcfg.from_json(tcfg.to_json(ours))) == text
    assert tcfg.to_json(tcfg.ExperimentConfig()) == jcfg.to_json(
        jcfg.from_json(tcfg.to_json(tcfg.ExperimentConfig())))


def test_from_args_on_dotted_keys():
    argv = ["--task", "sweep", "--seed", "4",
            "--classification.model_name", "neuralgsde",
            "--forecasting.lr", "3e-4", "--sweep.models", '["gru", "rnn"]',
            "--interpolation.save_dir", "ckpt", "--unknown", "1"]
    ours = tcfg.from_args(argv)
    assert tcfg.to_json(ours) == jcfg.to_json(jcfg.from_args(argv))
    assert ours.sweep.models == ("gru", "rnn")
    assert ours.forecasting.lr == 3e-4
    with pytest.raises(ValueError, match="unexpected argument"):
        tcfg.from_args(["task", "sepsis"])


@pytest.mark.parametrize("task", TASKS)
def test_run_dispatches_as_jax(task, monkeypatch):
    """Each task reaches its harness with the config JAX's run hands it
    (the seed, and for sepsis and speech the results_dir, put in) and the
    sample count; the port also passes the device."""
    import snsde.harness.forecasting as jf
    import snsde.harness.interpolation as ji
    import snsde.harness.robustness as jr
    import snsde_torch.harness.forecasting as tf
    import snsde_torch.harness.interpolation as ti
    import snsde_torch.harness.robustness as tr

    fn = {"sepsis": "run_sepsis", "speech": "run_speech",
          "mujoco": "run_mujoco", "interpolation": "run_interpolation",
          "sweep": "run_robustness_sweep"}[task]
    calls = {}
    for side, mods in (("jax", (jcls, jf, ji, jr)),
                       ("port", (tcls, tf, ti, tr))):
        for mod in mods:
            if hasattr(mod, fn):
                monkeypatch.setattr(
                    mod, fn, lambda cfg, n, side=side, **kw: calls.setdefault(
                        side, (dataclasses.asdict(cfg), n, kw)))
    cfg = dataclasses.replace(_jax_config(), task=task)
    jcfg.run(cfg)
    tcfg.run(tcfg.from_json(jcfg.to_json(cfg)), device="cpu")
    assert calls["port"][:2] == calls["jax"][:2]
    assert calls["port"][2] == {"device": "cpu"}
    if task != "sweep":                  # SweepConfig has seeds of its own
        assert calls["port"][0]["seed"] == 3
    with pytest.raises(ValueError, match="unknown task"):
        tcfg.run(tcfg.ExperimentConfig(task="bogus"))


def test_main_takes_the_device(monkeypatch):
    seen = {}
    monkeypatch.setattr(tcfg, "run", lambda cfg, device=None: seen.update(
        cfg=cfg, device=device))
    tcfg.main(["--task", "sweep", "--device", "cpu", "--n_samples", "9"])
    assert seen["device"] == "cpu" and seen["cfg"].n_samples == 9
    tcfg.main(["--task", "sweep"])
    assert seen["device"] is None


# ---------------------------------------------------------------------------
# make_model's baseline twins
# ---------------------------------------------------------------------------

B, L, C, H = 8, 12, 7, 8
TWINS = ("ncde", "gruode", "dt", "decay", "odernn")


def _intensity_batch(seed=5):
    """A [t ‖ 3 cumulative intensities ‖ 3 values] stream (C = 7) at
    irregular times with sparse observations, its Hermite coefficients
    and a final index a row."""
    rng = np.random.default_rng(seed)
    K = (C - 1) // 2
    times = np.sort(rng.uniform(0, 1, L)).astype(np.float32)
    obs = (rng.random((B, L, K)) < 0.4).astype(np.float32)
    vals = rng.normal(size=(B, L, K)).astype(np.float32)
    X = np.concatenate([np.broadcast_to(times[None, :, None], (B, L, 1)),
                        np.cumsum(obs, axis=1), vals], axis=-1)
    coeffs = np.asarray(hermite_cubic_coeffs(jnp.asarray(times),
                                             jnp.asarray(X)))
    fin = rng.integers(L // 2, L, size=B)
    return times, coeffs, fin


def _port_route(monkeypatch, name):
    """Send the port's CPU tensors through the fused route (the kernels'
    plain versions), counting it."""
    calls = []
    if name in ("ncde", "gruode"):
        def route(path, func, z0, ts, *, dt, method, use_fused=True):
            calls.append(1)
            return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)
        monkeypatch.setattr(tcde, "cde_solve_dispatch", route)
    else:
        monkeypatch.setattr(trnn._ObservationGRUBase, "_kernels_take",
                            lambda self, x, use_fused: (calls.append(1),
                                                        True)[1])
    return calls


@pytest.mark.parametrize("name", TWINS)
@pytest.mark.parametrize("route", ["eager", "fused"])
def test_make_model_twin_matches_jax(name, route, monkeypatch):
    times, coeffs, fin = _intensity_batch()
    use_int = name == "decay"
    jm, jreg = jcls.make_model(jax.random.PRNGKey(2), name, C, H, H, 2, 2,
                               use_intensity=use_int)
    tm, treg = tcls.make_model(name, C, H, H, 2, 2, use_intensity=use_int)
    carry(jm, tm)
    assert treg(tm) is (tm.func if name in ("ncde", "gruode") else tm)
    rnn = name in ("dt", "decay", "odernn")

    def jloss(m):
        if rnn:
            logits, outs = m(times, jnp.asarray(coeffs), fin)
            return jnp.sum(logits ** 2) + jnp.sum(outs ** 2), logits
        logits, _ = m(times, jnp.asarray(coeffs), fin, train=False)
        return jnp.sum(logits ** 2), logits

    want, g_j = jax_value_and_grads(jloss, jm)
    calls = _port_route(monkeypatch, name) if route == "fused" else None
    tm.eval()
    if route == "fused":         # the final indices as a tensor, as a
        fin = torch.as_tensor(fin)  # device batch hands them over
    if rnn:
        logits, outs = tm(times, torch.as_tensor(coeffs), fin)
        loss = (logits ** 2).sum() + (outs ** 2).sum()
    else:
        logits = tm(times, torch.as_tensor(coeffs), fin)
        loss = (logits ** 2).sum()
    loss.backward()
    assert calls is None or calls
    # an absolute bar of max(1, the reference's largest entry): the GRU-ODE
    # field amplifies (tests/test_torch_gruode.py's rule)
    assert_close(logits, want, name=name,
                 atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert_grads_match(tm, g_j)


@pytest.mark.parametrize("name", ["dt", "decay", "odernn"])
def test_make_model_rejects_an_even_channel_count(name):
    with pytest.raises(ValueError, match="odd channel count"):
        tcls.make_model(name, 6, H, H, 1, 2)


def test_make_model_builds_the_sde_grid():
    m, reg = tcls.make_model("neuralsde_4_17", C, H, H, 2, 2)
    assert (m.func.input_option, m.func.noise_option) == (4, 17)
    assert reg(m) is m.func


# ---------------------------------------------------------------------------
# the ASHA search
# ---------------------------------------------------------------------------

def test_sample_config_sequence_matches_jax_and_the_artifact():
    """The trial configs of tools/run_asha_search.py's setting (seed 0, 8
    samples) are JAX's sequence and ASHA_SEARCH.json's."""
    space = tps.SearchSpace()
    assert dataclasses.asdict(space) == dataclasses.asdict(jps.SearchSpace())
    for seed in (0, 3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        ours = [tps.sample_config(r1, space) for _ in range(8)]
        assert ours == [jps.sample_config(r2, jps.SearchSpace())
                        for _ in range(8)]
    with open(os.path.join(REPO, "ASHA_SEARCH.json")) as f:
        artifact = json.load(f)
    rng = np.random.default_rng(0)
    ours = [tps.sample_config(rng, space) for _ in range(8)]
    for rec in artifact.values():
        assert [t["config"] for t in rec["trials"]] == ours


def _uea(n=64):
    X, y, _ = synthetic_uea(n=n, length=8, channels=2, num_classes=4,
                            seed=10)
    return X, y


def _stub_score(lr, budget):
    """A deterministic accuracy of (trial, budget) with ties."""
    return (int(lr * 1e4) % 3) / 4 + budget / 100


def _install_stubs(monkeypatch, log=None):
    """Both packages' trainers replaced by _stub_score; `log` collects the
    port's calls ((trial lrs, budget, packed?, seed))."""
    M = lambda a: types.SimpleNamespace(accuracy=a)

    def j_solo(key, model, data, y, splits, lr, **kw):
        return model, M(_stub_score(lr, kw["max_epochs"]))

    def j_pack(key, model, datas, y, splits_list, lrs, **kw):
        return model, [M(_stub_score(lr, kw["max_epochs"])) for lr in lrs]

    def t_solo(model, data, y, splits, lr, **kw):
        if log is not None:
            log.append(((lr,), kw["max_epochs"], False, kw["seed"]))
        return model, M(_stub_score(lr, kw["max_epochs"]))

    def t_pack(model, datas, y, splits_list, lrs, **kw):
        if log is not None:
            log.append((tuple(lrs), kw["max_epochs"], True, kw["seed"]))
        return model, [M(_stub_score(lr, kw["max_epochs"])) for lr in lrs]

    # JAX's classifiers are built but never trained under the stub: a
    # stand-in skips their initialisation's compiles
    stand_in = types.SimpleNamespace(layer=types.SimpleNamespace(
        inner=types.SimpleNamespace(method="srk")))
    monkeypatch.setattr(jps.ISTSClassifier, "create",
                        staticmethod(lambda *a, **k: stand_in))
    monkeypatch.setattr(jps, "ISTSSeedEnsembleSDE",
                        lambda members, method: members)
    monkeypatch.setattr(jps, "train_ists_model", j_solo)
    monkeypatch.setattr(jps, "train_ists_ensemble", j_pack)
    monkeypatch.setattr(tps, "train_ists_model", t_solo)
    monkeypatch.setattr(tps, "train_ists_ensemble", t_pack)


@pytest.mark.parametrize("name,pack", [("neuralsde_4_17", True),
                                       ("gru", False)])
def test_asha_records_match_jax_under_a_stub_score(name, pack, tmp_path,
                                                   monkeypatch):
    """tools/run_asha_search.py's setting (8 samples, rungs (2, 5, 12),
    seed 0) with both trainers replaced by one score of (trial, budget):
    the trial records, survivors, best config and the JSON file are
    JAX's; the packed rung 0 trains (64, 4) and (64, 1) as groups of
    two."""
    X, y = _uea()
    log = []
    _install_stubs(monkeypatch, log)
    jout, tout = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    want = jps.asha_search(name, X, y, seed=0, pack=pack, out_path=jout)
    got = tps.asha_search(name, X, y, seed=0, pack=pack, out_path=tout,
                          device="cpu")
    assert got == want
    with open(jout) as a, open(tout) as b:
        assert a.read() == b.read()
    rung0 = [e for e in log if e[1] == 2]
    if pack:
        assert sorted(len(e[0]) for e in rung0 if e[2]) == [2, 2]
        assert sum(len(e[0]) for e in rung0) == 8
    else:
        assert len(rung0) == 8 and not any(e[2] for e in log)
    lrs = [t["config"]["lr"] for t in got["trials"]]
    for lrs_e, _, _, seed in log:
        assert seed == lrs.index(lrs_e[0])          # seed * 1000 + ti, seed 0
    # each rung retrains its survivors for the rung's whole budget
    assert sorted({e[1] for e in log}) == [2, 5, 12]


def test_asha_pruning_keeps_trial_order_on_ties(monkeypatch):
    X, y = _uea()
    monkeypatch.setattr(tps, "train_ists_model", lambda m, *a, **k: (
        m, types.SimpleNamespace(accuracy=0.5)))
    got = tps.asha_search("gru", X, y, num_samples=4, rungs=(1, 1),
                          space=tps.SearchSpace(hidden_choices=(4,),
                                                layer_choices=(1,)),
                          device="cpu")
    assert [t["alive"] for t in got["trials"]] == [True, False, False, False]
    assert got["best_config"] == got["trials"][0]["config"]


def test_packed_member_starts_from_its_solo_weights(monkeypatch):
    """Member k of a packed group starts from the weights its trial's solo
    run starts from (drawn from seed * 1000 + ti)."""
    X, y = _uea()
    seen = {"solo": {}, "packed": {}}
    score = types.SimpleNamespace(accuracy=0.5)

    def solo(model, data, y, splits, lr, **kw):
        seen["solo"].setdefault(lr, copy.deepcopy(model.state_dict()))
        return model, score

    def pack(model, datas, y, splits_list, lrs, **kw):
        for lr, m in zip(lrs, model.members):
            seen["packed"].setdefault(lr, copy.deepcopy(m.state_dict()))
        return model, [score] * len(lrs)

    monkeypatch.setattr(tps, "train_ists_model", solo)
    monkeypatch.setattr(tps, "train_ists_ensemble", pack)
    space = tps.SearchSpace(hidden_choices=(4, 6), layer_choices=(1,))
    for packed in (True, False):
        tps.asha_search("neuralsde_4_17", X, y, num_samples=5, rungs=(1,),
                        space=space, pack=packed, seed=2, device="cpu")
    assert len(seen["packed"]) >= 2
    for lr, state in seen["packed"].items():
        solo_state = seen["solo"][lr]
        assert state.keys() == solo_state.keys()
        for k in state:
            assert torch.equal(state[k], solo_state[k]), k


@pytest.mark.parametrize("name,pack", [("gru", False),
                                       ("neuralsde_4_17", True),
                                       ("neuralcde", True)])
def test_a_real_tiny_search(name, pack, tmp_path):
    """n=64, L=8, C=2, three samples of one width, rungs (1, 2): rung 0
    packs all three trials of the SDE and CDE names, rung 1 trains the
    survivor solo; scores are accuracies and the JSON is written."""
    X, y = _uea()
    out = str(tmp_path / "asha.json")
    got = tps.asha_search(name, X, y, num_samples=3, rungs=(1, 2),
                          space=tps.SearchSpace(hidden_choices=(4,),
                                                layer_choices=(1,)),
                          pack=pack, batch_size=32, out_path=out,
                          device="cpu")
    scores = [t["score"] for t in got["trials"]]
    assert all(0.0 <= s <= 1.0 for s in scores)
    assert [t["alive"] for t in got["trials"]].count(True) == 1
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))


def test_known_fault_asha_scores_on_test_accuracy(monkeypatch):
    """A fault of the reference that both packages keep: ASHA prunes on
    the TEST split's accuracy (snsde/harness/param_search.py:91,115 read
    the metrics `train_ists_model` and `train_ists_ensemble` return, which
    are the test split's), while its docstring (:5-8) says validation
    accuracy. On the port, each trial's score is the accuracy of its
    trained classifier on the test split."""
    assert "prune" in jps.__doc__ and "validation accuracy" in jps.__doc__
    src = inspect.getsource(jps.asha_search)
    assert 'trials[ti]["score"] = test_m.accuracy' in src
    assert 'trials[ti]["score"] = tm.accuracy' in src
    assert "TEST accuracy" in " ".join(tps.__doc__.split())
    from snsde_torch.harness.robustness import predict_ists

    X, y = _uea()
    real = tps.train_ists_model
    test_acc = {}

    def wrapped(model, data, yy, splits, lr, **kw):
        model, test_m = real(model, data, yy, splits, lr, **kw)
        yt, yp, _ = predict_ists(model, data, yy, splits[2])
        test_acc[lr] = float(np.mean(yt == yp))
        return model, test_m

    monkeypatch.setattr(tps, "train_ists_model", wrapped)
    got = tps.asha_search("gru", X, y, num_samples=3, rungs=(1,),
                          space=tps.SearchSpace(hidden_choices=(4,),
                                                layer_choices=(1,)),
                          batch_size=32, device="cpu")
    for t in got["trials"]:
        assert t["score"] == pytest.approx(test_acc[t["config"]["lr"]])


def test_asha_search_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _uea()
    with pytest.raises(RuntimeError, match="CUDA"):
        tps.asha_search("gru", X, y, num_samples=1, rungs=(1,))
