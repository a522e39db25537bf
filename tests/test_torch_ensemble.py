"""Seed ensembles (snsde_torch.models.ensemble, train/ensemble_loop.py, the
packed routes of the sepsis and robustness harnesses) against the JAX
package and against the port's own solo models, on the CPU.

Both packages build the ensembles from the same arrays (through
snsde_torch.convert, which carries a JAX InitialValueSeedEnsemble,
SeedEnsemble or ISTSSeedEnsembleSDE leaf by leaf). The members' Brownian
increments (and Lévy areas) are drawn with numpy and handed to each
member's solve on both sides, in member order, through the samplers the
eager solvers call; the readout's dropout is at rate 0 where both sides
run (the two draw different masks). On the CPU the port's packed solve is
each member's own eager solve, as the JAX package's is off its
accelerator. Tolerances: logits and the loss 1e-5 relative, every
gradient 1e-4 of its largest entry, with the floor of ROADMAP "A trap for
parity tests" for the BatchNorm-cancelled readout bias (its true
gradient is 0 and both sides hold float32 noise there).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.fields import DiffusionField as JaxField
from snsde.nn.core import filter_value_and_grad
from snsde.nn.layers import Dropout as JaxDropout
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.harness import classification as tcls
from snsde_torch.harness import robustness as trob
from snsde_torch.harness.classification import (HarnessConfig,
                                                InitialValueModel,
                                                make_sde_model,
                                                run_sepsis_ensemble)
from snsde_torch.models.ensemble import (InitialValueSeedEnsemble,
                                         SeedEnsemble)
from snsde_torch.ops import make_grid
from snsde_torch.train import ensemble_loop as tel
from snsde_torch.train.loop import (TrainConfig, readout_grad_hook,
                                    weight_regularization)

K, B, L, C, H, S = 2, 8, 6, 5, 8, 4


def jax_arrays(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


class _Draws:
    """Hand out pre-drawn arrays in call order (one a member's solve)."""

    def __init__(self, arrays, wrap):
        self.arrays, self.wrap, self.i = list(arrays), wrap, 0

    def __call__(self, *args, **kwargs):
        a = self.arrays[self.i % len(self.arrays)]
        self.i += 1
        return self.wrap(a)


def _inject(monkeypatch, dws, i10s=None):
    """Both packages' eager solvers draw these increments, member by
    member."""
    import snsde.ops.solve as jsolve
    import snsde_torch.ops.solve as tsolve

    monkeypatch.setattr(jsolve, "brownian_increments",
                        _Draws(dws, jnp.asarray))
    monkeypatch.setattr(tsolve, "brownian_increments",
                        _Draws(dws, torch.as_tensor))
    if i10s is not None:
        monkeypatch.setattr(jsolve, "space_time_levy_area",
                            _Draws(i10s, jnp.asarray))
        monkeypatch.setattr(tsolve, "space_time_levy_area",
                            _Draws(i10s, torch.as_tensor))


def _dws(grid, n, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(len(grid) - 1, B, H))
             * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
            for _ in range(n)]


def _grad_check(ours, theirs, floor_names=()):
    assert set(theirs) <= set(ours)
    for name, ref in theirs.items():
        scale = float(np.abs(ref).max())
        if any(name.endswith(f) for f in floor_names):
            # the true gradient is 0: hold it at its sibling weight's scale
            sib = theirs[name[:-len("bias")] + "weight"]
            scale = max(scale, float(np.abs(sib).max()))
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * scale + 1e-8, f"{name}: abs err {err:.2e}"


@pytest.fixture(scope="module")
def sepsis_setup():
    rng = np.random.default_rng(0)
    times = np.arange(L, dtype=np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    coeffs = np.array(jax_hermite(jnp.asarray(times), jnp.asarray(x)))
    static = rng.normal(size=(B, S)).astype(np.float32)
    y = (rng.random(B) < 0.4).astype(np.float32)
    final_index = rng.integers(L // 2, L, size=B).astype(np.int64)
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0
    return dict(times=times, coeffs=coeffs, static=static, y=y,
                final_index=final_index, mask=mask)


def _jax_iv_ensemble(n_members=K):
    from snsde.models.ensemble import InitialValueSeedEnsemble as JaxIVE

    def make_field(k):
        return JaxField.create(k, C, H, H, 2, input_option=4,
                               noise_option=17)

    jm = JaxIVE.create(jax.random.PRNGKey(0), make_field, S, H, 1,
                       n_members)
    return jm.replace(members=tuple(
        m.replace(readout=m.readout.replace(dropout=JaxDropout(rate=0.0)))
        for m in jm.members))


def _port_iv_ensemble(jm):
    make_field = lambda g: DiffusionField(C, H, H, 2, input_option=4,
                                          noise_option=17, generator=g)
    model = InitialValueSeedEnsemble(make_field, S, H, 1, len(jm.members))
    for m in model.members:
        m.readout.dropout.rate = 0.0
    load_jax_arrays(model, jax_arrays(jm))
    return model


def test_initial_value_ensemble_loss_and_every_grad_match_jax(
        monkeypatch, sepsis_setup):
    """The sepsis ensemble's train-mode logits, the ensemble loss (each
    member's masked BCE with pos_weight 10 plus its field's L2 term,
    summed) and every gradient against JAX's, after convert.py."""
    from snsde.train import loop as jloop

    d = sepsis_setup
    grid, _ = make_grid(d["times"], 1.0)
    _inject(monkeypatch, _dws(grid, K))
    jm = _jax_iv_ensemble()
    y, mask = jnp.asarray(d["y"]), jnp.asarray(d["mask"])

    def jax_loss(m):
        logits, _ = m(d["times"], jnp.asarray(d["coeffs"]),
                      jnp.asarray(d["static"]),
                      jnp.asarray(d["final_index"]),
                      key=jax.random.PRNGKey(0), train=True)
        per = jloop.bce_with_logits_per_sample(logits[..., 0], y[None], 10.0)
        ml = jnp.sum(per * mask, 1) / jnp.maximum(jnp.sum(mask), 1.0)
        regs = jnp.stack([jloop.weight_regularization(mm.field, 0.01)
                          for mm in m.members])
        return jnp.sum(ml + regs), logits

    (loss_j, logits_j), g_j = filter_value_and_grad(jax_loss,
                                                    has_aux=True)(jm)
    model = _port_iv_ensemble(jm)
    model.train()
    gens = [torch.Generator() for _ in range(K)]
    logits = model(d["times"], torch.as_tensor(d["coeffs"]),
                   torch.as_tensor(d["static"]),
                   torch.as_tensor(d["final_index"]), generators=gens)
    losses = tel._per_member_loss(logits[..., 0], torch.as_tensor(d["y"]),
                                  torch.as_tensor(d["mask"]), 2, 10.0)
    regs = torch.stack([weight_regularization(model.member_reg(k), 0.01)
                        for k in range(K)])
    loss = (losses + regs).sum()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _grad_check(grads_to_jax_layout(model), jax_arrays(g_j),
                ("readout.linear1.bias",))


def test_seed_ensemble_logits_match_jax(monkeypatch, sepsis_setup):
    """A JAX SeedEnsemble (the speech ensemble's model) carried into the
    port: the same train-mode logits on the same increments."""
    from snsde.models.ensemble import SeedEnsemble as JaxSE

    d = sepsis_setup
    grid, _ = make_grid(d["times"], 1.0)
    _inject(monkeypatch, _dws(grid, K, seed=6))
    jm = JaxSE.create(jax.random.PRNGKey(2),
                      lambda k: JaxField.create(k, C, H, H, 1,
                                                input_option=4,
                                                noise_option=17),
                      C, H, 3, K)
    jm = jm.replace(readouts=tuple(r.replace(dropout=JaxDropout(rate=0.0))
                                   for r in jm.readouts))
    logits_j, _ = jm(d["times"], jnp.asarray(d["coeffs"]),
                     jnp.asarray(d["final_index"]),
                     key=jax.random.PRNGKey(1), train=True)
    model = SeedEnsemble(lambda g: DiffusionField(C, H, H, 1, input_option=4,
                                                  noise_option=17,
                                                  generator=g), C, H, 3, K)
    for r in model.readouts:
        r.dropout.rate = 0.0
    load_jax_arrays(model, jax_arrays(jm))
    model.train()
    logits = model(d["times"], torch.as_tensor(d["coeffs"]),
                   torch.as_tensor(d["final_index"]),
                   generators=[torch.Generator() for _ in range(K)])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)


def test_member_is_the_solo_model_on_its_generator(sepsis_setup):
    """Member k of the ensemble, driven by generator k, is the solo sepsis
    model with member k's weights driven by a generator in the same state:
    the same Brownian increments, then the same dropout mask, so the same
    train-mode logits, bit for bit."""
    d = sepsis_setup
    make_field = lambda g: DiffusionField(C, H, H, 2, input_option=4,
                                          noise_option=17, generator=g)
    model = InitialValueSeedEnsemble(make_field, S, H, 1, K,
                                     generator=torch.Generator()
                                     .manual_seed(0))
    model.train()
    gens = [torch.Generator().manual_seed(40 + k) for k in range(K)]
    args = (d["times"], torch.as_tensor(d["coeffs"]),
            torch.as_tensor(d["static"]), torch.as_tensor(d["final_index"]))
    logits = model(*args, generators=gens)
    for k, m in enumerate(model.members):
        sde, _ = make_sde_model("neurallnsde", C, H, H, 2, 1, initial=False)
        solo = InitialValueModel(S, H, sde)
        solo.linear1.load_state_dict(m.linear1.state_dict())
        solo.linear2.load_state_dict(m.linear2.state_dict())
        solo.sde.func.load_state_dict(m.field.state_dict())
        solo.sde.readout.load_state_dict(m.readout.state_dict())
        solo.train()
        ref = solo(*args, generator=torch.Generator().manual_seed(40 + k))
        assert torch.equal(logits[k], ref), k


def test_member_gradients_are_independent(sepsis_setup):
    """The summed member losses over disjoint parameters: member 0's
    gradients do not move when member 1's weights do, member 1's do
    (tests/test_ensemble.py:29)."""
    d = sepsis_setup
    make_field = lambda g: DiffusionField(C, H, H, 1, input_option=4,
                                          noise_option=17, generator=g)
    model = InitialValueSeedEnsemble(make_field, S, H, 1, K,
                                     generator=torch.Generator()
                                     .manual_seed(0))

    def grads():
        model.zero_grad(set_to_none=True)
        gens = [torch.Generator().manual_seed(k) for k in range(K)]
        logits = model(d["times"], torch.as_tensor(d["coeffs"]),
                       torch.as_tensor(d["static"]),
                       torch.as_tensor(d["final_index"]), generators=gens)
        tel._per_member_loss(logits[..., 0], torch.as_tensor(d["y"]),
                             torch.ones(B), 2, 1.0).sum().backward()
        return [[p.grad.clone() for p in model.member(k).parameters()
                 if p.grad is not None] for k in range(K)]

    base = grads()
    with torch.no_grad():
        model.members[1].field.linear_out.weight += 0.37
    pert = grads()
    for a, b in zip(base[0], pert[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert any(not torch.allclose(a, b) for a, b in zip(base[1], pert[1]))


def _step_setup(sepsis_setup):
    d = sepsis_setup
    make_field = lambda g: DiffusionField(C, H, H, 1, input_option=4,
                                          noise_option=17, generator=g)
    model = InitialValueSeedEnsemble(make_field, S, H, 1, K,
                                     generator=torch.Generator()
                                     .manual_seed(0))
    params = [[p for p in model.member(k).parameters()] for k in range(K)]
    opts = [torch.optim.Adam(ps, lr=1e-2, weight_decay=1e-4)
            for ps in params]
    gens = [torch.Generator().manual_seed(k) for k in range(K)]
    batch = {"coeffs": torch.as_tensor(d["coeffs"]),
             "static": torch.as_tensor(d["static"]),
             "final_index": torch.as_tensor(d["final_index"]),
             "y": torch.as_tensor(d["y"]),
             "_mask": torch.as_tensor(d["mask"])}

    def loss_fn(b):
        logits = model(d["times"], b["coeffs"], b["static"],
                       b["final_index"], generators=gens)[..., 0]
        return tel._per_member_loss(logits, b["y"], b["_mask"], 2, 10.0), \
            logits

    return model, opts, params, loss_fn, batch


def test_an_inactive_member_freezes_while_its_adam_state_advances(
        sepsis_setup):
    """One ensemble step with member 0 stopped: its parameters and
    BatchNorm statistics are exactly those before the step, its Adam state
    has advanced a step (the JAX loop's `upd * active[k]` after
    tx.update), and member 1 trains (tests/test_ensemble.py:205)."""
    model, opts, params, loss_fn, batch = _step_setup(sepsis_setup)
    before = [{n: t.detach().clone()
               for n, t in model.member(k).state_dict().items()}
              for k in range(K)]
    active = np.array([False, True])
    tel.ensemble_step(model, opts, params, loss_fn, batch, active)
    after = [model.member(k).state_dict() for k in range(K)]
    for name, t in before[0].items():
        assert torch.equal(after[0][name], t), name
    assert any(not torch.equal(after[1][n], t) for n, t in before[1].items()
               if "running" in n)
    assert any(not torch.equal(after[1][n], t) for n, t in before[1].items()
               if n.endswith("weight"))
    for k in range(K):
        st = opts[k].state[params[k][0]]
        assert int(st["step"]) == 1 and bool(st["exp_avg"].abs().sum() > 0)


def test_freeze_inactive_rest_pins_bn_buffers(sepsis_setup):
    """freeze_inactive_rest puts back only the stopped members' buffers
    (tests/test_ensemble.py:205)."""
    model, *_ = _step_setup(sepsis_setup)
    before = {k: tel._buffers_of(model, k) for k in range(K)}
    with torch.no_grad():
        for b in model.buffers():
            if b.dtype.is_floating_point:
                b.add_(1.0)
    tel.freeze_inactive_rest(model, np.array([False, True]), before)
    n = 0
    for name, b in model.member(0).named_buffers():
        assert torch.equal(b, before[0][name])
        n += 1
    for name, b in model.member(1).named_buffers():
        if b.dtype.is_floating_point:
            assert torch.equal(b, before[1][name] + 1.0)
    assert n > 0


def test_run_sepsis_ensemble_trains_each_member_on_the_cpu():
    """Two repeats of a tiny sepsis cell for two epochs: one result per
    member with finite metrics and per-member histories and rates, the
    members' weights differ (tests/test_ensemble.py:110, 174), and the
    100x hook's parameters trained."""
    cfg = HarnessConfig(hidden_channels=6, hidden_hidden_channels=6,
                        num_hidden_layers=1, batch_size=32,
                        use_intensity=False)
    results = run_sepsis_ensemble(cfg, repeats=2, n=96, max_epochs=2,
                                  device="cpu")
    assert len(results) == 2
    for res in results:
        assert np.isfinite(res.test_metrics.loss)
        assert 0.0 <= res.test_metrics.accuracy <= 1.0
        assert len(res.history) == 2
        assert all(h["lr"] > 0 for h in res.history)
    m = results[0].model
    assert not torch.equal(m.members[0].field.linear_out.weight,
                           m.members[1].field.linear_out.weight)


def test_run_all_packs_a_cells_repeats(tmp_path):
    """run_all with pack_repeats writes a record a repeat under the cell's
    name and resumes from them."""
    kw = dict(models=("neurallsde",), hidden_list=(6,), layer_list=(1,),
              repeats=2, intensities=(False,), n=80, max_epochs=1,
              results_dir=str(tmp_path), pack_repeats=True, device="cpu")
    got = tcls.run_all(**kw)
    assert [name for name, _ in got] == ["sepsis-neurallsde-h6-l1-i0"] * 2
    recs = sorted((tmp_path / "sepsis-neurallsde-h6-l1-i0").iterdir())
    assert [r.name for r in recs] == ["0", "1"]
    assert "test_metrics" in json.loads(recs[0].read_text())
    assert tcls.run_all(**kw) == []
    with pytest.raises(NotImplementedError, match="item 10"):
        tcls.run_all(task="speech", **{**kw, "results_dir": str(tmp_path)})


def _ists_setup(model_name, rate=0.3, seeds=(0, 1), n=60):
    """Short series (L = 10, 3 channels) as tests/test_torch_robustness.py
    takes: a CDE solve over a rough control amplifies float32 rounding
    with its length."""
    from snsde.data.synthetic import synthetic_uea
    from snsde.harness.robustness import preprocess_ists as jax_pre

    X, y, _ = synthetic_uea(n=n, length=10, channels=3)
    family = trob.coeff_family(model_name)
    datas = [jax_pre(X, missing_rate=rate, seed=s, interpolation=family)
             for s in seeds]
    return X, y, datas


@pytest.mark.parametrize("model_name", ["neuralsde_4_17", "neuralcde"])
def test_ists_seed_ensemble_loss_and_every_grad_match_jax(monkeypatch,
                                                          model_name):
    """ISTSSeedEnsembleSDE, each member on its own seed's missingness and
    control path: train-mode logits, the summed members' masked
    cross-entropy and every gradient against JAX's, after convert.py (the
    SDE members' srk increments injected)."""
    from snsde.harness.robustness import ISTSSeedEnsembleSDE as JaxEns

    X, y, datas = _ists_setup(model_name)
    Bn, classes = 8, int(y.max()) + 1
    seqs = np.stack([d["seq"][:Bn] for d in datas])
    coeffs = np.stack([d["coeffs"][:Bn] for d in datas])
    yb = y[:Bn].astype(np.int64)
    times = np.linspace(0.0, 1.0, X.shape[1]).astype(np.float32)
    if model_name.startswith("neuralsde"):
        grid, _ = make_grid(times, float(np.min(np.diff(times))))
        rng = np.random.default_rng(9)
        dws = [(rng.normal(size=(len(grid) - 1, Bn, H))
                * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
               for _ in range(2)]
        i10s = [0.5 * np.diff(grid)[:, None, None].astype(np.float32) * dw
                for dw in dws]
        _inject(monkeypatch, dws, i10s)
    jm = JaxEns.create(jax.random.PRNGKey(3), model_name, X.shape[-1],
                       X.shape[1], H, classes, 2)

    def jax_loss(m):
        logits, _ = m(jnp.asarray(seqs), jnp.asarray(coeffs),
                      key=jax.random.PRNGKey(0), train=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        per = -jnp.take_along_axis(
            logp, jnp.broadcast_to(jnp.asarray(yb)[None, :, None],
                                   (2, Bn, 1)), axis=-1)[..., 0]
        return jnp.sum(jnp.mean(per, axis=1)), logits

    (loss_j, logits_j), g_j = filter_value_and_grad(jax_loss,
                                                    has_aux=True)(jm)
    model = trob.ISTSSeedEnsembleSDE(model_name, X.shape[-1], X.shape[1], H,
                                     classes, 2)
    load_jax_arrays(model, jax_arrays(jm))
    model.train()
    logits = model(torch.as_tensor(seqs), torch.as_tensor(coeffs),
                   generators=[torch.Generator() for _ in range(2)])
    per = -torch.gather(torch.log_softmax(logits, -1), -1,
                        torch.as_tensor(yb)[None, :, None].expand(2, -1, 1))
    loss = per[..., 0].mean(1).sum()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _grad_check(grads_to_jax_layout(model), jax_arrays(g_j),
                ("inner.linear.bias", "fc1.bias"))


@pytest.mark.parametrize("model_name", ["neuralsde_4_17", "neuralcde",
                                        "gru-ode"])
def test_packed_sweep_cell_writes_a_record_a_seed(tmp_path, model_name):
    """pack_seeds trains a cell's seeds as one ensemble (each seed its own
    split and missingness): a record a seed with `packed` and the
    members' solver, prediction dumps a member, and a second call resumes
    (tests/test_ensemble.py:141, 247)."""
    cfg = trob.SweepConfig(models=(model_name,), missing_rates=(0.3,),
                           seeds=(0, 1), hidden_dim=6, batch_size=16,
                           max_epochs=2, out_dir=str(tmp_path),
                           save_preds=True)
    res = trob.run_robustness_sweep(cfg, n=60, verbose=False,
                                    pack_seeds=True, device="cpu")
    assert len(res) == 2
    for r in res:
        assert "error" not in r, r
        assert r["packed"] == 2 and 0.0 <= r["accuracy"] <= 1.0
        assert r["method"] == ("srk" if model_name.startswith("neuralsde")
                               else "rk4")
    for seed in (0, 1):
        dump = np.load(tmp_path / "synthetic_uea" / "30"
                       / f"{model_name}_{seed}.npz")
        assert (dump["y_pred"] == dump["logits"].argmax(-1)).all()
    assert len(trob.run_robustness_sweep(cfg, n=60, verbose=False,
                                         pack_seeds=True,
                                         device="cpu")) == 2


def test_packed_sweep_error_writes_only_the_unwritten_records(
        tmp_path, monkeypatch):
    """An exception after member 0's record is written (here, member 1's
    prediction dump) becomes an error record for member 1 alone
    (robustness.py:388-399)."""
    calls = []
    real = trob.predict_ists

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("dump failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(trob, "predict_ists", failing)
    cfg = trob.SweepConfig(models=("neuralsde_4_17",), missing_rates=(0.0,),
                           seeds=(0, 1), hidden_dim=6, batch_size=16,
                           max_epochs=1, out_dir=str(tmp_path),
                           save_preds=True)
    res = trob.run_robustness_sweep(cfg, n=60, verbose=False,
                                    pack_seeds=True, device="cpu")
    assert [("error" in r) for r in res] == [False, True]
    assert "dump failed" in res[1]["error"]


def test_packed_sweep_members_see_their_own_data():
    """train_ists_ensemble: member k trains on seed k's missingness and
    split, and the members end with different weights
    (tests/test_ensemble.py:183)."""
    from snsde_torch.data.common import stratified_split
    from snsde_torch.data.synthetic import synthetic_uea

    X, y, _ = synthetic_uea(n=60)
    datas = [trob.preprocess_ists(X, missing_rate=0.5, seed=s)
             for s in (0, 1)]
    assert not np.allclose(datas[0]["seq"], datas[1]["seq"])
    splits = [stratified_split(y, seed=s) for s in (0, 1)]
    model = trob.ISTSSeedEnsembleSDE("neuralsde_2_16", X.shape[-1],
                                     X.shape[1], 6, int(y.max()) + 1, 2,
                                     generator=torch.Generator()
                                     .manual_seed(0))
    model, test_ms = trob.train_ists_ensemble(model, datas, y, splits,
                                              batch_size=16, max_epochs=2)
    assert len(test_ms) == 2 and all(np.isfinite(m.loss) for m in test_ms)
    assert not torch.equal(model.members[0].fc2.weight,
                           model.members[1].fc2.weight)


def test_member_generators_are_fixed_by_the_seed():
    """The members' generators: one a member, each its own stream, the
    same for the same seed."""
    a = [torch.randn(3, generator=g)
         for g in tel.member_generators(0, 3, "cpu")]
    b = [torch.randn(3, generator=g)
         for g in tel.member_generators(0, 3, "cpu")]
    c = [torch.randn(3, generator=g)
         for g in tel.member_generators(1, 3, "cpu")]
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


def test_the_readout_hook_scales_only_a_members_last_linear(sepsis_setup):
    """readout_grad_hook("readout.linear2") on each member scales exactly
    that member's last readout linear by 100."""
    d = sepsis_setup
    make_field = lambda g: DiffusionField(C, H, H, 1, input_option=4,
                                          noise_option=17, generator=g)

    def grads(hook):
        torch.manual_seed(0)
        model = InitialValueSeedEnsemble(make_field, S, H, 1, K,
                                         generator=torch.Generator()
                                         .manual_seed(0))
        handles = []
        if hook:
            for k in range(K):
                handles += readout_grad_hook("readout.linear2")(
                    model.member(k))
        logits = model(d["times"], torch.as_tensor(d["coeffs"]),
                       torch.as_tensor(d["static"]),
                       torch.as_tensor(d["final_index"]),
                       generators=[torch.Generator().manual_seed(k)
                                   for k in range(K)])
        logits.sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    plain, hooked = grads(False), grads(True)
    for name, g in plain.items():
        want = 100.0 * g if "readout.linear2" in name else g
        torch.testing.assert_close(hooked[name], want, rtol=1e-6, atol=0)


def test_fit_classifier_ensemble_takes_a_multiclass_loss():
    """The multiclass loss of the ensemble loop is each member's masked
    mean cross-entropy."""
    logits = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 2, 1, 1, 0])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0])
    got = tel._per_member_loss(logits, y, mask, 3, 1.0)
    for k in range(2):
        ce = torch.nn.functional.cross_entropy(logits[k], y,
                                               reduction="none")
        torch.testing.assert_close(got[k], (ce * mask).sum() / mask.sum())


def test_fit_classifier_ensemble_returns_a_result_a_member(sepsis_setup):
    """fit_classifier_ensemble on a tiny ensemble for two epochs: a result
    a member, each model the ensemble with every member restored."""
    d = sepsis_setup
    make_field = lambda g: DiffusionField(C, H, H, 1, input_option=4,
                                          noise_option=17, generator=g)
    model = InitialValueSeedEnsemble(make_field, S, H, 1, K,
                                     generator=torch.Generator()
                                     .manual_seed(0))
    data = {"coeffs": d["coeffs"], "static": d["static"],
            "final_index": d["final_index"], "y": d["y"]}

    def apply_fn(m, batch, gens):
        return m(d["times"], batch["coeffs"], batch["static"],
                 batch["final_index"], generators=gens)[..., 0]

    res = tel.fit_classifier_ensemble(
        model, apply_fn, data, data, None,
        TrainConfig(batch_size=4, max_epochs=2, pos_weight=10.0,
                    verbose=False),
        member_grad_hook=readout_grad_hook("readout.linear2"))
    assert len(res) == K and res[0].model is model
    assert all(r.test_metrics is None and len(r.history) == 2 for r in res)
