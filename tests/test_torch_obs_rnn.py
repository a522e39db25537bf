"""The ODE-RNN hybrids of the port (`gru-dt`, `gru-d`, `ode-rnn`,
`ode-lstm`: models/rnn.py GRUdt, GRUD, ODERNN and models/time_rnn.py
ODELSTM) against the JAX package, on the CPU.

Each name is built by both registries, its weights carried over by
snsde_torch.convert, and run on the same batch: the loss (a sum of
squares of the layer's output stream) and every leaf's gradient are
compared. The JAX side runs its scan and its fused path (the TPU gate
forced open, the Pallas kernels in interpret mode); the port runs its
eager loop and its fused route (the kernels' plain versions behind the
autograd.Functions, the route a CUDA tensor takes to the kernels).
Tolerances are those the JAX package holds its own fused path to its scan
(tests/test_fused_rnn.py): rtol 3e-4, atol 3e-6 for the GRU family; rtol
5e-4, atol 5e-6 for ODE-LSTM.

The registry hands the observation GRUs the sweep's plain (t ‖ values)
coefficients and declares the largest odd width, so channels 1..K (the
first K values) are read as cumulative intensities: a step counts as
observed where such a value rose by more than 0.5 between knots. That is
the reference registry's own behaviour (snsde/registry.py:369-386), which
the port reproduces and `test_registry_reads_values_as_intensities`
pins. The model-level case feeds a true intensity stream, with sparse
observation patterns.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde import registry as jreg
from snsde.harness import robustness as jrob
from snsde.models import rnn as jrnn
from snsde.nn.core import filter_value_and_grad
from snsde.ops.interp import hermite_cubic_coeffs

from snsde_torch import registry as treg
from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.models import rnn as trnn
from snsde_torch.models import time_rnn as ttime

N, L, D, HID = 6, 11, 4, 6
TOLS = {"gru-dt": (3e-4, 3e-6), "gru-d": (3e-4, 3e-6),
        "ode-rnn": (3e-4, 3e-6), "ode-lstm": (5e-4, 5e-6)}


def _key(path):
    return ".".join(k.name if isinstance(k, jax.tree_util.GetAttrKey)
                    else str(k.idx) for k in path
                    if not isinstance(k, jax.tree_util.FlattenedIndexKey))


def jax_arrays(tree):
    return {_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")


def _jax_fused(monkeypatch):
    """Open the JAX package's TPU gate at every width, and count its fused
    scans."""
    import snsde.kernels.fused_rnn as jfr

    calls = []
    for name in ("fused_gru_scan", "fused_lstm_scan"):
        real = getattr(jfr, name)
        monkeypatch.setattr(jfr, name, lambda *a, real=real, **k: (
            calls.append(1), real(*a, **k))[1])
    monkeypatch.setenv("SNSDE_FUSED_RNN_MIN_H", "0")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


def _port_fused(monkeypatch):
    """Send the port's CPU tensors through the fused route, counting it."""
    calls = []
    for cls in (trnn._ObservationGRUBase, ttime.ODELSTM):
        monkeypatch.setattr(cls, "_kernels_take",
                            lambda self, x, use_fused: (calls.append(1),
                                                        True)[1])
    return calls


def _batch(seed=0, rate=0.3):
    X, _, _ = synthetic_uea(n=N, length=L, channels=D, num_classes=2,
                            seed=seed)
    data = trob.preprocess_ists(X, rate, interpolation="natural", seed=seed)
    return data["seq"], data["coeffs"]


def _jax_loss_grads(layer, seq, coeffs):
    def loss(m):
        out, hn = m(jnp.asarray(seq), jnp.asarray(coeffs))
        return jnp.sum(out ** 2) + jnp.sum(hn ** 2)

    l, g = filter_value_and_grad(loss)(layer)
    return float(l), jax_arrays(g)


def _port_loss_grads(layer, seq, coeffs):
    layer.zero_grad()
    out, hn = layer(torch.as_tensor(seq), torch.as_tensor(coeffs))
    loss = (out ** 2).sum() + (hn ** 2).sum()
    loss.backward()
    return float(loss), grads_to_jax_layout(layer)


def _close(name, what, ours, theirs, rtol, atol):
    assert set(ours) == set(theirs), (what, set(ours) ^ set(theirs))
    for k, ref in theirs.items():
        np.testing.assert_allclose(ours[k], ref, rtol=rtol, atol=atol,
                                   err_msg=f"{name} {what} {k}")


@pytest.mark.parametrize("name", ["gru-dt", "gru-d", "ode-rnn", "ode-lstm"])
def test_registry_layer_matches_jax(name, monkeypatch):
    """The registry's layer of each name: loss and every leaf's gradient,
    port eager and fused against JAX scan and fused."""
    seq, coeffs = _batch()
    jl = jreg.make_seq_layer(jax.random.PRNGKey(3), name, D, L, HID,
                             num_hidden_layers=2)
    tl = treg.make_seq_layer(name, D, L, HID, num_hidden_layers=2)
    load_jax_arrays(tl, jax_arrays(jl))
    rtol, atol = TOLS[name]
    want = {"scan": _jax_loss_grads(jl, seq, coeffs)}
    with monkeypatch.context() as m:
        calls = _jax_fused(m)
        want["fused"] = _jax_loss_grads(jl, seq, coeffs)
        assert calls, "the JAX fused path did not run"
    got = {"eager": _port_loss_grads(tl, seq, coeffs)}
    with monkeypatch.context() as m:
        calls = _port_fused(m)
        got["fused"] = _port_loss_grads(tl, seq, coeffs)
        assert calls, "the port's fused route did not run"
    for (gk, (gl, gg)) in got.items():
        for (wk, (wl, wg)) in want.items():
            np.testing.assert_allclose(gl, wl, rtol=rtol,
                                       err_msg=f"{name} {gk} vs {wk}")
            _close(name, f"{gk} vs {wk}", gg, wg, rtol, atol)


def _intensity_coeffs(seed, K=3, B=5, L=11):
    """A true [t ‖ K cumulative intensities ‖ K values] stream over
    irregular times, with sparse observation patterns (as
    tests/test_fused_rnn.py:125-183), and its Hermite coefficients."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, 1, L)).astype(np.float32)
    obs = (rng.random((B, L, K)) < 0.4).astype(np.float32)
    vals = rng.normal(size=(B, L, K)).astype(np.float32)
    X = np.concatenate([np.broadcast_to(times[None, :, None], (B, L, 1)),
                        np.cumsum(obs, axis=1), vals], axis=-1)
    coeffs = np.asarray(hermite_cubic_coeffs(jnp.asarray(times),
                                             jnp.asarray(X)))
    return times, coeffs, 2 * K + 1


@pytest.mark.parametrize("name,kw", [
    ("gru-dt", {}), ("gru-d", {}), ("gru-d", {"use_intensity": True}),
    ("ode-rnn", {"hidden_hidden_channels": 5, "num_hidden_layers": 2,
                 "ode_steps": 2})])
def test_observation_grus_match_jax_on_intensity_streams(name, kw,
                                                         monkeypatch):
    """GRUdt, GRUD and ODERNN on a true intensity stream at irregular
    times, from a nonzero z0 with a final index per row: the readout and
    the stream, and every gradient, against the JAX scan and fused path."""
    times, coeffs, C = _intensity_coeffs(seed=5)
    jcls, tcls = {"gru-dt": (jrnn.GRUdt, trnn.GRUdt),
                  "gru-d": (jrnn.GRUD, trnn.GRUD),
                  "ode-rnn": (jrnn.ODERNN, trnn.ODERNN)}[name]
    jm = jcls.create(jax.random.PRNGKey(7), C, HID, 2, **kw)
    tm = tcls(C, HID, 2, **kw)
    load_jax_arrays(tm, jax_arrays(jm))
    B = coeffs.shape[0]
    fin = np.array([10, 4, 7, 10, 0])[:B]
    z0 = np.random.default_rng(6).normal(size=(B, HID)).astype(np.float32)

    def jloss(m):
        logits, outs = m(times, jnp.asarray(coeffs), fin,
                         z0=jnp.asarray(z0))
        return jnp.sum(logits ** 2) + jnp.sum(outs ** 2)

    want = {"scan": filter_value_and_grad(jloss)(jm)}
    with monkeypatch.context() as m:
        calls = _jax_fused(m)
        want["fused"] = filter_value_and_grad(jloss)(jm)
        assert calls
    got = {}
    for route in ("eager", "fused"):
        with monkeypatch.context() as m:
            calls = _port_fused(m) if route == "fused" else None
            tm.zero_grad()
            logits, outs = tm(times, torch.as_tensor(coeffs), fin,
                              z0=torch.as_tensor(z0))
            loss = (logits ** 2).sum() + (outs ** 2).sum()
            loss.backward()
            assert calls is None or calls
        got[route] = (float(loss), grads_to_jax_layout(tm))
    rtol, atol = TOLS[name]
    for gk, (gl, gg) in got.items():
        for wk, (wl, wg) in want.items():
            np.testing.assert_allclose(gl, float(wl), rtol=rtol)
            _close(name, f"{gk} vs {wk}", gg, jax_arrays(wg), rtol, atol)


def test_odelstm_solvers_match_jax():
    """ODELSTM's heun and rk4 (the eager loop on every device, as in JAX)
    and euler with two substeps: the stream and every gradient."""
    from snsde.models.time_rnn import ODELSTM as JaxODELSTM

    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 9, 3)).astype(np.float32)
    ts = rng.uniform(0.1, 1.0, (5, 9)).astype(np.float32)
    for solver, steps in (("heun", 1), ("rk4", 2), ("euler", 2)):
        jm = JaxODELSTM.create(jax.random.PRNGKey(9), 3, HID, solver=solver,
                               ode_steps=steps)
        tm = ttime.ODELSTM(3, HID, solver=solver, ode_steps=steps)
        load_jax_arrays(tm, jax_arrays(jm))
        (jl, jh), jg = filter_value_and_grad(
            lambda m: (jnp.sum(m(jnp.asarray(x), jnp.asarray(ts)) ** 2),
                       m(jnp.asarray(x), jnp.asarray(ts))),
            has_aux=True)(jm)
        hs = tm(torch.as_tensor(x), torch.as_tensor(ts))
        (hs ** 2).sum().backward()
        np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jh),
                                   rtol=5e-4, atol=5e-6)
        _close("ode-lstm", solver, grads_to_jax_layout(tm), jax_arrays(jg),
               5e-4, 5e-6)


def test_registry_reads_values_as_intensities(monkeypatch):
    """With the sweep's plain (t ‖ values) coefficients the registry's
    observation GRUs take the largest odd width (5 channels of D + 1 = 5 at
    D = 4; 3 of 4 at D = 3) and read the first K values as cumulative
    intensities (snsde/registry.py:369-386): the mask the fused route
    hands the kernels is "a value among the first K rose by more than 0.5
    since the last knot" (the spline at the knots, missing values
    interpolated), not the data's observation mask."""
    for d, ic in ((4, 5), (3, 3)):
        layer = treg.make_seq_layer("gru-dt", d, L, HID)
        assert layer.inner.input_channels == ic
    seq, coeffs = _batch(seed=2)
    layer = treg.make_seq_layer("gru-dt", D, L, HID)
    K = (layer.inner.input_channels - 1) // 2
    X = trnn._values_from_spline(np.linspace(0, 1, L).astype(np.float32),
                                 torch.as_tensor(coeffs))
    first = X[:, :, 1:1 + K]
    rises = torch.cat([first[:, :1], first[:, 1:] - first[:, :-1]],
                      dim=1).amax(-1) > 0.5
    seen = []
    real = trnn.fused_gru_scan
    monkeypatch.setattr(trnn, "fused_gru_scan", lambda *a, **k: (
        seen.append(k["obs"]), real(*a, **k))[1])
    _port_fused(monkeypatch)
    layer(torch.as_tensor(seq), torch.as_tensor(coeffs))
    assert torch.equal(seen[0].T > 0.5, rises)
    data_mask = torch.as_tensor(seq[:, 1]).amax(-1) > 0.5
    assert not torch.equal(rises, data_mask)
    assert 0 < int(rises.sum()) < rises.numel()


def test_registry_builds_the_hybrids_with_jax_shapes():
    """make_seq_layer builds the four names with the JAX registry's leaves
    (names and shapes), ode-lstm with its in_proj, and the sweep's coeff
    family for them is natural, as in JAX."""
    for name in ("gru-dt", "gru-d", "ode-rnn", "ode-lstm"):
        jl = jreg.make_seq_layer(jax.random.PRNGKey(0), name, D, L, HID,
                                 hidden_hidden_dim=5, num_hidden_layers=2)
        tl = treg.make_seq_layer(name, D, L, HID, hidden_hidden_dim=5,
                                 num_hidden_layers=2)
        theirs = {k: v.shape for k, v in jax_arrays(jl).items()}
        ours = {k: v.shape for k, v in grads_to_jax_layout(tl).items()}
        assert ours == theirs, name
        assert trob.coeff_family(name) == jrob.coeff_family(name)
    assert isinstance(treg.make_seq_layer("ode-lstm", D, L, HID).in_proj,
                      torch.nn.Linear)
    assert len(treg.make_seq_layer("ode-rnn", D, L, HID, hidden_hidden_dim=5,
                                   num_hidden_layers=3).inner.f_layers) == 4


def test_sweep_run_of_ode_rnn_matches_jax(monkeypatch):
    """One short sweep run of `ode-rnn` at seed 0, as
    tests/test_torch_sweep_parity.py runs `gru`: JAX's classifier from
    PRNGKey(0) carried into the port, both trained 3 epochs on the same
    small problem by their own train_ists_model (JAX's scan, the port's
    eager loop), the readout bias BatchNorm cancels pinned on both sides;
    every epoch's validation loss (and the restored model's test loss)
    within 1e-4 relative, the accuracies equal."""
    from snsde.data.common import stratified_split
    from snsde.data.synthetic import synthetic_uea as jax_uea
    from test_torch_sweep_parity import _pin_the_cancelled_bias, _recording

    epochs = 3
    X, y, _ = jax_uea(n=60, length=10, channels=3, num_classes=2, seed=4)
    data = jrob.preprocess_ists(X, missing_rate=0.3,
                                interpolation=jrob.coeff_family("ode-rnn"),
                                seed=0)
    splits = stratified_split(y, seed=0)
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), "ode-rnn",
                                    X.shape[-1], X.shape[1], HID, 2)
    model = trob.ISTSClassifier("ode-rnn", X.shape[-1], X.shape[1], HID, 2)
    load_jax_arrays(model, jax_arrays(jm))
    _pin_the_cancelled_bias(monkeypatch)
    jax_seen = _recording(monkeypatch, jrob)
    jrob.train_ists_model(jax.random.PRNGKey(0), jm, data, y, splits,
                          batch_size=16, max_epochs=epochs, patience=99)
    port_seen = _recording(monkeypatch, trob)
    trob.train_ists_model(model, data, y, splits, batch_size=16,
                          max_epochs=epochs, patience=99, seed=0)
    assert len(jax_seen) == len(port_seen) == epochs + 1
    for j, t in zip(jax_seen, port_seen):
        assert abs(t.loss - j.loss) <= 1e-4 * abs(j.loss), (t.loss, j.loss)
        assert t.accuracy == j.accuracy
