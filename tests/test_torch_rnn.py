"""The recurrent baselines of the robustness sweep, port against the JAX
package, on the CPU: the three cells, `last_observation_excl`, `SeqRNN`
(gru, lstm, rnn, bilstm, two stacked layers), `GRUDFull` (its eager step
and its fused route), and the sweep loop with the recurrent names. The
classifiers built on them are held against JAX in
tests/test_torch_rnn_classifier.py.

The port runs each model two ways: the eager loop over the cell (what a
CPU tensor gets) and the fused route, whose autograd.Functions take the
kernels' plain versions for CPU tensors (the route a CUDA tensor takes to
the kernels). The JAX package runs its `lax.scan` path (the fused route is
TPU-only there). Weights go across with snsde_torch.convert.

Tolerances: cells, SeqRNN and GRUDFull outputs 2e-6 absolute; every
gradient 1e-4 relative to its largest entry.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.harness import robustness as jrob
from snsde.models.rnn import SeqRNN as JaxSeqRNN
from snsde.models.rnn import last_observation_excl as jax_last_obs
from snsde.models.time_rnn import GRUDFull as JaxGRUDFull
from snsde.nn import layers as jlayers
from snsde.nn.core import filter_value_and_grad

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan
from snsde_torch.models import rnn as trnn
from snsde_torch.models import time_rnn as ttime
from snsde_torch.nn import layers as tlayers

B, L, D, HID, K = 8, 6, 2, 6, 3
TOL_OUT = 2e-6


def _key(path):
    return ".".join(k.name if isinstance(k, jax.tree_util.GetAttrKey)
                    else str(k.idx) for k in path
                    if not isinstance(k, jax.tree_util.FlattenedIndexKey))


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path, the key format of
    snsde_torch.convert."""
    return {_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(params=["eager", "fused"])
def route(request, monkeypatch):
    """'fused' sends the CPU tensors through fused_gru_scan /
    fused_lstm_scan (the plain versions behind the autograd.Functions), the
    route a CUDA tensor takes to the kernels."""
    if request.param == "fused":
        def run(cell, xs, reverse=False, use_fused=True):
            if isinstance(cell, tlayers.LSTMCell):
                return fused_lstm_scan(cell, xs, reverse=reverse)
            if isinstance(cell, tlayers.GRUCell):
                return fused_gru_scan(cell, xs, reverse=reverse)
            return trnn.scan_cell(cell, xs, reverse)

        monkeypatch.setattr(trnn.SeqRNN, "_run", staticmethod(run))
        monkeypatch.setattr(ttime.GRUDFull, "forward",
                            lambda self, x, m, d, use_fused=True:
                            self._fused_path(x, m, d))
    return request.param


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
def test_cells_match_jax(kind):
    rng = np.random.default_rng(0)
    jcell = {"rnn": jlayers.RNNCell, "gru": jlayers.GRUCell,
             "lstm": jlayers.LSTMCell}[kind].create(jax.random.PRNGKey(1),
                                                    4, 5)
    tcell = {"rnn": tlayers.RNNCell, "gru": tlayers.GRUCell,
             "lstm": tlayers.LSTMCell}[kind](4, 5)
    load_jax_arrays(tcell, jax_arrays(jcell))
    assert tcell.hidden_size == 5
    x, h, c = (rng.normal(size=s).astype(np.float32)
               for s in ((7, 4), (7, 5), (7, 5)))
    if kind == "lstm":
        jh, (_, jc) = jcell(jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
        th, (_, tc) = tcell(torch.as_tensor(x), (torch.as_tensor(h),
                                                 torch.as_tensor(c)))
        np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                                   atol=TOL_OUT)
    else:
        jh = jcell(jnp.asarray(x), jnp.asarray(h))
        th = tcell(torch.as_tensor(x), torch.as_tensor(h))
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=TOL_OUT)


def test_cell_init_is_uniform_over_the_hidden_width():
    cell = tlayers.LSTMCell(3, 16, generator=torch.Generator().manual_seed(0))
    assert cell.w_ih.shape == (3, 64) and cell.w_hh.shape == (16, 64)
    for p in cell.parameters():
        assert float(p.detach().abs().max()) <= 0.25
    again = tlayers.LSTMCell(3, 16, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(cell.parameters(),
                                                 again.parameters()))


def test_last_observation_excl_matches_jax():
    obs = np.random.default_rng(1).random((9, 4, 3)) > 0.6
    ours = trnn.last_observation_excl(torch.as_tensor(obs))
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jax_last_obs(jnp.asarray(obs))))


SEQ_CASES = [dict(kind="gru"), dict(kind="lstm"), dict(kind="rnn"),
             dict(kind="lstm", bidirectional=True, hidden_per_dir=3),
             dict(kind="gru", bidirectional=True, num_layers=2,
                  hidden_per_dir=3),
             dict(kind="gru", num_layers=2, dropout=0.0)]


@pytest.mark.parametrize("kw", SEQ_CASES)
def test_seq_rnn_matches_jax(kw, route):
    """SeqRNN's readout and stream against JAX, and every gradient of a
    weighted sum of both."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    jm = JaxSeqRNN.create(jax.random.PRNGKey(3), 3, HID, 4, **kw)
    tm = trnn.SeqRNN(3, HID, 4, **kw)
    load_jax_arrays(tm, jax_arrays(jm))

    def jloss(m):
        out, stream = m(jnp.asarray(x))
        return jnp.sum(out * jnp.arange(out.size).reshape(out.shape) / 100.0
                       ) + jnp.sum(stream ** 2), (out, stream)

    (_, (jout, jstream)), jg = filter_value_and_grad(jloss, has_aux=True)(jm)
    out, stream = tm(torch.as_tensor(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL_OUT)
    np.testing.assert_allclose(stream.detach().numpy(), np.asarray(jstream),
                               atol=TOL_OUT)
    w = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
    ((out * w / 100.0).sum() + (stream ** 2).sum()).backward()
    ours, theirs = grads_to_jax_layout(tm), jax_arrays(jg)
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (route, name, err)


def test_seq_rnn_dropout_draws_from_the_generator():
    """Inter-layer dropout acts in training only, with a generator, and the
    same generator state gives the same mask."""
    tm = trnn.SeqRNN(3, HID, 4, kind="gru", num_layers=2, dropout=0.5,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 5, 3, generator=torch.Generator().manual_seed(1))
    base = tm(x)[1]
    a = tm(x, generator=torch.Generator().manual_seed(7))[1]
    b = tm(x, generator=torch.Generator().manual_seed(7))[1]
    assert torch.equal(a, b) and not torch.equal(a, base)
    tm.eval()
    assert torch.equal(tm(x, generator=torch.Generator().manual_seed(7))[1],
                       base)


def _grud_inputs(rate=0.5, seed=4):
    X, _, _ = synthetic_uea(n=B, length=L, channels=D, num_classes=K,
                            seed=seed)
    data = trob.preprocess_ists(X, rate, seed=seed)
    return [data["seq"][:, i] for i in range(3)]


def test_grud_full_matches_jax(route):
    """GRUDFull at a missing rate of 0.5, x_mean set: hs, and every
    gradient (x_mean's included) against the JAX eager scan."""
    x, m, d = _grud_inputs()
    jm = JaxGRUDFull.create(jax.random.PRNGKey(5), D, HID,
                            x_mean=np.array([0.3, -0.2], np.float32))
    tm = ttime.GRUDFull(D, HID)
    load_jax_arrays(tm, jax_arrays(jm))

    def jloss(mod):
        hs = mod(jnp.asarray(x), jnp.asarray(m), jnp.asarray(d))
        return jnp.sum(hs ** 2), hs

    (_, jhs), jg = filter_value_and_grad(jloss, has_aux=True)(jm)
    hs = tm(*(torch.as_tensor(a) for a in (x, m, d)))
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(jhs),
                               atol=TOL_OUT)
    (hs ** 2).sum().backward()
    ours, theirs = grads_to_jax_layout(tm), jax_arrays(jg)
    assert set(ours) == set(theirs) and "x_mean" in ours
    for name, ref in theirs.items():
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (route, name, err)


def test_grud_full_fused_route_matches_its_eager_step():
    x, m, d = (torch.as_tensor(a) for a in _grud_inputs(seed=6))
    tm = ttime.GRUDFull(D, HID, x_mean=[0.1, 0.4],
                        generator=torch.Generator().manual_seed(0))
    assert isinstance(tm.x_mean, torch.nn.Parameter)
    torch.testing.assert_close(tm._fused_path(x, m, d), tm(x, m, d),
                               rtol=0, atol=TOL_OUT)


def test_sweep_trains_the_recurrent_baselines(tmp_path):
    """run_robustness_sweep on the CPU with every new name: a record with an
    accuracy and no error for each, and "method" None, as
    getattr(inner, "method", None) gives in JAX."""
    names = ("gru", "grud", "lstm", "bilstm", "rnn", "gru-simple")
    cfg = trob.SweepConfig(models=names, missing_rates=(0.3,), seeds=(0,),
                           hidden_dim=6, batch_size=16, max_epochs=2,
                           out_dir=str(tmp_path))
    trained = {}
    recs = trob.run_robustness_sweep(
        cfg, n=60, data_fn=lambda n: synthetic_uea(n=n, length=12,
                                                   channels=2, num_classes=2,
                                                   seed=0),
        verbose=False, device="cpu", models=trained)
    assert [r["model"] for r in recs] == list(names)
    for r in recs:
        assert "error" not in r, r
        assert 0.0 <= r["accuracy"] <= 1.0 and r["method"] is None
    assert trob.coeff_family("grud") == jrob.coeff_family("grud") == "hermite"
    bilstm = trained[(0.3, "bilstm", 0)].layer.inner
    assert bilstm.cells_bwd is not None and bilstm.cells[0].hidden_size == 3
