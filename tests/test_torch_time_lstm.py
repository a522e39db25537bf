"""The time-aware LSTMs of the port (`tlstm`, `plstm`, `tglstm`:
models/time_rnn.py TLSTM, PLSTM and TGLSTM) and the LSTM kernels' modes
they run on (PLSTM's openness `sel`, TGLSTM's gate modifiers `tg`, TLSTM's
memory decomposition), against the JAX package on the CPU.

The modes: the port's plain versions, behind `fused_lstm_scan`'s
autograd.Function (the route a CUDA tensor takes to the kernels), against
the JAX kernel through `jax.vjp` in Pallas interpret mode with float32
streams (as tests/test_torch_fused_rnn_modes.py), on the same gi, W_hh,
b_hh, mode inputs and output cotangent drawn with numpy; L = 7 forward
and L = 8 reversed (7 takes the JAX kernel's padding to its unroll of 4,
8 none). hs within
2e-6 absolute, every cotangent (gi, W_hh, b_hh, sel, tg, W_d, b_d) within
1e-5 of its largest entry. The plain backward versions equal autograd of
the plain forwards in float64 to 1e-12.

The models: two-layer stacks with weights carried by snsde_torch.convert,
the port's eager loop and its fused route against the JAX scan and the
JAX fused route (its gates forced open, as tests/test_fused_rnn.py:290-340
does), the outputs and every parameter's gradient (the phase parameters
and weight_t included) at that test's rtol 5e-4, atol 5e-6; each registry
layer the same way; and one seed-0 sweep run of `tlstm` against JAX's
train_ists_model.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde import registry as jreg
from snsde.harness import robustness as jrob
from snsde.models import time_rnn as jtime
from snsde.nn.core import filter_value_and_grad

from snsde_torch import registry as treg
from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels import fused_rnn as fr
from snsde_torch.models import time_rnn as ttime

B, H = 6, 5
TOL_HS = 2e-6
TOL_GRAD = 1e-5
RTOL, ATOL = 5e-4, 5e-6
MODES = ("sel", "tg", "tlstm")


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")


def _inputs(mode, L, seed=0):
    """gi, W_hh, b_hh and the mode's inputs (sel ~ U(0, 1) with some
    closed and fully open units; tg, sigmoids of N(0, 1); W_d, b_d of the
    init's scale and tel ~ U(0, 2)), and ghs; (differentiable inputs, data,
    ghs)."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    f = lambda a: np.asarray(a, np.float32)
    inp = {"gi": f(rng.normal(size=(L, B, 4 * H))),
           "whh": f(rng.uniform(-k, k, size=(H, 4 * H))),
           "bhh": f(rng.uniform(-k, k, size=(4 * H,)))}
    data = {}
    if mode == "sel":
        s = rng.uniform(size=(L, B, H))
        s[:, :, 0] = 1e-3 * s[:, :, 0]
        s[:, :, -1] = 1.0
        inp["sel"] = f(s)
    elif mode == "tg":
        inp["tg"] = f(1.0 / (1.0 + np.exp(-rng.normal(size=(L, B, 3 * H)))))
    elif mode == "tlstm":
        inp["wd"] = f(rng.uniform(-k, k, size=(H, H)))
        inp["bd"] = f(rng.uniform(-k, k, size=(H,)))
        data["tel"] = f(rng.uniform(0.0, 2.0, size=(L, B)))
    return inp, data, f(rng.normal(size=(L, B, H)))


def _jax_side(inp, data, ghs, reverse):
    from snsde.kernels.fused_rnn import fused_lstm_scan

    names = sorted(inp)

    def f(*args):
        a = dict(zip(names, args))
        cell = SimpleNamespace(w_ih=jnp.eye(4 * H, dtype=jnp.float32),
                               b_ih=jnp.zeros((4 * H,), jnp.float32),
                               w_hh=a["whh"], b_hh=a["bhh"], hidden_size=H)
        tl = (SimpleNamespace(weight=a["wd"], bias=a["bd"]) if "wd" in a
              else None)
        return fused_lstm_scan(
            cell, a["gi"], reverse=reverse, sel=a.get("sel"),
            tg=a.get("tg"), tlstm=tl,
            tel=jnp.asarray(data["tel"]) if tl is not None else None)

    hs, vjp = jax.vjp(f, *(jnp.asarray(inp[k]) for k in names))
    grads = vjp(jnp.asarray(ghs))
    return np.asarray(hs), {k: np.asarray(g) for k, g in zip(names, grads)}


def _port_side(inp, data, ghs, reverse):
    t = {k: torch.as_tensor(v).requires_grad_(True) for k, v in inp.items()}
    cell = SimpleNamespace(w_ih=torch.eye(4 * H), b_ih=torch.zeros(4 * H),
                           w_hh=t["whh"], b_hh=t["bhh"], hidden_size=H)
    tl = None
    if "wd" in t:
        tl = torch.nn.Linear(H, H)
        tl.weight = torch.nn.Parameter(t["wd"].detach().T.clone())
        tl.bias = torch.nn.Parameter(t["bd"].detach().clone())
    hs = fr.fused_lstm_scan(cell, t["gi"], reverse=reverse, sel=t.get("sel"),
                            tg=t.get("tg"), tlstm=tl,
                            tel=torch.as_tensor(data["tel"]) if tl else None)
    hs.backward(torch.as_tensor(ghs))
    grads = {k: v.grad.numpy() for k, v in t.items() if v.grad is not None}
    if tl is not None:
        grads["wd"] = tl.weight.grad.T.numpy()
        grads["bd"] = tl.bias.grad.numpy()
    return hs.detach().numpy(), grads


@pytest.mark.parametrize("L,reverse", [(7, False), (8, True)])
@pytest.mark.parametrize("mode", MODES)
def test_lstm_mode_matches_jax_kernel(mode, L, reverse):
    """hs and every cotangent of a mode's plain versions against the JAX
    kernel (its sel, tg, W_d and b_d cotangents included)."""
    inp, data, ghs = _inputs(mode, L, seed=MODES.index(mode) + 10 * L)
    hs_j, g_j = _jax_side(inp, data, ghs, reverse)
    hs_t, g_t = _port_side(inp, data, ghs, reverse)
    np.testing.assert_allclose(hs_t, hs_j, atol=TOL_HS, rtol=0)
    assert set(g_j) == set(inp) == set(g_t)
    for name, ref in g_j.items():
        err = float(np.abs(g_t[name] - ref).max())
        assert err <= TOL_GRAD * float(np.abs(ref).max()), (name, err)


def _f64(inp, data):
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}
    return t, {k: torch.as_tensor(v, dtype=torch.float64)
               for k, v in data.items()}


@pytest.mark.parametrize("mode", MODES)
def test_lstm_mode_backward_reference_is_autograd_of_forward(mode):
    """In float64 the plain reverse loop of each mode equals autograd of
    the plain forward loop, every cotangent (dsel, dtg, dW_d, db_d) to
    rounding; tel takes none."""
    inp, data, ghs = _inputs(mode, 7, seed=21)
    t, d = _f64(inp, data)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}

    def kw(src):
        out = {k: src[k] for k in ("sel", "tg") if k in src}
        if "wd" in src:
            out["dec"] = fr.Decomp(src["wd"], src["bd"], d["tel"])
        return out

    base = {k: leaves[k] for k in ("gi", "whh", "bhh")}
    hs, cs, _ = fr.fused_lstm_forward_reference(**base, **kw(leaves))
    g = torch.as_tensor(ghs, dtype=torch.float64)
    hs.backward(g)
    ours = fr.fused_lstm_backward_reference(
        hs=hs.detach(), cs=cs.detach(), ghs=g,
        **{k: t[k] for k in ("gi", "whh", "bhh")}, **kw(t))
    assert isinstance(ours, fr.FusedLSTMGrads) and ours.dmlp is None
    for name in fr.FusedLSTMGrads._fields:
        leaf = leaves.get(name[1:])
        if leaf is None:
            assert getattr(ours, name) is None, name
            continue
        torch.testing.assert_close(getattr(ours, name), leaf.grad,
                                   rtol=1e-12, atol=1e-12)


def test_lstm_modes_are_checked():
    """The modes' inputs of the wrong shape raise ValueError; a tensor not
    on the CPU with two modes at once raises NotImplementedError (no JAX
    caller reaches it) before anything is built; CPU tensors take the plain
    versions."""
    inp, data, _ = _inputs("tlstm", 5, seed=3)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    base = {k: t[k] for k in ("gi", "whh", "bhh")}
    dec = fr.Decomp(t["wd"], t["bd"], torch.as_tensor(data["tel"]))
    assert fr.check_lstm_inputs(**base, dec=dec) == (5, B, H)
    for bad in (dict(sel=torch.zeros(5, B, H + 1)),
                dict(tg=torch.zeros(5, B, H)),
                dict(dec=dec._replace(wd=t["wd"][:, :2])),
                dict(dec=dec._replace(tel=dec.tel[:, :2]))):
        with pytest.raises(ValueError, match="expected"):
            fr.check_lstm_inputs(**base, **bad)
    meta = {k: v.to("meta") for k, v in base.items()}
    with pytest.raises(NotImplementedError, match="no JAX caller"):
        fr.fused_lstm_forward(**meta, sel=torch.zeros(5, B, H, device="meta"),
                              tg=torch.zeros(5, B, 3 * H, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_lstm_forward(**meta, sel=torch.zeros(5, B, H, device="meta"))
    hs, cs, hcell = fr.fused_lstm_forward(**base, dec=dec)
    assert hs.shape == cs.shape == (5, B, H) and hcell is None
    cell = SimpleNamespace(w_ih=torch.eye(4 * H), b_ih=torch.zeros(4 * H),
                           w_hh=t["whh"], b_hh=t["bhh"], hidden_size=H)
    with pytest.raises(ValueError, match="both tlstm and tel"):
        fr.fused_lstm_scan(cell, t["gi"], tel=dec.tel)


def test_wd_weight_grads_reference_equals_per_step_sums():
    """TLSTM's W_d gradient as one product over (step, row) equals the sum
    over steps of c_{t-1}^T dzd_t (c_{-1} = 0), in float64."""
    rng = np.random.default_rng(5)
    L = 6
    cs = torch.as_tensor(rng.normal(size=(L, B, H)))
    dzd = torch.as_tensor(rng.normal(size=(L, B, H)))
    dwd, dbd = fr.fused_lstm_wd_grads(cs, dzd)
    want = sum(cs[t - 1].T @ dzd[t] for t in range(1, L))
    torch.testing.assert_close(dwd, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dbd, dzd.sum((0, 1)), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The models, their registry layers and a sweep run
# ---------------------------------------------------------------------------

from test_torch_obs_rnn import (_batch, _close,  # noqa: E402
                                _port_loss_grads, jax_arrays)

NAMES = ("tlstm", "plstm", "tglstm")
CLASSES = {"tlstm": (jtime.TLSTM, ttime.TLSTM),
           "plstm": (jtime.PLSTM, ttime.PLSTM),
           "tglstm": (jtime.TGLSTM, ttime.TGLSTM)}


def _jax_loss_grads(layer, seq, coeffs):
    """The JAX layer's loss (a sum of squares of its output and stream)
    and every leaf's gradient, jitted."""
    def loss(m):
        out, hn = m(jnp.asarray(seq), jnp.asarray(coeffs))
        return jnp.sum(out ** 2) + jnp.sum(hn ** 2)

    l, g = jax.jit(filter_value_and_grad(loss))(layer)
    return float(l), jax_arrays(g)


def _jax_fused(monkeypatch):
    """Open the JAX package's gates of the time-aware LSTMs' fused route
    at every width (tests/test_fused_rnn.py:316-325), and count its fused
    scans."""
    import snsde.kernels.fused_rnn as jfr

    calls = []
    real = jfr.fused_lstm_scan
    monkeypatch.setattr(jfr, "fused_lstm_scan", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    monkeypatch.setenv("SNSDE_FUSED_TIME_RNN", "1")
    monkeypatch.setenv("SNSDE_FUSED_RNN_MIN_H", "0")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


def _port_fused(monkeypatch):
    """Send the port's CPU tensors through the fused route (the kernels'
    plain versions behind the autograd.Function), counting it."""
    calls = []
    monkeypatch.setattr(ttime._TimeLSTMStack, "_kernels_take",
                        lambda self, x, use_fused: (calls.append(1),
                                                    True)[1])
    return calls


@pytest.mark.parametrize("kind", NAMES)
def test_time_lstm_matches_jax(kind, monkeypatch):
    """A two-layer stack on irregular times, carried over from JAX: the
    output stream and the gradient of every parameter (periods, shifts,
    on_end and weight_t included), the port's eager loop and fused route
    against the JAX scan and fused route."""
    rng = np.random.default_rng(12)
    Bm, L, D, Hm = 5, 11, 3, 6
    jcls, tcls = CLASSES[kind]
    jm = jcls.create(jax.random.PRNGKey(13), D, Hm, num_layers=2)
    tm = tcls(D, Hm, num_layers=2)
    load_jax_arrays(tm, jax_arrays(jm))
    x = rng.normal(size=(Bm, L, D)).astype(np.float32)
    ts = np.cumsum(rng.uniform(0.1, 1.0, (Bm, L)), axis=1).astype(np.float32)

    def jloss(m):
        out, _ = m(jnp.asarray(x), jnp.asarray(ts))
        return jnp.sum(out ** 2), out

    want = {}
    (l, out), g = jax.jit(filter_value_and_grad(jloss, has_aux=True))(jm)
    want["scan"] = (float(l), np.asarray(out), jax_arrays(g))
    with monkeypatch.context() as m:
        calls = _jax_fused(m)
        (l, out), g = jax.jit(filter_value_and_grad(jloss,
                                                    has_aux=True))(jm)
        assert len(calls) == 2, "the JAX fused route did not run"
    want["fused"] = (float(l), np.asarray(out), jax_arrays(g))
    got = {}
    for route in ("eager", "fused"):
        with monkeypatch.context() as m:
            calls = _port_fused(m) if route == "fused" else None
            tm.zero_grad()
            out, finals = tm(torch.as_tensor(x), torch.as_tensor(ts))
            loss = (out ** 2).sum()
            loss.backward()
            assert calls is None or calls
            assert len(finals) == 2
        got[route] = (loss.item(), out.detach().numpy(),
                      grads_to_jax_layout(tm))
    for gk, (gl, go, gg) in got.items():
        for wk, (wl, wo, wg) in want.items():
            np.testing.assert_allclose(gl, wl, rtol=RTOL)
            np.testing.assert_allclose(go, wo, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{kind} {gk} vs {wk}")
            _close(kind, f"{gk} vs {wk}", gg, wg, RTOL, ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_registry_layer_matches_jax(name, monkeypatch):
    """The registry's two-layer layer of each name (in_proj, the first
    channel's delta or plstm's grid times): loss and every leaf's gradient,
    the port's eager loop and fused route against the JAX scan."""
    seq, coeffs = _batch()
    jl = jreg.make_seq_layer(jax.random.PRNGKey(3), name, 4, 11, 6,
                             num_layers=2)
    tl = treg.make_seq_layer(name, 4, 11, 6, num_layers=2)
    load_jax_arrays(tl, jax_arrays(jl))
    wl, wg = _jax_loss_grads(jl, seq, coeffs)
    got = {"eager": _port_loss_grads(tl, seq, coeffs)}
    with monkeypatch.context() as m:
        calls = _port_fused(m)
        got["fused"] = _port_loss_grads(tl, seq, coeffs)
        assert calls
    for gk, (gl, gg) in got.items():
        np.testing.assert_allclose(gl, wl, rtol=RTOL, err_msg=f"{name} {gk}")
        _close(name, f"{gk} vs scan", gg, wg, RTOL, ATOL)


def test_registry_builds_the_time_lstms_with_jax_shapes():
    """make_seq_layer builds the three names with the JAX registry's
    leaves (names and shapes, in_proj included) at one and two layers, and
    the sweep's coefficient family for them is JAX's."""
    for name in NAMES:
        for layers in (1, 2):
            jl = jreg.make_seq_layer(jax.random.PRNGKey(0), name, 4, 11, 6,
                                     num_layers=layers)
            tl = treg.make_seq_layer(name, 4, 11, 6, num_layers=layers)
            theirs = {k: v.shape for k, v in jax_arrays(jl).items()}
            ours = {k: v.shape for k, v in grads_to_jax_layout(tl).items()}
            assert ours == theirs, (name, layers)
        assert name in treg.PORTED_NAMES
        assert trob.coeff_family(name) == jrob.coeff_family(name)


def test_sweep_run_of_tlstm_matches_jax(monkeypatch):
    """One short sweep run of `tlstm` at seed 0, as
    test_sweep_run_of_ode_rnn_matches_jax runs `ode-rnn`: JAX's classifier
    from PRNGKey(0) carried into the port, both trained 2 epochs on the
    same small problem by their own train_ists_model (JAX's scan, the
    port's eager loop; the layer has no readout bias for BatchNorm to
    cancel); every epoch's validation loss (and the restored model's test
    loss) within 1e-4 relative, the accuracies equal."""
    from snsde.data.common import stratified_split
    from snsde.data.synthetic import synthetic_uea as jax_uea
    from test_torch_sweep_parity import _recording

    epochs = 2
    X, y, _ = jax_uea(n=60, length=10, channels=3, num_classes=2, seed=4)
    data = jrob.preprocess_ists(X, missing_rate=0.3,
                                interpolation=jrob.coeff_family("tlstm"),
                                seed=0)
    splits = stratified_split(y, seed=0)
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), "tlstm",
                                    X.shape[-1], X.shape[1], 6, 2)
    model = trob.ISTSClassifier("tlstm", X.shape[-1], X.shape[1], 6, 2)
    load_jax_arrays(model, jax_arrays(jm))
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


def test_cpu_sweep_trains_the_new_names(tmp_path):
    """The README's CPU drive: the five names this slice ports train two
    epochs on the CPU, each writing a record with an accuracy and no
    error."""
    cfg = trob.SweepConfig(models=("tlstm", "plstm", "tglstm", "cnn",
                                   "transformer"), missing_rates=(0.3,),
                           hidden_dim=6, batch_size=16, max_epochs=2,
                           out_dir=str(tmp_path))
    recs = trob.run_robustness_sweep(
        cfg, n=60, data_fn=lambda n: synthetic_uea(n=n, length=12,
                                                   channels=2,
                                                   num_classes=2, seed=0),
        verbose=False, device="cpu")
    assert [r["model"] for r in recs] == list(cfg.models)
    for r in recs:
        assert "error" not in r and 0.0 <= r["accuracy"] <= 1.0, r
