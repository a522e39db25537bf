"""snsde_torch.kernels.fused_rnn against the JAX package's fused GRU and LSTM
kernels, and against autograd of its own plain forwards.

The JAX kernels run in Pallas interpret mode on the CPU with float32
streams (as tests/test_fused_rnn.py runs them), through `fused_gru_scan` /
`fused_lstm_scan` and `jax.vjp`; the port runs its own `fused_*_scan`,
whose autograd.Function takes the plain PyTorch versions for CPU tensors.
Both sides get the same input-projection stream gi, weights, h0, decay
stream and output cotangent, drawn with numpy: each side's scan is handed
a cell whose w_ih is the identity and b_ih zero, so the projection passes
gi through exactly and its cotangent is the kernels' dgi. L = 7 takes the
JAX kernel's valid-flag padding of the sequence to its unroll of 4.

Tolerances: hs within 2e-6 absolute (both sides run the same recurrence in
float32; the sums differ in order only); dgi, dW_hh, db_hh, dh0 and dhdec
each within 1e-5 of its largest entry. The LSTM's weight gradient, now a
product after the reverse loop, is held to the loop's old step-by-step
accumulation in float64 to 1e-12, and so is the GRU's (now the product
of the cell's input states and W_hh's cotangent dgh); the GRU's is also
held to the JAX kernel's dW_hh and db_hh.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde_torch.kernels import fused_rnn as fr
from snsde_torch.nn.layers import GRUCell, LSTMCell

B, C, H = 6, 4, 5
TOL_HS = 2e-6
TOL_GRAD = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")


def _inputs(kind, L, h0=False, dec=False, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    k = 1.0 / np.sqrt(H)
    f = lambda a: a.astype(np.float32)
    out = {"gi": f(rng.normal(size=(L, B, G * H))),
           "whh": f(rng.uniform(-k, k, size=(H, G * H))),
           "bhh": f(rng.uniform(-k, k, size=(G * H,)))}
    if h0:
        out["h0"] = f(0.5 * rng.normal(size=(B, H)))
    if dec:
        out["hdec"] = f(rng.uniform(0.2, 1.0, size=(L, B, H)))
    return out, f(rng.normal(size=(L, B, H)))


def _jax_side(kind, inp, ghs, reverse):
    """(hs, {name: cotangent}) of the JAX kernel through jax.vjp."""
    from snsde.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan

    G = 3 if kind == "gru" else 4
    names = sorted(inp)

    def f(*args):
        a = dict(zip(names, args))
        cell = SimpleNamespace(w_ih=jnp.eye(G * H, dtype=jnp.float32),
                               b_ih=jnp.zeros((G * H,), jnp.float32),
                               w_hh=a["whh"], b_hh=a["bhh"], hidden_size=H)
        if kind == "lstm":
            return fused_lstm_scan(cell, a["gi"], reverse=reverse)
        return fused_gru_scan(cell, a["gi"], h0=a.get("h0"),
                              reverse=reverse, hdec=a.get("hdec"))

    hs, vjp = jax.vjp(f, *(jnp.asarray(inp[n]) for n in names))
    grads = vjp(jnp.asarray(ghs))
    return np.asarray(hs), {n: np.asarray(g) for n, g in zip(names, grads)}


def _port_side(kind, inp, ghs, reverse):
    """(hs, {name: cotangent}) of the port's scan through autograd."""
    G = 3 if kind == "gru" else 4
    t = {n: torch.as_tensor(v).requires_grad_(True) for n, v in inp.items()}
    cell = SimpleNamespace(w_ih=torch.eye(G * H), b_ih=torch.zeros(G * H),
                           w_hh=t["whh"], b_hh=t["bhh"], hidden_size=H)
    if kind == "lstm":
        hs = fr.fused_lstm_scan(cell, t["gi"], reverse=reverse)
    else:
        hs = fr.fused_gru_scan(cell, t["gi"], h0=t.get("h0"),
                               reverse=reverse, hdec=t.get("hdec"))
    hs.backward(torch.as_tensor(ghs))
    return hs.detach().numpy(), {n: v.grad.numpy() for n, v in t.items()}


GRU_CASES = [(False, 8, False, False), (True, 7, False, False),
             (False, 7, True, False), (True, 8, True, False),
             (False, 7, True, True), (True, 8, False, True),
             (True, 7, True, True)]


@pytest.mark.parametrize("reverse,L,h0,dec", GRU_CASES)
def test_gru_plain_versions_match_jax_kernel(reverse, L, h0, dec):
    """hs and the cotangents of gi, W_hh, b_hh, h0 and hdec against the
    JAX Pallas GRU kernels and their custom VJP."""
    inp, ghs = _inputs("gru", L, h0=h0, dec=dec)
    hs_j, g_j = _jax_side("gru", inp, ghs, reverse)
    hs_t, g_t = _port_side("gru", inp, ghs, reverse)
    np.testing.assert_allclose(hs_t, hs_j, atol=TOL_HS, rtol=0)
    assert set(g_t) == set(g_j) == set(inp)
    for name, ref in g_j.items():
        err = float(np.abs(g_t[name] - ref).max())
        assert err <= TOL_GRAD * float(np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("reverse,L", [(False, 8), (True, 7), (False, 7),
                                       (True, 8)])
def test_lstm_plain_versions_match_jax_kernel(reverse, L):
    inp, ghs = _inputs("lstm", L, seed=1)
    hs_j, g_j = _jax_side("lstm", inp, ghs, reverse)
    hs_t, g_t = _port_side("lstm", inp, ghs, reverse)
    np.testing.assert_allclose(hs_t, hs_j, atol=TOL_HS, rtol=0)
    for name, ref in g_j.items():
        err = float(np.abs(g_t[name] - ref).max())
        assert err <= TOL_GRAD * float(np.abs(ref).max()), (name, err)


def _f64(inp):
    return {n: torch.as_tensor(v, dtype=torch.float64) for n, v in inp.items()}


@pytest.mark.parametrize("dec", [False, True])
def test_gru_backward_reference_is_autograd_of_forward(dec):
    """In float64 the plain reverse loop (the backward kernel's twin)
    equals autograd of the plain forward loop to rounding."""
    inp, ghs = _inputs("gru", 7, h0=True, dec=dec, seed=2)
    leaves = {n: v.requires_grad_(True) for n, v in _f64(inp).items()}
    hs = fr.fused_gru_forward_reference(**leaves)
    g = torch.as_tensor(ghs, dtype=torch.float64)
    hs.backward(g)
    ours = fr.fused_gru_backward_reference(hs=hs.detach(), ghs=g,
                                           **_f64(inp))
    for name in fr.FusedGRUGrads._fields:
        leaf = leaves.get(name[1:])
        if leaf is None:
            assert getattr(ours, name) is None
            continue
        torch.testing.assert_close(getattr(ours, name), leaf.grad,
                                   rtol=1e-12, atol=1e-12)


def test_lstm_backward_reference_is_autograd_of_forward():
    inp, ghs = _inputs("lstm", 7, seed=3)
    leaves = {n: v.requires_grad_(True) for n, v in _f64(inp).items()}
    hs, cs, hcell = fr.fused_lstm_forward_reference(**leaves)
    assert hcell is None
    g = torch.as_tensor(ghs, dtype=torch.float64)
    hs.backward(g)
    ours = fr.fused_lstm_backward_reference(hs=hs.detach(), cs=cs.detach(),
                                            ghs=g, **_f64(inp))
    for name in fr.FusedLSTMGrads._fields:
        leaf = leaves.get(name[1:])
        if leaf is None:
            assert getattr(ours, name) is None
            continue
        torch.testing.assert_close(getattr(ours, name), leaf.grad,
                                   rtol=1e-12, atol=1e-12)


def _in_loop_weight_grads(hs, dgi):
    """dW_hh and db_hh as the reverse loop accumulated them step by step
    before the weight gradient left it: dW_hh += h_{t-1}^T dgi_t and
    db_hh += the batch sum of dgi_t, from the last step down, h_{-1} = 0."""
    L, B, H = hs.shape
    dwhh = torch.zeros(H, dgi.shape[-1], dtype=hs.dtype)
    dbhh = torch.zeros(dgi.shape[-1], dtype=hs.dtype)
    for t in range(L - 1, -1, -1):
        h = torch.zeros(B, H, dtype=hs.dtype) if t == 0 else hs[t - 1]
        dwhh += h.T @ dgi[t]
        dbhh += dgi[t].sum(0)
    return dwhh, dbhh


@pytest.mark.parametrize("batch", [8, 13])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 7])
def test_lstm_weight_grads_reference_equals_in_loop_accumulation(L, reverse,
                                                                 batch):
    """In float64 the weight-gradient function (one product over (step,
    row) after the reverse loop) equals the sums the loop accumulated step
    by step, to 1e-12 (the order of summation only): one step and seven,
    either direction (a reverse scan hands the kernels flipped streams),
    and a batch that leaves an 8-row tile ragged (13). The plain backward
    returns it, and on CPU tensors the wrapper is the plain version."""
    inp, ghs = _inputs("lstm", L, seed=4)
    t = _f64(inp)
    t["gi"] = torch.as_tensor(
        np.random.default_rng(5).normal(size=(L, batch, 4 * H)))
    if reverse:
        t["gi"] = torch.flip(t["gi"], (0,))
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(L, batch, H)))
    hs, cs, _ = fr.fused_lstm_forward_reference(**t)
    grads = fr.fused_lstm_backward_reference(hs=hs, cs=cs, ghs=g, **t)
    dwhh, dbhh = _in_loop_weight_grads(hs, grads.dgi)
    torch.testing.assert_close(grads.dwhh, dwhh, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grads.dbhh, dbhh, rtol=1e-12, atol=1e-12)
    k = fr.fused_lstm_weight_grads(hs, grads.dgi)
    assert torch.equal(k[0], grads.dwhh) and torch.equal(k[1], grads.dbhh)
    assert torch.equal(
        fr.fused_lstm_backward_recurrence(hs=hs, cs=cs, ghs=g, **t).dgi,
        grads.dgi)


def _kernel_streams(inp, ghs, reverse):
    """The streams the kernels see: a reverse scan hands them gi, hdec and
    the output cotangent flipped in time (h0 stays)."""
    t = {n: torch.as_tensor(v) for n, v in inp.items()}
    g = torch.as_tensor(ghs)
    if reverse:
        t.update({n: torch.flip(t[n], (0,)) for n in ("gi", "hdec") if n in t})
        g = torch.flip(g, (0,))
    return t, g


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dec", [False, True])
def test_gru_weight_grads_reference_matches_jax_kernel(dec, reverse):
    """dW_hh and db_hh as one product of the cell's input states (h0,
    then hs, times the decay) and W_hh's cotangent dgh, after the reverse
    loop, against the JAX kernel's in-loop dwhh and dbhh (through jax.vjp
    of its scan), with a nonzero h0, with and without the decay stream, in
    both directions: within 1e-5 of the largest entry."""
    inp, ghs = _inputs("gru", 7, h0=True, dec=dec, seed=8)
    _, g_j = _jax_side("gru", inp, ghs, reverse)
    t, g = _kernel_streams(inp, ghs, reverse)
    hs = fr.fused_gru_forward_reference(**t)
    dgh = fr.fused_gru_backward_recurrence(hs=hs, ghs=g, **t).dgh
    k = fr.fused_gru_weight_grads(t["h0"], hs, dgh, t.get("hdec"))
    ref = fr.fused_gru_weight_grads_reference(t["h0"], hs, dgh,
                                              t.get("hdec"))
    for name, ours, want in zip(("whh", "bhh"), ref, (g_j["whh"],
                                                     g_j["bhh"])):
        err = float(np.abs(ours.numpy() - want).max())
        assert err <= TOL_GRAD * float(np.abs(want).max()), (name, err)
    assert torch.equal(k[0], ref[0]) and torch.equal(k[1], ref[1])


def _gru_in_loop_weight_grads(h0, hs, dgh, hdec):
    """dW_hh and db_hh as the GRU's reverse loop accumulated them step by
    step before the weight gradient left it: dW_hh += x_t^T dgh_t, x_t =
    (h0 at t = 0, else hs[t - 1]) times hdec[t], and db_hh += the batch sum
    of dgh_t, from the last step down."""
    L, B, H = hs.shape
    dwhh = torch.zeros(H, dgh.shape[-1], dtype=hs.dtype)
    dbhh = torch.zeros(dgh.shape[-1], dtype=hs.dtype)
    for t in range(L - 1, -1, -1):
        x = h0 if t == 0 else hs[t - 1]
        if hdec is not None:
            x = x * hdec[t]
        dwhh += x.T @ dgh[t]
        dbhh += dgh[t].sum(0)
    return dwhh, dbhh


@pytest.mark.parametrize("batch", [8, 13])
@pytest.mark.parametrize("dec", [False, True])
@pytest.mark.parametrize("L", [1, 7])
def test_gru_weight_grads_reference_equals_in_loop_accumulation(L, dec,
                                                                batch):
    """In float64 the GRU's weight-gradient function equals the sums the
    reverse loop accumulated step by step, to 1e-12 (the order of
    summation only): one step and seven, with and without the decay, and
    a batch that leaves an 8-row tile ragged (13). The plain backward
    returns it."""
    rng = np.random.default_rng(9)
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape))
    k = 1.0 / np.sqrt(H)
    t = {"gi": f(L, batch, 3 * H), "h0": 0.5 * f(batch, H),
         "whh": torch.as_tensor(rng.uniform(-k, k, size=(H, 3 * H))),
         "bhh": torch.as_tensor(rng.uniform(-k, k, size=(3 * H,)))}
    if dec:
        t["hdec"] = torch.as_tensor(rng.uniform(0.2, 1.0, size=(L, batch, H)))
    g = f(L, batch, H)
    hs = fr.fused_gru_forward_reference(**t)
    dgh = fr.fused_gru_backward_recurrence(hs=hs, ghs=g, **t).dgh
    dwhh, dbhh = _gru_in_loop_weight_grads(t["h0"], hs, dgh, t.get("hdec"))
    grads = fr.fused_gru_backward_reference(hs=hs, ghs=g, **t)
    torch.testing.assert_close(grads.dwhh, dwhh, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grads.dbhh, dbhh, rtol=1e-12, atol=1e-12)


def test_lstm_inference_primal_skips_the_cell_states(monkeypatch):
    """With grad mode off, or with nothing that needs a gradient, the LSTM
    scan runs the forward alone with save_cs=False (the JAX
    inference-only primal); in training it goes through FusedLSTM."""
    calls = []
    real = fr.fused_lstm_forward

    def spy(gi, whh, bhh, save_cs=True, *modes, **kw):
        calls.append(save_cs)
        return real(gi, whh, bhh, save_cs, *modes, **kw)

    monkeypatch.setattr(fr, "fused_lstm_forward", spy)
    cell = LSTMCell(C, H, generator=torch.Generator().manual_seed(0))
    xs = torch.randn(6, B, C, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = fr.fused_lstm_scan(cell, xs)
    b = fr.fused_lstm_scan(cell, xs)
    for p in cell.parameters():
        p.requires_grad_(False)
    c = fr.fused_lstm_scan(cell, xs)
    assert calls == [False, True, False]
    assert torch.equal(a, b.detach()) and torch.equal(a, c)
    hs, cs, _ = real(xs @ cell.w_ih.detach() + cell.b_ih.detach(),
                     cell.w_hh.detach(), cell.b_hh.detach(), save_cs=False)
    assert cs is None and torch.equal(hs, a)


def test_supports_fused_is_the_cell_layout_and_width():
    gen = torch.Generator().manual_seed(0)
    gru, lstm = GRUCell(3, 8, generator=gen), LSTMCell(3, 8, generator=gen)
    assert fr.supports_fused_gru(gru) and not fr.supports_fused_gru(lstm)
    assert fr.supports_fused_lstm(lstm) and not fr.supports_fused_lstm(gru)
    wide = SimpleNamespace(w_ih=torch.zeros(3, 3 * 513),
                           w_hh=torch.zeros(513, 3 * 513))
    assert not fr.supports_fused_gru(wide)
    assert fr.supports_fused_gru(SimpleNamespace(
        w_ih=torch.zeros(3, 3 * 512), w_hh=torch.zeros(512, 3 * 512)))
    assert not fr.supports_fused_gru(SimpleNamespace(w_hh=gru.w_hh))


@pytest.mark.parametrize("kw", [{"stream_dtype": torch.bfloat16}])
def test_unported_gru_modes_raise(kw):
    """bf16 streams, which once raised here (ROADMAP Queue 2 K6, done), run
    on the CPU's plain versions: finite hs and gradients."""
    cell = GRUCell(C, H, generator=torch.Generator().manual_seed(0))
    xs = torch.ones(4, B, C)
    hs = fr.fused_gru_scan(cell, xs, **kw)
    hs.sum().backward()
    assert hs.dtype == torch.float32 and torch.isfinite(hs).all()
    assert torch.isfinite(cell.w_hh.grad).all()


@pytest.mark.parametrize("kw", [
    {"sel": torch.ones(4, B, H), "tg": torch.ones(4, B, 3 * H)},
    {"tg": torch.ones(4, B, 3 * H), "tlstm": object(),
     "tel": torch.ones(4, B)},
    {"sel": torch.ones(4, B, H), "odt": torch.ones(4, B),
     "ode_layers": [torch.nn.Linear(H, H)]},
    {"stream_dtype": torch.bfloat16}])
def test_unported_lstm_modes_raise(kw):
    """Two of the LSTM's modes at once (no JAX caller does that) raise on
    every device; bf16 streams, which once raised too (ROADMAP Queue 2 K7,
    done), run on the CPU's plain versions with finite hs and gradients."""
    cell = LSTMCell(C, H, generator=torch.Generator().manual_seed(0))
    if "stream_dtype" not in kw:
        with pytest.raises(NotImplementedError, match="no JAX caller"):
            fr.fused_lstm_scan(cell, torch.zeros(4, B, C), **kw)
        return
    hs = fr.fused_lstm_scan(cell, torch.ones(4, B, C), **kw)
    hs.sum().backward()
    assert hs.dtype == torch.float32 and torch.isfinite(hs).all()
    assert torch.isfinite(cell.w_hh.grad).all()


def test_kernel_input_checks():
    inp, ghs = _inputs("gru", 7, h0=True, dec=True)
    t = {n: torch.as_tensor(v) for n, v in inp.items()}
    assert fr.check_gru_inputs(**t) == (7, B, H)
    with pytest.raises(ValueError, match="float32 only"):
        fr.check_gru_inputs(**{**t, "bhh": t["bhh"].double()})
    with pytest.raises(ValueError, match="expected"):
        fr.check_gru_inputs(**{**t, "h0": t["h0"][:, :3]})
    with pytest.raises(ValueError, match="not contiguous"):
        fr.check_gru_inputs(**{**t, "whh": t["whh"].t().contiguous().t()})
    big = torch.zeros(2, 1, 3 * 513)
    with pytest.raises(ValueError, match="H <= 512"):
        fr.check_gru_inputs(big, torch.zeros(1, 513),
                            torch.zeros(513, 3 * 513), torch.zeros(3 * 513))
    wide = {"gi": torch.zeros(2, 1, 3 * 256), "h0": torch.zeros(1, 256),
            "whh": torch.zeros(256, 3 * 256), "bhh": torch.zeros(3 * 256),
            "hdec": torch.zeros(2, 1, 256)}
    assert fr.check_gru_inputs(**wide) == (2, 1, 256)
    lin, _ = _inputs("lstm", 7)
    tl = {n: torch.as_tensor(v) for n, v in lin.items()}
    assert fr.check_lstm_inputs(**tl) == (7, B, H)
    with pytest.raises(ValueError, match="expected"):
        fr.check_lstm_inputs(**{**tl, "bhh": tl["bhh"][:-1]})


def test_wrappers_raise_on_a_device_without_the_kernels(tmp_path,
                                                       monkeypatch):
    """CPU tensors take the plain versions; any other non-CUDA device
    raises instead of falling back, and so does a machine that cannot
    build the kernels."""
    inp, ghs = _inputs("gru", 7, h0=True, dec=True)
    meta = {n: torch.as_tensor(v).to("meta") for n, v in inp.items()}
    g = torch.as_tensor(ghs).to("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_gru_forward(**meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_gru_backward(hs=g, ghs=g, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_gru_weight_grads(meta["h0"], g, meta["gi"], meta["hdec"])
    lin, _ = _inputs("lstm", 7)
    lmeta = {n: torch.as_tensor(v).to("meta") for n, v in lin.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_lstm_forward(**lmeta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_lstm_backward(hs=g, cs=g, ghs=g, **lmeta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_lstm_weight_grads(g, lmeta["gi"])
    from snsde_torch.kernels import _build
    from snsde_torch.kernels._solver import SolverLib

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    lib = SolverLib("fused_gru", "fused GRU", 10, 19,
                    int_names=fr._GRU.int_names,
                    shape_names=fr._GRU.shape_names, source="fused_rnn")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.kept("max_smem")
