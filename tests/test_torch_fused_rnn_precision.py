"""The fused GRU and LSTM pairs' reduced-precision modes, port against the
JAX package on the CPU: bf16 streams (SNSDE_FUSED_STREAM, `stream_dtype=`)
and bf16 or bf16x3 operands of the in-kernel products (SNSDE_FUSED_MATMUL,
`matmul=`), in every mode of both recurrences.

The JAX kernels run in Pallas interpret mode (SNSDE_FUSED_INTERPRET=1) with
the modes set through the environment, through `fused_gru_scan` /
`fused_lstm_scan` and `jax.vjp`; the port runs its scans, whose
autograd.Functions take the plain versions for CPU tensors (what
chip_smoke.py holds the CUDA kernels against). Both sides get the same
input-projection stream gi (each scan is handed a cell whose w_ih is the
identity and b_ih zero), weights, mode inputs and output cotangent, drawn
with numpy, as in tests/test_torch_fused_rnn_modes.py. The bars are those
of tests/test_torch_fused_em_precision.py: every hs entry within one bf16
ulp of |hs| plus 1e-6 (both sides round the same values, but a 1-ulp
difference of their fp32 sums can flip one rounding), every cotangent
within 2e-3 of its largest entry.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde_torch.kernels import fused_rnn as fr
from snsde_torch.kernels._solver import bf16_round

from test_torch_fused_em_precision import (COMBOS, GRAD_TOL, _check, _dtype,
                                           _jax_modes)

B, H, L = 5, 16, 6
BENCH = ("bf16x3", "bf16")
# (pair, mode, operand mode, stream dtype, reverse): every mode of both
# pairs in bench.py's own combination, and each other combination in two
# modes, one of them in the reverse direction (a JAX forward and gradient
# at this size takes ~4 s in interpret mode)
MODES = {"gru": ("plain", "dec", "obs", "row", "ode"),
         "lstm": ("plain", "ode", "sel", "tg", "tlstm")}
CASES = ([(pair, mode) + BENCH + (False,) for pair in MODES
          for mode in MODES[pair]]
         + [("gru", "plain", "f32", "bf16", True),
            ("lstm", "tlstm", "f32", "bf16", False),
            ("gru", "obs", "bf16x3", "f32", False),
            ("lstm", "sel", "bf16x3", "f32", False),
            ("gru", "ode", "bf16", "f32", False),
            ("lstm", "tg", "bf16", "f32", False),
            ("gru", "row", "bf16", "bf16", False),
            ("lstm", "ode", "bf16", "bf16", False)])
assert all(sum(c[2:4] == combo for c in CASES) >= 2 for combo in COMBOS)
# each case's control runs the port in another operand mode, whose hs and
# cotangents must lie SPREAD times further from JAX's, in rms, than the
# port's in the case's own mode: bf16x3 is told from one bf16 pass (from
# exact fp32 it is ~2^-17 a term), bf16 from fp32 (chip_smoke.py's
# PREC_CONTROL and PREC_SPREAD)
CONTROL = {"f32": "bf16", "bf16x3": "bf16", "bf16": "f32"}
SPREAD = 4.0


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.delenv("SNSDE_FUSED_STREAM", raising=False)
    monkeypatch.delenv("SNSDE_FUSED_MATMUL", raising=False)


def _inputs(pair, mode, seed=0):
    """(differentiable inputs, data, ghs) of a mode: gi, W_hh, b_hh, the
    GRU's h0, the per-sample decay hdec or the decay row hrow, a two-layer
    evolve MLP (wf/bf, hh = 8) with its elapsed times, PLSTM's sel, TGLSTM's
    tg, TLSTM's W_d, b_d and elapsed times, the observation mask."""
    rng = np.random.default_rng(seed)
    G = 3 if pair == "gru" else 4
    k = 1.0 / np.sqrt(H)
    f = lambda a: np.asarray(a, np.float32)
    inp = {"gi": f(rng.normal(size=(L, B, G * H))),
           "whh": f(rng.uniform(-k, k, size=(H, G * H))),
           "bhh": f(rng.uniform(-k, k, size=(G * H,)))}
    data = {}
    if pair == "gru":
        inp["h0"] = f(0.5 * rng.normal(size=(B, H)))
        if mode in ("obs", "row", "ode"):
            o = (rng.uniform(size=(L, B)) < 0.6).astype(np.float32)
            o[0] = 1.0
            data["obs"] = o
    if mode == "dec":
        inp["hdec"] = f(rng.uniform(0.2, 1.0, size=(L, B, H)))
    elif mode == "row":
        inp["hdec"] = f(rng.uniform(0.2, 1.0, size=(L, H)))
    elif mode == "ode":
        for i, (fi, fo) in enumerate(((H, 8), (8, H))):
            kk = 1.0 / np.sqrt(fi)
            inp[f"wf{i}"] = f(rng.uniform(-kk, kk, size=(fi, fo)))
            inp[f"bf{i}"] = f(rng.uniform(-kk, kk, size=(fo,)))
        data["dt"] = f(rng.uniform(0.0, 0.4, size=(L,) if pair == "gru"
                                   else (L, B)))
    elif mode == "sel":
        inp["sel"] = f(rng.uniform(size=(L, B, H)))
    elif mode == "tg":
        inp["tg"] = f(1.0 / (1.0 + np.exp(-rng.normal(size=(L, B, 3 * H)))))
    elif mode == "tlstm":
        inp["wd"] = f(rng.uniform(-k, k, size=(H, H)))
        inp["bd"] = f(rng.uniform(-k, k, size=(H,)))
        data["tel"] = f(rng.uniform(0.0, 2.0, size=(L, B)))
    return inp, data, f(rng.normal(size=(L, B, H)))


def _jax_side(monkeypatch, pair, inp, data, ghs, matmul, stream, reverse):
    """(hs, {name: cotangent}) of the JAX kernel through jax.vjp, the
    precision set through the environment."""
    from snsde.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan

    _jax_modes(monkeypatch, matmul, stream)
    G = 3 if pair == "gru" else 4
    names = sorted(inp)

    def f(*args):
        a = dict(zip(names, args))
        cell = SimpleNamespace(w_ih=jnp.eye(G * H, dtype=jnp.float32),
                               b_ih=jnp.zeros((G * H,), jnp.float32),
                               w_hh=a["whh"], b_hh=a["bhh"], hidden_size=H)
        layers = (tuple(SimpleNamespace(weight=a[f"wf{i}"], bias=a[f"bf{i}"])
                        for i in range(2)) if "wf0" in a else None)
        dt = jnp.asarray(data["dt"]) if layers else None
        if pair == "gru":
            obs = data.get("obs")
            return fused_gru_scan(
                cell, a["gi"], h0=a["h0"], reverse=reverse,
                obs=None if obs is None else jnp.asarray(obs),
                hdec=a.get("hdec"), ode_layers=layers, tdif=dt)
        tl = (SimpleNamespace(weight=a["wd"], bias=a["bd"]) if "wd" in a
              else None)
        return fused_lstm_scan(
            cell, a["gi"], reverse=reverse, sel=a.get("sel"), tg=a.get("tg"),
            ode_layers=layers, odt=dt, tlstm=tl,
            tel=jnp.asarray(data["tel"]) if tl is not None else None)

    hs, vjp = jax.vjp(f, *(jnp.asarray(inp[k]) for k in names))
    grads = vjp(jnp.asarray(ghs))
    return np.asarray(hs), {k: np.asarray(g) for k, g in zip(names, grads)}


def _rms(a, ref):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - ref) ** 2)))


def _linear(w, b):
    """A torch nn.Linear of the JAX layout's weight [in, out] and bias."""
    lin = torch.nn.Linear(*w.shape)
    lin.weight = torch.nn.Parameter(torch.as_tensor(w).T.clone())
    lin.bias = torch.nn.Parameter(torch.as_tensor(b).clone())
    return lin


def _port_side(pair, inp, data, ghs, reverse, **prec):
    """(hs, {name: cotangent}) of the port's scan through autograd, the
    precision asked by argument (`prec`: stream_dtype, matmul; none: the
    environment's)."""
    G = 3 if pair == "gru" else 4
    t = {k: torch.as_tensor(v).requires_grad_(True) for k, v in inp.items()
         if not k.startswith(("wf", "bf", "wd", "bd"))}
    cell = SimpleNamespace(w_ih=torch.eye(G * H), b_ih=torch.zeros(G * H),
                           w_hh=t["whh"], b_hh=t["bhh"], hidden_size=H)
    layers = ([_linear(inp[f"wf{i}"], inp[f"bf{i}"]) for i in range(2)]
              if "wf0" in inp else None)
    dt = data.get("dt")
    if pair == "gru":
        obs = data.get("obs")
        hs = fr.fused_gru_scan(
            cell, t["gi"], h0=t["h0"], reverse=reverse,
            obs=None if obs is None else torch.as_tensor(obs),
            hdec=t.get("hdec"), ode_layers=layers, tdif=dt, **prec)
    else:
        tl = _linear(inp["wd"], inp["bd"]) if "wd" in inp else None
        hs = fr.fused_lstm_scan(
            cell, t["gi"], reverse=reverse, sel=t.get("sel"), tg=t.get("tg"),
            ode_layers=layers, odt=dt, tlstm=tl,
            tel=torch.as_tensor(data["tel"]) if tl else None, **prec)
    hs.backward(torch.as_tensor(ghs))
    grads = {k: v.grad.numpy() for k, v in t.items()}
    for i, lin in enumerate(layers or ()):
        grads[f"wf{i}"] = lin.weight.grad.T.numpy()
        grads[f"bf{i}"] = lin.bias.grad.numpy()
    if pair == "lstm" and "wd" in inp:
        grads["wd"] = tl.weight.grad.T.numpy()
        grads["bd"] = tl.bias.grad.numpy()
    return hs.detach().numpy(), grads


@pytest.mark.parametrize("pair,mode,matmul,stream,reverse", CASES)
def test_scan_matches_jax_kernel_in_reduced_precision(monkeypatch, pair,
                                                      mode, matmul, stream,
                                                      reverse):
    """hs and every cotangent (gi, h0, W_hh, b_hh, the decays, the evolve's
    layers, sel, tg, W_d, b_d) of the port's scan in the precision against
    the JAX kernel in it, by the EM precision test's bars; each cotangent
    compared. The controls: with bf16 streams the port in exact fp32 fails
    those bars against the same JAX result; in every case the port in
    CONTROL's operand mode, with the same streams, is SPREAD times further
    from it in rms, in hs and in each cotangent (the bars alone cannot
    tell bf16 from fp32 operands at this width)."""
    inp, data, ghs = _inputs(pair, mode, seed=len(mode) + 7 * (pair == "gru"))
    hs_j, g_j = _jax_side(monkeypatch, pair, inp, data, ghs, matmul, stream,
                          reverse)
    hs_t, g_t = _port_side(pair, inp, data, ghs, reverse,
                           stream_dtype=_dtype(stream), matmul=matmul)
    assert set(g_j) == set(inp) == set(g_t)
    label = f"{pair} {mode} {matmul} {stream}"
    assert _check(hs_t, hs_j, g_t, g_j, label) == len(inp)
    if stream == "bf16":
        hs_f, g_f = _port_side(pair, inp, data, ghs, reverse,
                               stream_dtype=torch.float32, matmul="f32")
        with pytest.raises(AssertionError):
            _check(hs_f, hs_j, g_f, g_j, f"{label} control")
    hs_c, g_c = _port_side(pair, inp, data, ghs, reverse,
                           stream_dtype=_dtype(stream),
                           matmul=CONTROL[matmul])
    for name, ours, ctl, ref in ([("hs", hs_t, hs_c, hs_j)]
                                 + [(n, g_t[n], g_c[n], g_j[n])
                                    for n in g_j]):
        near, far = _rms(ours, ref), _rms(ctl, ref)
        assert SPREAD * near < far, (f"{label} {name}: {near:.3e} (rms) "
                                     f"from JAX, in {CONTROL[matmul]} "
                                     f"operands {far:.3e}")


def test_none_resolves_from_the_environment(monkeypatch):
    """Unset precision arguments take SNSDE_FUSED_STREAM and
    SNSDE_FUSED_MATMUL, as the JAX scans read them: the same bits as the
    arguments asked, in both pairs (the LSTM's TLSTM mode, which rounds
    every stream it has)."""
    for pair, mode in (("gru", "dec"), ("lstm", "tlstm")):
        inp, data, ghs = _inputs(pair, mode, seed=3)
        for matmul, stream in COMBOS:
            want = _port_side(pair, inp, data, ghs, False,
                              stream_dtype=_dtype(stream), matmul=matmul)
            with monkeypatch.context() as m:
                _jax_modes(m, matmul, stream)
                got = _port_side(pair, inp, data, ghs, False)
            np.testing.assert_array_equal(got[0], want[0])
            for name in want[1]:
                np.testing.assert_array_equal(got[1][name], want[1][name])


@pytest.mark.parametrize("pair,mode", [("gru", "ode"), ("lstm", "ode")])
def test_fp32_is_the_default_and_is_exact(pair, mode):
    """Without arguments or variables the scans run in exact fp32: the
    bits of stream_dtype=float32, matmul='f32'; every reduced combination
    gives other bits; and the fp32 plain versions are float32's own
    arithmetic: within 2e-6 of a float64 run of them."""
    inp, data, ghs = _inputs(pair, mode, seed=5)
    default = _port_side(pair, inp, data, ghs, False)
    exact = _port_side(pair, inp, data, ghs, False,
                       stream_dtype=torch.float32, matmul="f32")
    np.testing.assert_array_equal(default[0], exact[0])
    for name in exact[1]:
        np.testing.assert_array_equal(default[1][name], exact[1][name])
    for matmul, stream in COMBOS:
        red = _port_side(pair, inp, data, ghs, False,
                         stream_dtype=_dtype(stream), matmul=matmul)
        assert not np.array_equal(red[0], exact[0]), (matmul, stream)
    with torch.no_grad():
        t = {k: torch.as_tensor(v).double() for k, v in inp.items()}
        ode = fr.Evolve(fr.pack_mlp([_linear(inp["wf0"], inp["bf0"]),
                                     _linear(inp["wf1"], inp["bf1"])])
                        .double(), torch.as_tensor(data["dt"]).double(),
                        2, 8, 1)
        if pair == "gru":
            hs64 = fr.fused_gru_forward_reference(
                t["gi"], t["h0"], t["whh"], t["bhh"],
                obs=torch.as_tensor(data["obs"]).double(), ode=ode)
        else:
            hs64 = fr.fused_lstm_forward_reference(t["gi"], t["whh"],
                                                   t["bhh"], ode=ode)[0]
    assert float(np.abs(exact[0] - hs64.numpy()).max()) < 2e-6


@pytest.mark.parametrize("pair", ["gru", "lstm"])
def test_reduced_weight_gradient_products_take_the_mode(pair):
    """The weight gradients' plain versions take the fp32 gate cotangents
    and the mode's operands (fused_rnn.py:168, :723): with bf16 streams
    W_hh's gradient is the product over the fp32 cotangents (the LSTM's
    dgw beside its bf16 dgi, the GRU's dgh), which the product over the
    cotangents rounded to bf16 would move; and bf16x3 sits within a tenth
    of its gap to one bf16 pass from exact fp32's product over the same
    operands."""
    inp, data, ghs = _inputs(pair, "plain", seed=11)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    kw = dict(stream="bf16", matmul="bf16x3")
    if pair == "lstm":
        hs, cs, _ = fr.fused_lstm_forward_reference(
            t["gi"].bfloat16(), t["whh"], t["bhh"], **kw)
        rec = fr._lstm_reverse(t["gi"].bfloat16(), hs, cs,
                               torch.as_tensor(ghs).bfloat16(), t["whh"],
                               t["bhh"], **kw)
        assert rec.dgi.dtype == torch.bfloat16 and rec.dgw.dtype == \
            torch.float32
        got = fr.fused_lstm_backward_reference(
            t["gi"].bfloat16(), hs, cs, torch.as_tensor(ghs).bfloat16(),
            t["whh"], t["bhh"], **kw).dwhh
        prods = {m: fr.fused_lstm_weight_grads_reference(hs, rec.dgw,
                                                         matmul=m)[0]
                 for m in ("f32", "bf16x3", "bf16")}
        rounded = fr.fused_lstm_weight_grads_reference(
            hs, bf16_round(rec.dgw), matmul="bf16x3")[0]
    else:
        hs = fr.fused_gru_forward_reference(t["gi"].bfloat16(), t["h0"],
                                            t["whh"], t["bhh"], **kw)
        rec = fr._gru_reverse(t["gi"].bfloat16(), hs,
                              torch.as_tensor(ghs).bfloat16(), t["h0"],
                              t["whh"], t["bhh"], **kw)
        got = fr.fused_gru_backward_reference(
            t["gi"].bfloat16(), hs, torch.as_tensor(ghs).bfloat16(), t["h0"],
            t["whh"], t["bhh"], **kw).dwhh
        h0r = t["h0"].bfloat16()
        prods = {m: fr.fused_gru_weight_grads_reference(h0r, hs, rec.dgh,
                                                        matmul=m)[0]
                 for m in ("f32", "bf16x3", "bf16")}
        rounded = fr.fused_gru_weight_grads_reference(
            h0r, hs, bf16_round(rec.dgh), matmul="bf16x3")[0]
    assert torch.equal(got, prods["bf16x3"])
    gap = float((prods["bf16"] - prods["f32"]).abs().max())
    assert float((prods["bf16x3"] - prods["f32"]).abs().max()) < 0.1 * gap
    scale = float(prods["f32"].abs().max())
    assert float((rounded - got).abs().max()) > 1e-4 * scale
    assert float((got - prods["f32"]).abs().max()) < GRAD_TOL * scale
