"""The fused CDE pair's reduced-precision modes, port against the JAX package
on the CPU: bf16 streams (SNSDE_FUSED_STREAM, `stream_dtype=`) and bf16 or
bf16x3 operands of the MLP fields' in-kernel products and one-hot
contractions (SNSDE_FUSED_MATMUL, `matmul=`); the GRU-ODE field's operands
stay exact fp32 whatever is asked (snsde/kernels/fused_cde.py:691-697).

The JAX kernels run in Pallas interpret mode (SNSDE_FUSED_INTERPRET=1) with
the modes set through the environment, on a derivative stream handed to
both sides (JAX's dx_override, the port's FusedCDE input), so the gradient
reaches it on both; the port runs its plain versions (what its wrappers
take for CPU tensors, and what chip_smoke.py holds the CUDA kernels
against). The bars are those of tests/test_torch_fused_em_precision.py,
widened where the solve itself is that sensitive: single-pass bf16
operands flip a bf16 rounding wherever the two sides' fp32 sums part by an
ulp at a rounding boundary, and the flip moves a few trajectory entries by
up to ~1e-2 a few steps on (seen at 5 steps: JAX and the port agree to
2e-7 until one flips). So each bar also takes SPREAD times the largest
move of the port's own run with every product's and contraction's first
operand one fp32 ulp up before its rounding (_nudged: a flip wherever an
operand sits within an ulp of a bf16 boundary, as chip_smoke.py's nudged
runs on the card), which is as small as rounding where nothing flips.
"""

import contextlib

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.models.neuralcde import FinalTanh as JaxFinalTanh
from snsde.models.neuralcde import GRUODEField as JaxGRUODE
from snsde.models.neuralcde import SingleHiddenLayer as JaxSingle
from snsde.nn.core import filter_value_and_grad

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.kernels import _solver
from snsde_torch.kernels import fused_cde as fc
from snsde_torch.kernels import multi
from snsde_torch.models.neuralcde import (FinalTanh, GRUODEField,
                                          SingleHiddenLayer)
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

from test_torch_fused_em_precision import (COMBOS, GRAD_TOL, ULP, YS_ATOL,
                                           _dtype, _jax_modes, jax_arrays)

B, L, C, W = 13, 6, 3, 16
DT = 0.1
# how far past the port's own one-ulp move the two sides may part
# (chip_smoke.py's PREC_SPREAD)
SPREAD = 4.0
# (method, field kind, inner layers, operand mode, stream dtype): every
# reduced combination once over FinalTanh and SingleHiddenLayer, uea_rk4's
# field in bench_cde's production precision first (bf16x3, bf16 streams;
# tools/bench_cde.py:222-231); the GRU-ODE field with bf16 streams and bf16
# operands asked (its operands stay fp32)
CASES = [("rk4", "final_tanh", 1, "bf16x3", "bf16"),
         ("rk4", "final_tanh", 1, "f32", "bf16"),
         ("euler", "final_tanh", 0, "bf16x3", "f32"),
         ("rk4", "single", 0, "bf16", "f32"),
         ("midpoint", "single", 0, "bf16", "bf16"),
         ("rk4", "gruode", 0, "bf16", "bf16")]
assert sorted(c[3:] for c in CASES[:5]) == sorted(COMBOS)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.delenv("SNSDE_FUSED_STREAM", raising=False)
    monkeypatch.delenv("SNSDE_FUSED_MATMUL", raising=False)


def _fields(kind, n_inner, seed=3):
    """(JAX field, port field) with the same weights."""
    key = jax.random.PRNGKey(seed)
    if kind == "final_tanh":
        jf = JaxFinalTanh.create(key, C, W, W, n_inner + 1)
        tf = FinalTanh(C, W, W, n_inner + 1)
    elif kind == "single":
        jf = JaxSingle.create(key, C, W, W)
        tf = SingleHiddenLayer(C, W, W)
    else:
        jf = JaxGRUODE.create(key, C, W)
        tf = GRUODEField(C, W)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


def _setting(seed=0, Bn=B, Ln=L, brownian=False):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, C)).astype(np.float32)
    if brownian:          # the GRU-ODE field's gates feed its state back
        x = np.cumsum(x / np.sqrt(Ln), axis=1, dtype=np.float32)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    z0 = rng.normal(size=(Bn, W)).astype(np.float32)
    G = rng.normal(size=(Ln, Bn, W)).astype(np.float32)
    return times, path, z0, G


def _jax_solve(monkeypatch, jf, method, matmul, stream, times, z0, dx, G):
    from snsde.kernels.fused_cde import fused_cde_solve as jax_solve

    _jax_modes(monkeypatch, matmul, stream)

    def loss(tree):
        fld, zz, dd = tree
        zs = jax_solve(fld, None, times, zz, dt=DT, method=method,
                       dx_override=dd)
        return jnp.sum(zs * G), zs

    (_, zs), g = filter_value_and_grad(loss, has_aux=True)(
        (jf, jnp.asarray(z0), jnp.asarray(dx)))
    monkeypatch.delenv("SNSDE_FUSED_STREAM")
    monkeypatch.delenv("SNSDE_FUSED_MATMUL")
    grads = jax_arrays(g[0])
    grads["z0"], grads["dx"] = np.asarray(g[1]), np.asarray(g[2])
    return np.asarray(zs), grads


def _port_solve(tf, path, method, matmul, stream, times, z0, G):
    """The port's solve on the dx stream as a leaf (its cotangent read),
    through precision_inputs and FusedCDE as fused_cde_solve runs them."""
    tf.zero_grad()
    grid, out_idx = make_grid(times, DT)
    z0_t = torch.as_tensor(z0).requires_grad_(True)
    inp = fc.fused_cde_inputs(tf, path, grid, z0_t, method)
    dx_t = inp["dx"].detach().requires_grad_(True)
    inp = fc.precision_inputs(dict(inp, dx=dx_t), _dtype(stream), matmul)
    ys = fc.FusedCDE.apply(*(inp[k] for k in fc._ARG_ORDER), method,
                           inp["act"], inp["prec"])
    zs = _solver.widen_output(z0_t, ys)[torch.as_tensor(out_idx)]
    (zs * torch.as_tensor(G)).sum().backward()
    grads = grads_to_jax_layout(tf)
    grads["z0"], grads["dx"] = z0_t.grad.numpy(), dx_t.grad.numpy()
    return zs.detach().numpy(), grads, dx_t.detach().numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@contextlib.contextmanager
def _nudged(monkeypatch):
    """The plain versions with the first operand of every product and
    one-hot contraction one fp32 ulp up before its rounding."""
    up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
    with monkeypatch.context() as m:
        m.setattr(fc, "mm_op", lambda x, w, mm="f32":
                  _solver.mm_op(up(x), w, mm))
        m.setattr(fc, "one_hot_op", lambda v, mm="f32":
                  _solver.one_hot_op(up(v), mm))
        yield


@pytest.mark.parametrize("method,kind,n_inner,matmul,stream", CASES)
def test_solve_matches_jax_kernel_in_reduced_precision(monkeypatch, method,
                                                       kind, n_inner, matmul,
                                                       stream):
    """The port's solve (plain versions) in the mode against the JAX kernel
    in the same mode, at B=13, 5 steps, H=HH=16: every trajectory entry
    within one bf16 ulp of |zs| plus the larger of 1e-6 and SPREAD times
    the nudged run's largest move, every gradient (z0's and the derivative
    stream's, which passes through the bf16 rounding of ddx, too) within
    the larger of 2e-3 and SPREAD times the nudged run's move of it, of its
    leaf's largest entry. The
    control: apart from bf16x3 operands with fp32 streams (held at one
    contraction below), JAX's result in the mode moves its trajectory or
    some gradient past the bar from the port's exact fp32 result (which
    holds JAX's to 1e-4, tests/test_torch_fused_cde.py)."""
    times, path, z0, G = _setting(brownian=kind == "gruode")
    jf, tf = _fields(kind, n_inner)
    zs, g, dx = _port_solve(tf, path, method, matmul, stream, times, z0, G)
    with _nudged(monkeypatch):
        zs_n, g_n, _ = _port_solve(tf, path, method, matmul, stream, times,
                                   z0, G)
    zs_j, g_j = _jax_solve(monkeypatch, jf, method, matmul, stream, times,
                           z0, dx, G)
    label = f"{method} {kind} {matmul} {stream}"
    d = np.abs(zs - zs_j)
    floor = max(YS_ATOL, SPREAD * float(np.abs(zs_n - zs).max()))
    over = d - (ULP * np.abs(zs_j) + floor)
    assert over.max() <= 0, f"{label}: zs off by {over.max():.3e}"
    bars, n = {}, 0
    for name, ref in g_j.items():
        if not np.abs(ref).max():
            continue
        bars[name] = max(GRAD_TOL, SPREAD * _rel(g_n[name], g[name]))
        err = _rel(g[name], ref)
        assert err < bars[name], f"{label} grad {name}: {err:.2e}"
        n += 1
    assert n >= (4 if kind == "gruode" else 6)
    if (matmul, stream) != ("bf16x3", "f32"):
        zs_e, exact, _ = _port_solve(tf, path, method, "f32", "f32", times,
                                     z0, G)
        over_e = np.abs(zs_e - zs_j) - (ULP * np.abs(zs_j) + floor)
        gap = max(_rel(exact[k], g_j[k]) / bars[k] for k in bars)
        assert over_e.max() > 0 or gap > 1, (
            f"the mode moves JAX's trajectory only {over_e.max():.2e} past "
            f"its bar and its gradients {gap:.2f}x theirs")


@pytest.mark.parametrize("matmul", ["f32", "bf16x3", "bf16"])
def test_one_hot_contractions_match_jax(matmul):
    """The plain versions' one-hot contractions against JAX's on N(0,1)
    values (B=64, H=16, C=6, rk4's second stage time): the forward's k =
    (O (d E_j)) S and the backward's S^T and E_j^T contractions of
    _field_bwd (dd = (oh(dk) O) summed over h), each within a tenth of the
    gap from this mode's JAX result to the nearest other mode's, so
    bf16x3 is the split of d and of each term, not exact or one bf16
    pass."""
    from snsde.kernels.fused_cde import _config, _dot, _onehots

    rng = np.random.default_rng(7)
    Bn, H, Cn, j = 64, 16, 6, 1
    cfg = _config("rk4", "relu", 0, H, H, Cn, False, False)
    es, smat = _onehots(cfg)
    CHp, SW = cfg["CHp"], cfg["SW"]
    d = rng.normal(size=(Bn, Cn)).astype(np.float32)
    o = rng.normal(size=(Bn, H * Cn)).astype(np.float32)
    dk = rng.normal(size=(Bn, H)).astype(np.float32)
    dpad = np.zeros((Bn, SW), np.float32)
    dpad[:, j * Cn:(j + 1) * Cn] = d
    opad = np.zeros((Bn, CHp), np.float32)
    opad[:, :H * Cn] = o
    dkpad = np.zeros((Bn, cfg["Hp"]), np.float32)
    dkpad[:, :H] = dk
    modes = {"f32": False, "bf16x3": "x3", "bf16": True}

    def jax_side(mm):
        k = _dot(jnp.asarray(opad) * _dot(jnp.asarray(dpad), es[j], mm),
                 smat, mm)[:, :H]
        dp = _dot(jnp.asarray(dkpad), smat.T, mm)
        dd = _dot(dp * jnp.asarray(opad), es[j].T, mm)[:, j * Cn:(j + 1) * Cn]
        return [np.asarray(v, np.float64) for v in (k, dd)]

    jax_out = {m: jax_side(v) for m, v in modes.items()}
    oc = torch.as_tensor(o).reshape(Bn, H, Cn)
    k = _solver.one_hot_op(
        oc * _solver.one_hot_op(torch.as_tensor(d), matmul)[:, None, :],
        matmul).sum(-1)
    dp = _solver.one_hot_op(torch.as_tensor(dk), matmul)[:, :, None]
    dd = _solver.one_hot_op(dp * oc, matmul).sum(1)
    for i, ours in enumerate((k, dd)):
        err = np.abs(ours.double().numpy() - jax_out[matmul][i]).max()
        gap = min(np.abs(jax_out[matmul][i] - jax_out[m][i]).max()
                  for m in modes if m != matmul)
        assert err < 0.1 * gap, f"{matmul} [{i}]: {err:.2e} against {gap:.2e}"


@pytest.mark.parametrize("kind", ["final_tanh", "gruode"])
@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_packed_members_are_their_solo_solves(matmul, stream, kind):
    """A packed K=2 solve (fused_cde_solve_packed) in the mode: each
    member's trajectory and every gradient bit for bit its solo solve's
    (the GRU-ODE field's operands fp32 in both, whatever is asked)."""
    times, path, z0, _ = _setting(seed=11, Bn=5, Ln=4,
                                  brownian=kind == "gruode")
    z0s = torch.as_tensor(np.stack([z0, -0.5 * z0]))
    if kind == "gruode":
        funcs = [GRUODEField(C, W, generator=torch.Generator().manual_seed(k))
                 for k in range(2)]
    else:
        funcs = [FinalTanh(C, W, W, 2,
                           generator=torch.Generator().manual_seed(k))
                 for k in range(2)]
    prec = dict(stream_dtype=_dtype(stream), matmul=matmul)
    packed = multi.fused_cde_solve_packed(funcs, path, times, z0s, dt=DT,
                                          **prec)
    (packed ** 2).sum().backward()
    got = [[p.grad.clone() for p in f.parameters()] for f in funcs]
    for k, f in enumerate(funcs):
        f.zero_grad()
        solo = fc.fused_cde_solve(f, path, times, z0s[k], dt=DT, **prec)
        assert torch.equal(solo, packed[k].detach()), k
        (solo ** 2).sum().backward()
        for a, p in zip(got[k], f.parameters()):
            assert torch.equal(a, p.grad), k


def test_gruode_operands_stay_fp32():
    """SNSDE_FUSED_MATMUL=bf16 leaves the GRU-ODE field's solve exactly its
    fp32-operand solve (the entry pins its operands as JAX's does), with
    and without bf16 streams, while it moves FinalTanh's; and the kernel
    wrappers refuse reduced operands for the GRU-ODE field."""
    times, path, z0, _ = _setting(seed=5, Bn=5, brownian=True)
    gru = GRUODEField(C, W, generator=torch.Generator().manual_seed(1))
    mlp = FinalTanh(C, W, W, 2, generator=torch.Generator().manual_seed(1))
    z0 = torch.as_tensor(z0)
    with torch.no_grad():
        for sd in (torch.float32, torch.bfloat16):
            a = fc.fused_cde_solve(gru, path, times, z0, dt=DT,
                                   stream_dtype=sd, matmul="bf16")
            b = fc.fused_cde_solve(gru, path, times, z0, dt=DT,
                                   stream_dtype=sd, matmul="f32")
            assert torch.equal(a, b)
        assert not torch.equal(
            fc.fused_cde_solve(mlp, path, times, z0, dt=DT, matmul="bf16"),
            fc.fused_cde_solve(mlp, path, times, z0, dt=DT))
    inp = fc.fused_cde_inputs(gru, path, make_grid(times, DT)[0], z0, "rk4")
    with pytest.raises(ValueError, match="GRU-ODE"):
        fc.fused_cde_forward(*(inp[k] for k in fc._ARG_ORDER), method="rk4",
                             act="gruode", matmul="bf16")


def test_plain_versions_keep_the_forward_carry_and_round_the_trajectory():
    """With bf16 streams the forward's carry stays float32 (only the
    written trajectory is rounded): rounding the fp32-stream run's
    trajectory (with dx rounded beforehand) gives the bf16 run's bit for
    bit, and ddx leaves in bf16."""
    times, path, z0, _ = _setting(seed=6, Bn=5)
    _, tf = _fields("final_tanh", 1)
    grid, _ = make_grid(times, DT)
    inp = fc.fused_cde_inputs(tf, path, grid, torch.as_tensor(z0), "rk4")
    args = [inp[k] if inp[k] is None else inp[k].detach()
            for k in fc._ARG_ORDER]
    dx16 = args[1].to(torch.bfloat16)
    flags = dict(method="rk4", act="relu")
    ys16 = fc.fused_cde_forward_reference(args[0], dx16, *args[2:], **flags,
                                          stream="bf16")
    ys32 = fc.fused_cde_forward_reference(args[0], dx16.float(), *args[2:],
                                          **flags)
    assert ys16.dtype == torch.bfloat16
    assert torch.equal(ys16, ys32.to(torch.bfloat16))
    g = fc.fused_cde_backward_reference(args[0], ys16, torch.ones_like(ys16),
                                        dx16, *args[2:], **flags,
                                        stream="bf16")
    assert g.ddx.dtype == torch.bfloat16 and g.dz0.dtype == torch.float32
