"""The port's CDE solvers and Neural CDE models against the JAX package, on
the CPU.

`CubicPath.derivative`/`derivative_grid` on natural cubic coefficients of
series with missing values, the fixed-grid `odeint` and `cdeint` for every
fixed method, the FinalTanh, SingleHiddenLayer and GRU-ODE fields, and the
NeuralCDE and NeuralCDEStream models, with the JAX weights carried across
by snsde_torch.convert. On the CPU the port's dispatch takes the eager
`cdeint`, as the JAX package's does off the TPU.

Tolerances: derivatives and field outputs 1e-5 (the same float32
arithmetic, another summation order); trajectories and model outputs
1e-5 absolute, as in tests/test_torch_fused_cde.py.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.models import neuralcde as jcde
from snsde.ops import interp as jinterp
from snsde.ops import solve as jsolve

from snsde_torch.convert import load_jax_arrays
from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.models import neuralcde as tcde
from snsde_torch.models import resolve_dt
from snsde_torch.ops import CubicPath, cdeint, odeint

B, L, C, H, HH = 6, 7, 3, 4, 5
TOL = 1e-5
FIXED = ["euler", "midpoint", "heun", "rk2", "rk4"]


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (BatchNorm buffers
    without their `.value`), the key format of snsde_torch.convert."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def _times(irregular):
    if not irregular:
        return np.linspace(0.0, 1.0, L).astype(np.float32)
    rng = np.random.default_rng(7)
    return np.sort(rng.uniform(0.0, 1.0, L)).astype(np.float32)


def _coeffs(times, seed=0, missing=0.3):
    """Natural cubic coefficients (the JAX fit) of series with missing
    values, as numpy [B, L-1, 4C]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < missing] = np.nan
    return np.asarray(jinterp.natural_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(x), pack=True))


@pytest.mark.parametrize("irregular", [False, True])
def test_derivative_matches_jax(irregular):
    """dX/dt at single device times and on a host grid (knots, points
    between them, and times outside the knots, which take the end
    intervals), on coefficients fitted to series with missing values."""
    times = _times(irregular)
    coeffs = _coeffs(times)
    assert np.isfinite(coeffs).all()
    jpath = jinterp.CubicPath(jnp.asarray(coeffs), times)
    path = CubicPath(torch.as_tensor(coeffs), times)
    mids = 0.5 * (times[1:] + times[:-1])
    ts = np.concatenate([times, mids, [times[0] - 0.1, times[-1] + 0.2]])
    ts = ts.astype(np.float32)
    for t in ts[::3]:
        np.testing.assert_allclose(path.derivative(float(t)).numpy(),
                                   np.asarray(jpath.derivative(t)),
                                   rtol=TOL, atol=TOL)
    got = path.derivative_grid(ts)
    assert got.shape == (len(ts), B, C)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpath.derivative_grid(ts)),
                               rtol=TOL, atol=TOL)


def _field_pair(kind, n_inner=1, Cn=C, seed=0):
    """(JAX field, port field) with the same weights."""
    key = jax.random.PRNGKey(seed)
    if kind == "final_tanh":
        jf = jcde.FinalTanh.create(key, Cn, H, HH, n_inner + 1)
        tf = tcde.FinalTanh(Cn, H, HH, n_inner + 1)
    elif kind == "single":
        jf = jcde.SingleHiddenLayer.create(key, Cn, H, HH)
        tf = tcde.SingleHiddenLayer(Cn, H, HH)
    else:
        jf = jcde.GRUODEField.create(key, Cn, H)
        tf = tcde.GRUODEField(Cn, H)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


@pytest.mark.parametrize("kind,n_inner", [("final_tanh", 0),
                                          ("final_tanh", 1),
                                          ("final_tanh", 2), ("single", 0),
                                          ("gruode", 0)])
def test_fields_match_jax(kind, n_inner):
    jf, tf = _field_pair(kind, n_inner)
    z = np.random.default_rng(1).normal(size=(B, H)).astype(np.float32)
    got = tf(0.0, torch.as_tensor(z))
    assert got.shape == (B, H, C)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jf(0.0, jnp.asarray(z))),
                               rtol=TOL, atol=TOL)


def _ode_fns(seed=2):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(H, H)).astype(np.float32) / 2

    def jf(t, y):
        return jnp.tanh(y @ W) * jnp.cos(3.0 * t) - 0.2 * y

    Wt = torch.as_tensor(W)

    def tf(t, y):
        return torch.tanh(y @ Wt) * torch.cos(3.0 * t) - 0.2 * y

    y0 = rng.normal(size=(B, H)).astype(np.float32)
    return jf, tf, y0


@pytest.mark.parametrize("method", FIXED)
def test_odeint_matches_jax(method):
    """The whole trajectory on a grid that steps between the output times
    (dt = 0.07 over six outputs in [0, 1])."""
    jf, tf, y0 = _ode_fns()
    ts = np.linspace(0.0, 1.0, 6).astype(np.float32)
    want = jsolve.odeint(jf, jnp.asarray(y0), ts, dt=0.07, method=method)
    got = odeint(tf, torch.as_tensor(y0), ts, dt=0.07, method=method)
    assert got.shape == (6, B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("method", FIXED)
@pytest.mark.parametrize("irregular", [False, True])
def test_cdeint_matches_jax(method, irregular):
    """dz = f(z) dX(t) with a FinalTanh field on a natural cubic control,
    stepped at the smallest knot gap (the NeuralCDE default)."""
    times = _times(irregular)
    coeffs = _coeffs(times, seed=3)
    jf, tf = _field_pair("final_tanh")
    z0 = np.random.default_rng(4).normal(size=(B, H)).astype(np.float32)
    dt = resolve_dt(times, floor=0.0)
    want = jsolve.cdeint(jinterp.CubicPath(jnp.asarray(coeffs), times), jf,
                         jnp.asarray(z0), times, dt=dt, method=method)
    path = CubicPath(torch.as_tensor(coeffs), times)
    got = cdeint(path, tf, torch.as_tensor(z0), times, dt=dt, method=method)
    assert got.shape == (L, B, H)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)
    # the fused solve's plain version (what a CPU tensor gets) agrees with
    # the eager loop on the same grid
    fused = fused_cde_solve(tf, path, times, torch.as_tensor(z0), dt=dt,
                            method=method)
    np.testing.assert_allclose(fused.detach().numpy(), np.asarray(want),
                               atol=TOL)


def _models(kind, field="final_tanh", control="natural", seed=5):
    key = jax.random.PRNGKey(seed)
    jf, tf = _field_pair(field, Cn=C + 1, seed=seed + 1)
    if kind == "terminal":
        jm = jcde.NeuralCDE.create(key, jf, C + 1, H, 2, control=control)
        tm = tcde.NeuralCDE(tf, C + 1, H, 2, control=control)
    else:
        jm = jcde.NeuralCDEStream.create(key, jf, C + 1, H, 2,
                                         control=control)
        tm = tcde.NeuralCDEStream(tf, C + 1, H, 2, control=control)
    load_jax_arrays(tm, jax_arrays(jm))
    tm.eval()
    return jm, tm


def _model_data(seed=6):
    """Knot times and natural coefficients over (time ‖ values)."""
    times = _times(False)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    vals = np.concatenate([np.broadcast_to(times[None, :, None], (B, L, 1)),
                           x], axis=-1)
    coeffs = np.asarray(jinterp.natural_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(vals), pack=True))
    return times, coeffs


@pytest.mark.parametrize("stream", [False, True])
def test_neural_cde_matches_jax(stream):
    """The terminal model (eval mode: BatchNorm on its running statistics,
    no dropout): logits at each series' final index, or at every step."""
    jm, tm = _models("terminal")
    times, coeffs = _model_data()
    final = np.array([L - 1, 3, 5, L - 1, 2, 6])
    want, _ = jm(times, jnp.asarray(coeffs), final, stream=stream)
    with torch.no_grad():
        got = tm(times, torch.as_tensor(coeffs), torch.as_tensor(final),
                 stream=stream)
    assert got.shape == ((B, L, 2) if stream else (B, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("field", ["final_tanh", "single", "gruode"])
def test_neural_cde_stream_matches_jax(field):
    """The stream model: the per-step readout and the trajectory [B, L, H]."""
    jm, tm = _models("stream", field=field)
    times, coeffs = _model_data(seed=8)
    out_j, z_j = jm(times, jnp.asarray(coeffs))
    with torch.no_grad():
        out_t, z_t = tm(times, torch.as_tensor(coeffs))
    assert out_t.shape == (B, L, 2) and z_t.shape == (B, L, H)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=TOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)


def test_dispatch_on_the_cpu_takes_the_eager_solve(monkeypatch):
    """A CPU tensor never reaches the fused solve, whatever the field; on
    the card every field takes the kernels, the GRU-ODE field too, on
    every tableau."""
    def no_fused(*a, **k):
        raise AssertionError("the fused CDE solve was called")

    monkeypatch.setattr(tcde, "fused_cde_solve", no_fused)
    times, coeffs = _model_data()
    for field in ("final_tanh", "gruode"):
        _, tm = _models("stream", field=field)
        tm(times, torch.as_tensor(coeffs))
    for method in ("euler", "midpoint", "heun", "rk2", "rk4"):
        assert tcde.supports_fused_cde(tcde.GRUODEField(C, H), method)
