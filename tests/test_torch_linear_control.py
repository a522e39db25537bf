"""The port's linear and rectilinear controls against the JAX package, on
the CPU: `linear_coeffs`, `rectilinear_coeffs` and `LinearPath` on
NaN-gapped data and at stage times on knots, `NeuralCDEStream(control=
"linear")` through the eager `cdeint` and through the fused CDE solve's
plain versions (the route a CUDA tensor takes to the kernels, its control
stream from `LinearPath.derivative_grid`), the `neuralcde-l` and
`neuralcde-r` registry layers carried over from JAX, and a one-epoch CPU
sweep of `neuralcde-l`.

Tolerances: knot values, times and slopes 1e-6 (the same float32
formulas); trajectories and model outputs the port's CDE tolerance 1e-5
absolute (tests/test_torch_cde.py), and every gradient 1e-5 of its largest
entry.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.kernels.fused_cde import _stage_grid as jax_stage_grid
from snsde.kernels.fused_cde import _stage_times as jax_stage_times
from snsde.models import neuralcde as jcde
from snsde.nn.core import filter_value_and_grad
from snsde.ops import interp as jinterp
from snsde.ops import solve as jsolve
from snsde.registry import make_seq_layer as jax_make_seq_layer

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels.fused_cde import _stage_grid, fused_cde_solve
from snsde_torch.models import neuralcde as tcde
from snsde_torch.models import resolve_dt
from snsde_torch.ops import (LinearPath, cdeint, linear_coeffs, make_grid,
                             rectilinear_coeffs)
from snsde_torch.registry import make_seq_layer

from test_torch_fused_em import jax_arrays

B, L, C, H = 5, 7, 4, 6
TOL = 1e-5
TOL_KNOT = 1e-6


def _nan_series(seed=0):
    """Irregular times; random holes, a leading and a trailing NaN run, an
    all-NaN channel and a channel observed once."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, :3, 1] = np.nan
    x[:, -2:, 2] = np.nan
    x[:, :, 3] = np.nan
    x[:, 4, 3] = 1.5
    x[0, :, 0] = np.nan
    times = np.cumsum(rng.uniform(0.2, 1.0, L)).astype(np.float32)
    return times, x


def test_linear_coeffs_match_jax():
    times, x = _nan_series()
    ref = np.asarray(jinterp.linear_coeffs(jnp.asarray(times),
                                           jnp.asarray(x)))
    ours = linear_coeffs(torch.as_tensor(times), torch.as_tensor(x)).numpy()
    assert np.isfinite(ours).all() and ours.shape == (B, L, C)
    np.testing.assert_allclose(ours, ref, atol=TOL_KNOT)


@pytest.mark.parametrize("time_index", [0, None])
def test_rectilinear_coeffs_match_jax(time_index):
    """The doubled knots (2L-1 of them) and values, the time channel
    overwritten by the knot times unless time_index is None."""
    times, x = _nan_series(1)
    t_ref, v_ref = jinterp.rectilinear_coeffs(jnp.asarray(times),
                                              jnp.asarray(x),
                                              time_index=time_index)
    t_ours, v_ours = rectilinear_coeffs(torch.as_tensor(times),
                                        torch.as_tensor(x),
                                        time_index=time_index)
    assert t_ours.shape == (2 * L - 1,) and v_ours.shape == (B, 2 * L - 1, C)
    np.testing.assert_array_equal(t_ours.numpy(), np.asarray(t_ref))
    np.testing.assert_allclose(v_ours.numpy(), np.asarray(v_ref),
                               atol=TOL_KNOT)


def _paths(seed=2):
    times, x = _nan_series(seed)
    vals = np.asarray(jinterp.linear_coeffs(jnp.asarray(times),
                                            jnp.asarray(x)))
    return (times, vals, jinterp.LinearPath(times=jnp.asarray(times),
                                            values=jnp.asarray(vals)),
            LinearPath(times, torch.as_tensor(vals)))


def test_linear_path_matches_jax():
    """evaluate and derivative at knots (a knot takes the LEFT segment),
    between knots and outside them; derivative_grid at rk4's stage times
    on the smallest knot gap (stage times on or an ulp from knots)."""
    times, vals, jp, tp = _paths()
    mids = 0.5 * (times[1:] + times[:-1])
    ts = np.concatenate([times, mids, [times[0] - 0.3, times[-1] + 0.2]])
    for t in ts.astype(np.float32):
        tt = torch.tensor(t)
        np.testing.assert_allclose(tp.evaluate(tt).numpy(),
                                   np.asarray(jp.evaluate(jnp.float32(t))),
                                   atol=TOL_KNOT, err_msg=f"t={t}")
        np.testing.assert_allclose(tp.derivative(tt).numpy(),
                                   np.asarray(jp.derivative(jnp.float32(t))),
                                   atol=TOL_KNOT, err_msg=f"t={t}")
    # a knot time takes the segment before it
    k = 3
    slope = (vals[:, k] - vals[:, k - 1]) / (times[k] - times[k - 1])
    np.testing.assert_allclose(tp.derivative(torch.tensor(times[k])).numpy(),
                               slope, rtol=1e-5)
    grid, _ = make_grid(times, resolve_dt(times, floor=0.0))
    hs = np.diff(grid)
    ut, _ = jax_stage_times("rk4")
    stage = _stage_grid(grid, hs, ut)
    np.testing.assert_array_equal(stage, jax_stage_grid(grid, hs, ut))
    on_knot = np.isin(stage, times)
    assert on_knot.sum() >= L - 1, "no stage time on a knot"
    np.testing.assert_allclose(tp.derivative_grid(stage).numpy(),
                               np.asarray(jp.derivative_grid(stage)),
                               atol=TOL_KNOT)


def _field_pair(seed, Cn):
    jf = jcde.FinalTanh.create(jax.random.PRNGKey(seed), Cn, H, 5, 2)
    tf = tcde.FinalTanh(Cn, H, 5, 2)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


def _rel_err(ours, ref):
    return (float(np.abs(ours - ref).max())
            / max(float(np.abs(ref).max()), 1e-30))


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_cde_on_linear_path_matches_jax(route):
    """dz = f(z) dX on a LinearPath with rk4 at the smallest knot gap: the
    eager cdeint, or the fused solve's plain versions with their control
    stream from derivative_grid, against JAX's cdeint: the trajectory to
    1e-5, and the gradients of mean(zs^2) with respect to the field, z0
    and the knot values (through the differentiated stream) to 1e-5 of
    their largest entry."""
    times, vals, _, _ = _paths(3)
    jf, tf = _field_pair(4, C)
    z0 = np.random.default_rng(5).normal(size=(B, H)).astype(np.float32)
    dt = resolve_dt(times, floor=0.0)

    def jax_loss(tree):
        fld, zz, vv = tree
        zs = jsolve.cdeint(jinterp.LinearPath(times=jnp.asarray(times),
                                              values=vv),
                           fld, zz, times, dt=dt, method="rk4")
        return jnp.mean(zs ** 2), zs

    (_, zs_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jf, jnp.asarray(z0), jnp.asarray(vals)))
    z0_t = torch.as_tensor(z0).requires_grad_(True)
    v_t = torch.as_tensor(vals.copy()).requires_grad_(True)
    path = LinearPath(times, v_t)
    solve = cdeint if route == "eager" else (
        lambda p, f, z, ts, **kw: fused_cde_solve(f, p, ts, z, **kw))
    zs_t = solve(path, tf, z0_t, times, dt=dt, method="rk4")
    assert zs_t.shape == (L, B, H)
    np.testing.assert_allclose(zs_t.detach().numpy(), np.asarray(zs_j),
                               atol=TOL)
    (zs_t ** 2).mean().backward()
    ours = grads_to_jax_layout(tf)
    ours["z0"], ours["values"] = z0_t.grad.numpy(), v_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["z0"], theirs["values"] = np.asarray(g_j[1]), np.asarray(g_j[2])
    for name, ref in theirs.items():
        assert _rel_err(ours[name], ref) <= TOL, name


def test_neural_cde_stream_linear_matches_jax():
    """NeuralCDEStream(control="linear"): z0 from the path at times[0],
    the per-step readout and the trajectory, and every gradient."""
    times, vals, _, _ = _paths(6)
    key = jax.random.PRNGKey(7)
    jf, tf = _field_pair(8, C)
    jm = jcde.NeuralCDEStream.create(key, jf, C, H, 2, control="linear")
    tm = tcde.NeuralCDEStream(tf, C, H, 2, control="linear")
    load_jax_arrays(tm, jax_arrays(jm))

    def jax_loss(m):
        out, z = m(times, jnp.asarray(vals))
        return jnp.mean(out ** 2) + jnp.mean(z), (out, z)

    (_, (out_j, z_j)), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        jm)
    out_t, z_t = tm(times, torch.as_tensor(vals))
    assert out_t.shape == (B, L, 2) and z_t.shape == (B, L, H)
    np.testing.assert_allclose(z_t.detach().numpy(), np.asarray(z_j),
                               atol=TOL)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=TOL)
    ((out_t ** 2).mean() + z_t.mean()).backward()
    ours = grads_to_jax_layout(tm)
    for name, ref in jax_arrays(g_j).items():
        assert _rel_err(ours[name], ref) <= TOL, name


def test_unknown_control_raises():
    _, tf = _field_pair(9, C)
    times, vals, _, _ = _paths()
    with pytest.raises(ValueError, match="unknown control"):
        tcde.NeuralCDEStream(tf, C, H, 2, control="spline")(
            times, torch.as_tensor(vals))


def _seq(seed=10, D=3, Ls=9):
    """A stacked seq [B, 3, L, D] (values with NaN as 0, mask, delta)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Ls, D)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    mask = (x != 0).astype(np.float32)
    delta = rng.uniform(0.0, 0.3, size=x.shape).astype(np.float32)
    return np.stack([x, mask, delta], axis=1)


@pytest.mark.parametrize("name", ["neuralcde-l", "neuralcde-r"])
@pytest.mark.parametrize("fused", [False, True])
def test_registry_layers_match_jax(name, fused):
    """The registry layer carried from JAX (FinalTanh in a NeuralCDEStream
    on (time ‖ x) knots; -r stepping on the knot index of the rectilinear
    control and keeping the even steps): out and hidden streams [B, L, H]
    to 1e-5 and every gradient to 1e-5 of its largest entry, through the
    eager cdeint and through the fused solve's plain versions."""
    D, Ls = 3, 9
    seq = _seq(D=D, Ls=Ls)
    jl = jax_make_seq_layer(jax.random.PRNGKey(11), name, D, Ls, H,
                            num_hidden_layers=2)
    tl = make_seq_layer(name, D, Ls, H, num_hidden_layers=2)
    load_jax_arrays(tl, jax_arrays(jl))

    def jax_loss(m):
        out, hn = m(jnp.asarray(seq), None)
        return jnp.mean(out ** 2) + jnp.mean(hn), (out, hn)

    (_, (out_j, hn_j)), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        jl)
    if fused:
        # the route of a CUDA tensor: the fused solve's autograd.Function,
        # its plain versions on the CPU
        calls = []

        def dispatch(path, func, z0, ts, *, dt, method, use_fused=True):
            calls.append(method)
            return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)

        mp = pytest.MonkeyPatch()
        mp.setattr(tcde, "cde_solve_dispatch", dispatch)
    try:
        out_t, hn_t = tl(torch.as_tensor(seq), None)
    finally:
        if fused:
            mp.undo()
            assert calls == ["rk4"]
    assert out_t.shape == (B, Ls, H) and hn_t.shape == (B, Ls, H)
    np.testing.assert_allclose(hn_t.detach().numpy(), np.asarray(hn_j),
                               atol=TOL)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=TOL)
    ((out_t ** 2).mean() + hn_t.mean()).backward()
    ours = grads_to_jax_layout(tl)
    theirs = jax_arrays(g_j)
    assert set(theirs) <= set(ours)
    for key, ref in theirs.items():
        assert _rel_err(ours[key], ref) <= TOL, key


def test_sweep_trains_neuralcde_l(tmp_path):
    """One epoch of the robustness sweep with neuralcde-l on the CPU: a
    record with an accuracy and no error, rk4."""
    cfg = trob.SweepConfig(models=("neuralcde-l",), missing_rates=(0.3,),
                           seeds=(0,), hidden_dim=6, batch_size=16,
                           max_epochs=1, out_dir=str(tmp_path))
    trained = {}
    rec, = trob.run_robustness_sweep(
        cfg, n=48, data_fn=lambda n: trob.synthetic_uea(
            n=n, length=10, channels=2, num_classes=2, seed=0),
        verbose=False, device="cpu", models=trained)
    assert "error" not in rec and rec["method"] == "rk4"
    assert 0.0 <= rec["accuracy"] <= 1.0
    assert set(trained) == {(0.3, "neuralcde-l", 0)}
