"""The port's Virtual Brownian Tree, adaptive Euler–Maruyama and adaptive
and extra ODE solvers against the JAX package, on the CPU.

The tree's node draws come from one numpy table on both sides: the port's
through its `normals` seam, the JAX package's through a test-local table
tree put at `snsde.ops.brownian.VirtualBrownianTree`, which
`sdeint_adaptive` imports at call time (no file of snsde/ changes). W(t)
agrees to 1e-6, `sdeint_adaptive`'s ys to 1e-5 in both modes, and its
gradients with `differentiable=True` to 1e-4 of their largest entry; the
ODE solvers' outputs to 1e-5 on smooth problems and their gradients
(`differentiable=True`, JAX's masked scan) to 1e-4 of the largest entry.
The statistics of the tree's own counter-based draws are those of
tests/test_adaptive_sde.py.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import snsde.ops.brownian as jbrownian
from snsde.models import neuralcde as jcde
from snsde.ops import interp as jinterp
from snsde.ops import solve as jsolve

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.models import neuralcde as tcde
from snsde_torch.ops import (CubicPath, VirtualBrownianTree, cdeint, odeint,
                             odeint_dopri5, sdeint_adaptive)

from test_torch_fused_em import jax_arrays

B, H = 6, 4
DEPTH = 8
TOL_W, TOL_Y, TOL_G = 1e-6, 1e-5, 1e-4


def _table(shape, seed=0):
    """Node draws [2^(DEPTH+1), *shape]: node n's normals are row n."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2 ** (DEPTH + 1),) + shape).astype(np.float32)


def jax_table_tree(table):
    """The JAX package's VirtualBrownianTree (snsde/ops/brownian.py:103-
    181) with its node draws read from `table` instead of the key."""

    class TableTree:
        def __init__(self, key, t0, t1, shape, depth=18,
                     dtype=jnp.float32):
            assert depth == DEPTH and tuple(shape) == table.shape[1:]
            self.t0, self.t1, self.shape = t0, t1, tuple(shape)
            self.depth, self.dtype = depth, dtype
            self.tab = jnp.asarray(table)

        def evaluate(self, t):
            t = jnp.asarray(t, self.dtype)
            w1 = self.tab[1] * jnp.sqrt(jnp.asarray(self.t1 - self.t0,
                                                    self.dtype))

            def body(_, carry):
                s, e, ws, we, node = carry
                m = 0.5 * (s + e)
                wm = 0.5 * (ws + we) + self.tab[node] * jnp.sqrt(
                    0.25 * (e - s))
                go_left = t < m
                return (jnp.where(go_left, s, m), jnp.where(go_left, m, e),
                        jnp.where(go_left, ws, wm), jnp.where(go_left, wm, we),
                        jnp.where(go_left, 2 * node, 2 * node + 1))

            s, e, ws, we, _ = jax.lax.fori_loop(
                0, self.depth, body,
                (jnp.asarray(self.t0, self.dtype),
                 jnp.asarray(self.t1, self.dtype),
                 jnp.zeros(self.shape, self.dtype), w1, jnp.asarray(2)))
            frac = jnp.clip((t - s) / jnp.maximum(e - s, 1e-30), 0.0, 1.0)
            w = ws + frac * (we - ws)
            return jnp.where(t <= self.t0, jnp.zeros(self.shape, self.dtype),
                             jnp.where(t >= self.t1, w1, w))

    return TableTree


def port_tree(table, t0, t1):
    return VirtualBrownianTree(t0, t1, table.shape[1:], depth=DEPTH,
                               normals=lambda nodes: torch.as_tensor(
                                   table[nodes]))


def test_tree_matches_jax_on_one_table():
    """W(t) at the endpoints, outside them, on bisection midpoints (knots
    of the descent) and at random times, to 1e-6."""
    table = _table((B, H))
    t0, t1 = 0.25, 2.25
    jt = jax_table_tree(table)(None, t0, t1, (B, H), depth=DEPTH)
    pt = port_tree(table, t0, t1)
    rng = np.random.default_rng(1)
    span = t1 - t0
    ts = [t0, t1, t0 - 0.1, t1 + 0.5, t0 + span / 2, t0 + span / 4,
          t0 + 3 * span / 2 ** DEPTH, *(t0 + span * rng.random(8))]
    jeval = jax.jit(jt.evaluate)
    for t in np.asarray(ts, np.float32):
        np.testing.assert_allclose(pt.evaluate(t).numpy(),
                                   np.asarray(jeval(t)), atol=TOL_W,
                                   err_msg=f"t={t}")


def test_tree_queries_are_pure():
    """The same query gives the same bits in any order; W(t0) = 0; the
    counter draws do not depend on the order of the nodes asked for."""
    vbt = VirtualBrownianTree(0.0, 1.0, (256,), seed=0)
    a = vbt.evaluate(0.3713)
    _ = vbt.evaluate(0.9)
    torch.testing.assert_close(vbt.evaluate(0.3713), a, rtol=0, atol=0)
    assert float(vbt.evaluate(0.0).abs().max()) == 0.0
    torch.testing.assert_close(vbt.evaluate(1.0), vbt.evaluate(1.0),
                               rtol=0, atol=0)
    other = VirtualBrownianTree(0.0, 1.0, (256,), seed=1)
    assert float((other.evaluate(0.3713) - a).abs().max()) > 1e-3


def test_tree_marginal_statistics():
    """W(t) ~ N(0, t) at t = 0.25, 0.5, 0.9 (tests/test_adaptive_sde.py:
    32-38 bars)."""
    n = 8192
    vbt = VirtualBrownianTree(0.0, 1.0, (n,), seed=1)
    for t in (0.25, 0.5, 0.9):
        w = vbt.evaluate(t)
        assert abs(float(w.mean())) < 4.0 / np.sqrt(n)
        assert abs(float(w.var()) - t) < 6.0 * t / np.sqrt(n)


def test_tree_increment_independence():
    """W(0.7) - W(0.4) has variance 0.3 and is uncorrelated with W(0.4)
    (tests/test_adaptive_sde.py:40-48)."""
    vbt = VirtualBrownianTree(0.0, 1.0, (8192,), seed=2)
    w1 = vbt.evaluate(0.4)
    d = vbt.evaluate(0.7) - w1
    assert abs(float(d.var()) - 0.3) < 0.03
    assert abs(float(torch.corrcoef(torch.stack([w1, d]))[0, 1])) < 0.05


def _params(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, H)).astype(np.float32) * 0.6,
            rng.normal(size=(H,)).astype(np.float32) * 0.3,
            rng.normal(size=(H, H)).astype(np.float32) * 0.6,
            rng.normal(size=(B, H)).astype(np.float32))


def _sde_fns(lib, A, b, S):
    """A drift and a diffusion that mixes channels, in jnp or torch."""
    tanh, sig = ((jnp.tanh, jax.nn.sigmoid) if lib is jnp
                 else (torch.tanh, torch.sigmoid))
    f = lambda t, y: tanh(y @ A + b) - 0.5 * y
    g = lambda t, y: 0.4 * sig(y @ S)
    return f, g


ADAPTIVE_KW = dict(rtol=1e-2, atol=1e-3, vbt_depth=DEPTH)


@pytest.mark.parametrize("differentiable", [False, True])
def test_sdeint_adaptive_matches_jax(monkeypatch, differentiable):
    """On one table of node draws: ys to 1e-5; with differentiable=True
    the gradients of mean(ys^2) with respect to y0 and the drift's and
    diffusion's weights to 1e-4 of their largest entry."""
    table = _table((B, H), seed=4)
    monkeypatch.setattr(jbrownian, "VirtualBrownianTree",
                        jax_table_tree(table))
    A, b, S, y0 = _params()
    ts = np.linspace(0.0, 1.0, 5).astype(np.float32)
    max_steps = 64

    def jax_loss(args):
        A_, b_, S_, y_ = args
        f, g = _sde_fns(jnp, A_, b_, S_)
        ys = jsolve.sdeint_adaptive(f, g, y_, ts, key=jax.random.PRNGKey(0),
                                    max_steps=max_steps,
                                    differentiable=differentiable,
                                    **ADAPTIVE_KW)
        return jnp.mean(ys ** 2), ys

    jargs = tuple(jnp.asarray(a) for a in (A, b, S, y0))
    if differentiable:
        (_, ys_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(jargs)
    else:
        _, ys_j = jax_loss(jargs)
    targs = [torch.as_tensor(a).requires_grad_(differentiable)
             for a in (A, b, S, y0)]
    f, g = _sde_fns(torch, *targs[:3])
    ys_t = sdeint_adaptive(f, g, targs[3], ts,
                           tree=port_tree(table, 0.0, 1.0),
                           max_steps=max_steps, differentiable=differentiable,
                           **ADAPTIVE_KW)
    assert ys_t.shape == (5, B, H) and torch.isfinite(ys_t).all()
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=TOL_Y)
    if differentiable:
        (ys_t ** 2).mean().backward()
        for name, ours, ref in zip("AbSy", targs, g_j):
            ref = np.asarray(ref)
            err = float(np.abs(ours.grad.numpy() - ref).max())
            assert err <= TOL_G * float(np.abs(ref).max()), (name, err)


def test_sdeint_adaptive_budget_and_guard(monkeypatch):
    """A budget of 3 trial steps an interval cannot reach the first output
    at these tolerances: every later output is NaN, as in JAX, never a
    partial integration; with differentiable=False reverse mode raises
    the JAX package's remedy."""
    table = _table((B, H), seed=5)
    monkeypatch.setattr(jbrownian, "VirtualBrownianTree",
                        jax_table_tree(table))
    A, b, S, y0 = _params()
    ts = np.linspace(0.0, 1.0, 4).astype(np.float32)
    kw = dict(rtol=1e-4, atol=1e-5, vbt_depth=DEPTH, max_steps=3)
    ys_j = jsolve.sdeint_adaptive(*_sde_fns(jnp, A, b, S), jnp.asarray(y0),
                                  ts, key=jax.random.PRNGKey(0), **kw)
    ys_t = sdeint_adaptive(*_sde_fns(torch, *map(torch.as_tensor, (A, b, S))),
                           torch.as_tensor(y0), ts,
                           tree=port_tree(table, 0.0, 1.0), **kw)
    nan_j = np.isnan(np.asarray(ys_j)).all(axis=(1, 2))
    assert nan_j.tolist() == [False, True, True, True]
    np.testing.assert_array_equal(torch.isnan(ys_t).all(-1).all(-1).numpy(),
                                  nan_j)
    y = torch.as_tensor(y0).requires_grad_(True)
    ys = sdeint_adaptive(*_sde_fns(torch, *map(torch.as_tensor, (A, b, S))),
                         y, ts, seed=0, rtol=1e-2, atol=1e-3,
                         vbt_depth=DEPTH)
    assert torch.isfinite(ys).all()
    with pytest.raises(NotImplementedError, match="differentiable=True"):
        ys.sum().backward()
    with pytest.raises(ValueError, match="seed= or tree="):
        sdeint_adaptive(lambda t, y: y, lambda t, y: y, y0=torch.zeros(2),
                        ts=ts)


def _ode_fn(lib, A, b):
    """A gentle smooth field. The adaptive solvers' first steps are tiny
    (Hairer's initial step for dopri5), where the embedded error estimate
    is float32 rounding noise on both sides: the realised grids then part
    in the last digits, and an output between steps moves with its grid by
    the dense output's own error (the cubic Hermite of dopri5, 2-5e-4 from
    float64 on both sides with tanh(y A + b)(1 + 0.5 sin 3t), where the two
    sides differ by 8e-5). On this field that error lies far below the
    1e-5 tolerance."""
    tanh, sin = (jnp.tanh, jnp.sin) if lib is jnp else (torch.tanh,
                                                        torch.sin)
    return lambda t, y: (0.5 * tanh(y @ (0.3 * A) + b) * (1.0 + 0.2 * sin(t))
                         - 0.2 * y)


ODE_METHODS = ["dopri5", "rk23", "rk12", "ode23s", "sym12"]
ODE_TS = np.linspace(0.0, 1.0, 5).astype(np.float32)


def _odeint_both(method, differentiable, max_steps=48):
    A, b, _, y0 = _params(seed=6)
    kw = (dict(dt=0.05) if method in ("ode23s", "sym12") else
          dict(differentiable=differentiable, max_steps=max_steps))

    def jax_loss(args):
        ys = jsolve.odeint(_ode_fn(jnp, *args[:2]), args[2], ODE_TS,
                           method=method, **kw)
        return jnp.mean(ys ** 2), ys

    jargs = tuple(jnp.asarray(a) for a in (A, b, y0))
    targs = [torch.as_tensor(a).requires_grad_(True) for a in (A, b, y0)]
    ys_t = odeint(_ode_fn(torch, *targs[:2]), targs[2], ODE_TS,
                  method=method, **kw)
    return jax_loss, jargs, targs, ys_t


@pytest.mark.parametrize("method", ["dopri5", "rk23", "rk12"])
def test_odeint_matches_jax(method):
    """The adaptive methods' values with differentiable=False (JAX's
    while_loop), to 1e-5, every output reached."""
    jax_loss, jargs, _, ys_t = _odeint_both(method, False, 4096)
    _, ys_j = jax_loss(jargs)
    assert ys_t.shape == (5, B, H) and torch.isfinite(ys_t).all()
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=TOL_Y)


@pytest.mark.parametrize("method", ODE_METHODS)
def test_odeint_gradients_match_jax(method):
    """With differentiable=True (JAX's masked scan for the adaptive
    methods): the values to 1e-5 and the gradients of mean(ys^2) with
    respect to the weights and y0 to 1e-4 of their largest entry."""
    jax_loss, jargs, targs, ys_t = _odeint_both(method, True)
    (_, ys_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(jargs)
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=TOL_Y)
    (ys_t ** 2).mean().backward()
    for name, ours, ref in zip("Aby", targs, g_j):
        ref = np.asarray(ref)
        err = float(np.abs(ours.grad.numpy() - ref).max())
        assert err <= TOL_G * float(np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("method", ["dopri5", "rk23", "rk12"])
def test_adaptive_odeint_guard_and_budget(method):
    """differentiable=False gives the same values as True and refuses
    reverse mode with the remedy; a budget of 2 trial steps leaves every
    output after the first NaN, as JAX does."""
    _, _, targs, ys_f = _odeint_both(method, False)
    _, _, _, ys_t = _odeint_both(method, True)
    torch.testing.assert_close(ys_f, ys_t, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="differentiable=True"):
        ys_f.sum().backward()
    A, b, _, y0 = _params(seed=6)
    ys_j = jsolve.odeint(_ode_fn(jnp, A, b), jnp.asarray(y0), ODE_TS,
                         method=method, max_steps=2)
    with torch.no_grad():
        ys = odeint(_ode_fn(torch, *map(torch.as_tensor, (A, b))),
                    torch.as_tensor(y0), ODE_TS, method=method, max_steps=2)
    nan_j = np.isnan(np.asarray(ys_j)).all(axis=(1, 2))
    assert not nan_j[0] and nan_j[-1]
    np.testing.assert_array_equal(torch.isnan(ys).all(-1).all(-1).numpy(),
                                  nan_j)
    np.testing.assert_allclose(ys[~torch.as_tensor(nan_j)].numpy(),
                               np.asarray(ys_j)[~nan_j], atol=TOL_Y)


def test_unknown_ode_method_raises():
    with pytest.raises(ValueError, match="unknown ODE method"):
        odeint(lambda t, y: y, torch.zeros(2, 1), np.linspace(0, 1, 3),
               method="rk9")


def test_dopri5_accuracy():
    """dy/dt = -2y against exp(-2t) (tests/test_solve.py:141-147)."""
    ts = np.linspace(0, 2, 7)
    ys = odeint_dopri5(lambda t, y: -2.0 * y, torch.ones(1, 1), ts,
                       rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ys[:, 0, 0].numpy(), np.exp(-2 * ts),
                               rtol=1e-4, atol=1e-6)


def _cde_setting(seed=7):
    """A FinalTanh field carried from JAX and natural cubic coefficients of
    random series over linspace(0, 1, 6)."""
    Cn, L = 3, 6
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    coeffs = np.array(jinterp.natural_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(rng.normal(size=(B, L, Cn)),
                                        jnp.float32), pack=True))
    jf = jcde.FinalTanh.create(jax.random.PRNGKey(seed), Cn, H, 5, 2)
    tf = tcde.FinalTanh(Cn, H, 5, 2)
    load_jax_arrays(tf, jax_arrays(jf))
    z0 = rng.normal(size=(B, H)).astype(np.float32)
    return times, coeffs, jf, tf, z0


def test_cdeint_dopri5_differentiable_matches_jax():
    """cdeint(method="dopri5", differentiable=True) in float64 on both
    sides: the trajectory to 1e-5 and the field's and z0's gradients to
    1e-4 of their largest entry. In float32 the first steps' error
    estimates are rounding noise on both sides (Hairer's initial step is
    tiny), so the two realised grids part, and each side's dense output
    lies 3e-5-2e-4 from a float64 solve on this control; in float64 the
    step control sees the true errors and the grids meet."""
    from snsde.nn.core import filter_value_and_grad

    times, coeffs, jf, tf, z0 = _cde_setting()
    with jax.enable_x64(True):
        jf64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      jf)
        jpath = jinterp.CubicPath(jnp.asarray(coeffs, jnp.float64), times)

        def jax_loss(tree):
            fld, zz = tree
            zs = jsolve.cdeint(jpath, fld, zz, times, method="dopri5",
                               differentiable=True, max_steps=40)
            return jnp.mean(zs ** 2), zs

        (_, zs_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
            (jf64, jnp.asarray(z0, jnp.float64)))
        zs_j, g_j = np.asarray(zs_j), jax.tree_util.tree_map(np.asarray, g_j)
    tf = tf.double()
    z0_t = torch.as_tensor(z0, dtype=torch.float64).requires_grad_(True)
    zs_t = cdeint(CubicPath(torch.as_tensor(coeffs, dtype=torch.float64),
                            times), tf, z0_t, times, method="dopri5",
                  differentiable=True, max_steps=40)
    assert zs_t.dtype == torch.float64 and torch.isfinite(zs_t).all()
    np.testing.assert_allclose(zs_t.detach().numpy(), zs_j, atol=TOL_Y)
    (zs_t ** 2).mean().backward()
    ours = grads_to_jax_layout(tf)
    ours["z0"] = z0_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["z0"] = g_j[1]
    for name, ref in theirs.items():
        err = float(np.abs(ours[name] - ref).max())
        assert err <= TOL_G * float(np.abs(ref).max()), (name, err)


def test_neural_cde_with_dopri5_refuses_training():
    """The model's dispatch passes cdeint's default differentiable=False,
    as the JAX package's does: the forward runs, the backward raises."""
    times, coeffs, _, tf, _ = _cde_setting()
    model = tcde.NeuralCDEStream(tf, 3, H, 2, method="dopri5")
    out, z = model(times, torch.as_tensor(coeffs))
    assert torch.isfinite(z).all()
    with pytest.raises(NotImplementedError, match="odeint_dopri5"):
        out.sum().backward()
