"""The port's other SDE solvers against the JAX package, on the CPU:
milstein, heun and reversible_heun in `sdeint`, `SOLVER_ORDERS`,
`sdeint(return_brownian=True)` and the member-by-member `packed_solve`.

The parity tests feed both sides one numpy-drawn BrownianGrid and the same
DiffusionField weights (through snsde_torch.convert), on configurations
whose noise mixes channels (net1: (3,15), net2: (1,18)) and on the
flagship's (4,17): trajectories to 1e-4 absolute and every parameter's and
y0's gradient to 1e-4 of its largest entry (the JAX package's own bar
for its solvers; the two sides differ in float32 summation order).
Milstein's correction is the full Jacobian-vector product (dg/dy) g,
which the net1 and net2 configurations would catch if it were taken as a
diagonal. The statistical tests draw from the port's own generator.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.fields import DiffusionField as JaxField
from snsde.nn.core import filter_value_and_grad
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.ops.solve import SOLVER_ORDERS as JAX_ORDERS
from snsde.ops.solve import sdeint as jax_sdeint

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.models.ensemble import packed_solve
from snsde_torch.models.neuralsde import resolve_dt, solve_dispatch
from snsde_torch.ops import (SOLVER_ORDERS, BrownianGrid, CubicPath,
                             hermite_cubic_coeffs, make_grid, sdeint)
from snsde_torch.ops import solve as tsolve

from test_torch_fused_em import jax_arrays

B, L, C, H = 6, 6, 3, 5
METHODS = ["milstein", "heun", "reversible_heun"]
# the flagship (4,17), net1 with the state (3,15), net2 (1,18)
CONFIGS = [(4, 17), (3, 15), (1, 18)]
TOL = 1e-4


@pytest.fixture(scope="module")
def setting():
    rng = np.random.default_rng(11)
    times = (np.arange(L) * 0.4).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    y0 = rng.normal(size=(B, H)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times) / 2)
    dW = (rng.normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    return times, x, y0, grid, dW


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("io,no", CONFIGS)
def test_sde_methods_match_jax(setting, method, io, no):
    """The eager solve on one injected BrownianGrid: the trajectory to 1e-4
    and the gradient of mean(ys^2) with respect to y0 and every parameter
    to 1e-4 of its largest entry."""
    times, x, y0, grid, dW = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW), U=None)

    def jax_loss(tree):
        fld, yy = tree
        fb = fld.bind(jpath)
        ys = jax_sdeint(fb.f, fb.g, yy, times, bm=jbm, method=method)
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    field.bind(CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                              torch.as_tensor(x)), times))
    y0_t = torch.as_tensor(y0).requires_grad_(True)
    ys_t = sdeint(field.f, field.g, y0_t, times, method=method,
                  bm=BrownianGrid(grid, torch.as_tensor(dW)))
    (ys_t ** 2).mean().backward()

    assert ys_t.shape == (L, B, H)
    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=TOL)
    ours = grads_to_jax_layout(field)
    ours["y0"] = y0_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["y0"] = np.asarray(g_j[1])
    assert set(theirs) <= set(ours)
    for name, ref in theirs.items():
        denom = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(ours[name] - ref).max()) / denom
        assert err < TOL, f"{method} ({io},{no}) grad {name}: {err:.2e}"


def test_solver_orders_and_unknown_method():
    assert SOLVER_ORDERS == JAX_ORDERS
    with pytest.raises(ValueError, match="unknown SDE method"):
        sdeint(lambda t, y: y, lambda t, y: y, torch.zeros(2, 1),
               np.linspace(0, 1, 3), generator=torch.Generator(),
               method="rk9")


@pytest.mark.parametrize("method", ["euler", "milstein", "srk", "heun",
                                    "reversible_heun"])
def test_return_brownian_replays_the_solve(method):
    """`return_brownian=True` gives the grid and increments the solve
    stepped on (the Lévy area for srk only): a solve on them is the same
    solve, bit for bit."""
    f = lambda t, y: -y
    g = lambda t, y: 0.3 * torch.tanh(y) + 0.1
    y0 = torch.linspace(-1.0, 1.0, 8).reshape(4, 2)
    ts = np.linspace(0.0, 1.0, 4)
    ys, bm = sdeint(f, g, y0, ts, generator=torch.Generator().manual_seed(3),
                    dt=0.1, method=method, return_brownian=True)
    assert bm.dW.shape == (len(bm.grid) - 1, 4, 2)
    assert (bm.U is not None) == (method == "srk")
    torch.testing.assert_close(sdeint(f, g, y0, ts, bm=bm, method=method), ys,
                               rtol=0, atol=0)


@pytest.mark.parametrize("method", METHODS)
def test_ou_moments(method):
    """The port's own sampler: OU mean and variance at t=1 against the
    closed form, within ~2.5 sigma of the Monte-Carlo estimator at B=4096
    (the bars of tests/test_solve.py:63-74; additive noise, so the
    Stratonovich schemes solve the same SDE)."""
    theta, mu, sigma, x0 = 1.2, 0.3, 0.4, 1.0
    ys = sdeint(lambda t, y: theta * (mu - y),
                lambda t, y: torch.full_like(y, sigma),
                torch.full((4096, 1), x0), np.linspace(0.0, 1.0, 11),
                generator=torch.Generator().manual_seed(1), dt=0.02,
                method=method)
    mean_an = mu + (x0 - mu) * np.exp(-theta)
    var_an = sigma ** 2 / (2 * theta) * (1 - np.exp(-2 * theta))
    assert abs(float(ys[-1].mean()) - mean_an) < 8e-3
    assert abs(float(ys[-1].var()) - var_an) / var_an < 0.08


def test_milstein_strong_order():
    """Geometric Brownian motion dX = a X dt + b X dW against its exact
    solution on each run's own path (tests/test_solve.py:77-99): the
    least-squares order of the mean pathwise error over 32-256 steps is
    above 0.9."""
    a, b, n = 0.8, 0.6, 2048
    steps = [32, 64, 128, 256]
    errs = []
    for m in steps:
        grid = np.linspace(0.0, 1.0, m + 1)
        gen = torch.Generator().manual_seed(42)
        dW = torch.randn((m, n, 1), generator=gen) * np.sqrt(1.0 / m)
        exact = torch.exp((a - 0.5 * b * b) + b * dW.sum(0))
        ys = sdeint(lambda t, y: a * y, lambda t, y: b * y,
                    torch.ones(n, 1), grid, method="milstein",
                    bm=BrownianGrid(grid, dW))
        errs.append(float((ys[-1] - exact).abs().mean()))
    order = -np.polyfit(np.log(steps), np.log(errs), 1)[0]
    assert order > 0.9, f"order {order:.2f}, errors {errs}"


def test_reversible_heun_runs_back_exactly():
    """Algebraic reversibility: from the last pair (y_M, ŷ_M) the steps run
    back to y0, in float64 to 1e-12."""
    torch.manual_seed(0)
    Wf, Wg = torch.randn(3, 3, dtype=torch.float64), torch.randn(
        3, 3, dtype=torch.float64)
    f = lambda t, y: torch.tanh(y @ Wf) - 0.1 * t * y
    g = lambda t, y: 0.2 * torch.sigmoid(y @ Wg)
    grid = np.linspace(0.0, 1.0, 41)
    gen = torch.Generator().manual_seed(5)
    dW = torch.randn((40, 4, 3), generator=gen,
                     dtype=torch.float64) * np.sqrt(0.025)
    y0 = torch.randn(4, 3, dtype=torch.float64)
    t_lo = torch.as_tensor(grid[:-1])
    dts = torch.as_tensor(np.diff(grid))
    ys, yh = tsolve._reversible_heun(f, g, y0, t_lo, dts, dW)
    y = ys[-1]
    for k in range(39, -1, -1):
        t1, h = t_lo[k] + dts[k], dts[k]
        f1, g1 = f(t1, yh), g(t1, yh)
        yh_prev = 2.0 * y - yh - f1 * h - g1 * dW[k]
        f0, g0 = f(t_lo[k], yh_prev), g(t_lo[k], yh_prev)
        y = y - 0.5 * (f0 + f1) * h - 0.5 * (g0 + g1) * dW[k]
        yh = yh_prev
        torch.testing.assert_close(y, ys[k], rtol=0, atol=1e-12)
    torch.testing.assert_close(yh, y0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["milstein", "heun"])
def test_packed_solve_member_equals_solo(method):
    """The packed solve with a method no kernel takes solves member by
    member, each on its own generator: member k is its solo solve, bit for
    bit (on the card too, where euler and srk take the member-axis
    kernels)."""
    rng = np.random.default_rng(2)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    path = CubicPath(hermite_cubic_coeffs(
        torch.as_tensor(times),
        torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))),
        times)
    fields = [DiffusionField(C, H, H, 2, input_option=io, noise_option=no,
                             generator=torch.Generator().manual_seed(k))
              for k, (io, no) in enumerate(CONFIGS)]
    y0s = torch.as_tensor(rng.normal(size=(3, B, H)).astype(np.float32))
    gens = lambda: [torch.Generator().manual_seed(10 + k) for k in range(3)]
    with torch.no_grad():
        packed = packed_solve(fields, path, times, y0s, gens(), method=method)
        solo = [solve_dispatch(f.bind(path), path, times, y0s[k],
                               generator=gen, dt=resolve_dt(times),
                               method=method)
                for k, (f, gen) in enumerate(zip(fields, gens()))]
    assert packed.shape == (3, L, B, H)
    for k in range(3):
        torch.testing.assert_close(packed[k], solo[k], rtol=0, atol=0)
