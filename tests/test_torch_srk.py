"""The port's eager SRIW1 solver (`sdeint(method="srk")`) and its Lévy-area
sampler, on the CPU.

The solver is held to the goldens of an independent float64 torch
transcription of the tableau (tests/goldens/reference_srk.npz) at the bar
tests/test_reference_parity.py holds the JAX package to, and to the JAX
`sdeint(method="srk")` for DiffusionFields on the same weights and the
same (dW, I10), drawn with numpy. The sampler cannot reproduce JAX's bits,
so it is checked by its moments.
"""

import pathlib

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
from snsde.ops.solve import sdeint as jax_sdeint

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import (BrownianGrid, CubicPath, brownian_increments,
                             hermite_cubic_coeffs, make_grid, sdeint,
                             space_time_levy_area)

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"
B, L, C, H = 8, 6, 3, 5


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (the key format of
    snsde_torch.convert)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def numpy_noise(rng, grid, shape):
    """(dW, I10) over a host grid, drawn with numpy by the Lévy-area
    formula U = dt/2 (dW + dZ sqrt(dt)/sqrt(3))."""
    dts = np.diff(grid).reshape((-1,) + (1,) * len(shape))
    dW = rng.normal(size=(len(grid) - 1,) + shape) * np.sqrt(dts)
    dZ = rng.normal(size=dW.shape) * np.sqrt(dts)
    I10 = 0.5 * dts * (dW + dZ / np.sqrt(3.0))
    return dW.astype(np.float32), I10.astype(np.float32)


def test_srk_matches_reference_goldens_float64():
    """f = a y + b sin(t + y), g = c y + d cos(y) on the goldens' (dW, I10):
    trajectory and loss to rtol 1e-10, the four gradients to rtol 1e-8
    (the bar of tests/test_reference_parity.py)."""
    z = np.load(GOLDENS / "reference_srk.npz")
    params = torch.tensor(z["params"], dtype=torch.float64,
                          requires_grad=True)
    bm = BrownianGrid(z["grid"], torch.as_tensor(z["dW"]),
                      torch.as_tensor(z["I10"]))

    def f(t, y):
        return params[0] * y + params[1] * torch.sin(t + y)

    def g(t, y):
        return params[2] * y + params[3] * torch.cos(y)

    ys = sdeint(f, g, torch.as_tensor(z["y0"]), z["grid"], bm=bm,
                method="srk")
    np.testing.assert_allclose(ys.detach().numpy(), z["traj"], rtol=1e-10,
                               atol=1e-10)
    loss = (ys[-1] ** 2).sum()
    np.testing.assert_allclose(loss.item(), float(z["loss"]), rtol=1e-10)
    loss.backward()
    np.testing.assert_allclose(params.grad.numpy(), z["grads"], rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("io,no", [(4, 17), (2, 16), (6, 17)])
def test_srk_matches_jax_sdeint(io, no):
    """A DiffusionField through both eager SRK solvers on the same weights
    and (dW, I10): trajectory to atol 2e-5 and every parameter gradient
    (and y0's) to 1e-4 relative to its largest entry. The two sides run
    the same tableau and differ in f32 summation order only (measured:
    trajectory 3.0e-7, gradients 1.6e-5 relative at most)."""
    rng = np.random.default_rng(io * 20 + no)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    y0 = rng.normal(size=(B, H)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dW, I10 = numpy_noise(rng, grid, (B, H))

    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW),
                          U=jnp.asarray(I10))

    def jax_loss(tree):
        fld, yy = tree
        fb = fld.bind(jpath)
        ys = jax_sdeint(fb.f, fb.g, yy, times, bm=jbm, method="srk")
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    field.bind(path)
    y0_t = torch.as_tensor(y0).requires_grad_(True)
    ys_t = sdeint(field.f, field.g, y0_t, times, method="srk",
                  bm=BrownianGrid(grid, torch.as_tensor(dW),
                                  torch.as_tensor(I10)))
    (ys_t ** 2).mean().backward()

    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=2e-5)
    ours = grads_to_jax_layout(field)
    ours["y0"] = y0_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["y0"] = np.asarray(g_j[1])
    assert set(theirs) <= set(ours)
    for name, ref in theirs.items():
        denom = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(ours[name] - ref).max()) / denom
        assert err < 1e-4, f"({io},{no}) grad {name}: rel err {err:.2e}"


def test_srk_needs_the_levy_area():
    grid = np.linspace(0.0, 1.0, 3)
    with pytest.raises(ValueError, match="Lévy area"):
        sdeint(lambda t, y: y, lambda t, y: y, torch.zeros(2, 1), grid,
               bm=BrownianGrid(grid, torch.zeros(2, 2, 1)), method="srk")


def test_levy_area_moments():
    """U = dt/2 (dW + dZ/sqrt(3)) over a grid of three step sizes, 2^18
    samples each: E[U] = 0 (within 4 sigma of the estimator), Var U =
    dt^3/3 and E[U dW] = dt^2/2 (within 2%, ~7 sigma)."""
    grid = np.array([0.0, 0.5, 1.5, 1.75])
    n = 1 << 18
    gen = torch.Generator().manual_seed(0)
    dW = brownian_increments(gen, grid, (n,), torch.float64)
    U = space_time_levy_area(gen, grid, (n,), dW)
    assert U.shape == dW.shape and U.dtype == torch.float64
    for k, dt in enumerate(np.diff(grid)):
        u, w = U[k].numpy(), dW[k].numpy()
        var = dt ** 3 / 3
        assert abs(u.mean()) < 4 * np.sqrt(var / n)
        assert abs(u.var() / var - 1) < 0.02
        assert abs((u * w).mean() / (dt ** 2 / 2) - 1) < 0.02
        assert abs(w.var() / dt - 1) < 0.02


def test_srk_draws_dw_then_levy_area_from_one_generator():
    """Without bm, the solver draws dW and then U from its generator: the
    same draws injected through bm give the same trajectory."""
    times = np.linspace(0.0, 1.0, 4)
    grid, _ = make_grid(times, 0.1)
    y0 = torch.ones(3, 2)
    f = lambda t, y: -y
    g = lambda t, y: 0.3 * y
    ys = sdeint(f, g, y0, times, dt=0.1, method="srk",
                generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    dW = brownian_increments(gen, grid, (3, 2))
    U = space_time_levy_area(gen, grid, (3, 2), dW)
    ref = sdeint(f, g, y0, times, method="srk", bm=BrownianGrid(grid, dW, U))
    torch.testing.assert_close(ys, ref, rtol=0, atol=0)


def test_srk_runs_the_drift_twice_and_the_diffusion_four_times_per_step():
    """The eager step evaluates f only where the tableau uses a new value
    (stages 0 and 1) and g at all four stages."""
    grid = np.linspace(0.0, 1.0, 6)
    calls = {"f": [], "g": []}

    def f(t, y):
        calls["f"].append(float(t))
        return -y

    def g(t, y):
        calls["g"].append(float(t))
        return 0.3 * y

    M = len(grid) - 1
    sdeint(f, g, torch.ones(2, 3), grid, method="srk",
           bm=BrownianGrid(grid, torch.zeros(M, 2, 3), torch.zeros(M, 2, 3)))
    assert len(calls["f"]) == 2 * M and len(calls["g"]) == 4 * M
    dt = grid[1] - grid[0]
    np.testing.assert_allclose(calls["f"][:2], [0.0, 0.75 * dt], atol=1e-6)
