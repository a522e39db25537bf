"""The port's tutorial path against the JAX package, on the CPU: lipswish
and the tutorial MLP, the four tutorial fields, `NDEModel`, the OU data
and `snsde_torch.tutorial`.

Weights carry across through snsde_torch.convert. The fields' f and g are
held to the bar the JAX package set against the reference
(tests/test_reference_parity.py): 2e-6 absolute and 1e-5 relative.
`NDEModel` runs both sides on one injected BrownianGrid (the Lévy area
too, for srk): outputs to 1e-4, every gradient to 1e-4 of its scale
(tests/torch_zoo.py's rule). `generate_ou_paths` takes JAX's own
`jax.random.normal(key, shape)` through its `eps=` seam, to 1e-6.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde import fields as jfields
from snsde.data.ou import generate_ou_paths as jax_ou
from snsde.models.neuralsde import NDEModel as JaxNDEModel
from snsde.nn import layers as jlayers
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite

from snsde_torch import fields as tfields
from snsde_torch import tutorial
from snsde_torch.data.ou import generate_ou_paths, ou_dataset
from snsde_torch.models import NDEModel
from snsde_torch.nn import ACTIVATIONS, MLP, lipswish
from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                             make_grid)

from torch_zoo import assert_grads_match, carry, jax_value_and_grads

B, L, C, H = 4, 8, 2, 16
FIELD_NAMES = ("NeuralSDEFunc", "NeuralLSDEFunc", "NeuralLNSDEFunc",
               "NeuralGSDEFunc")
ATOL, RTOL = 2e-6, 1e-5


def _control(seed=0):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    coeffs = np.asarray(jax_hermite(jnp.asarray(times), jnp.asarray(x)))
    return times, coeffs


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_activations_match_jax(act):
    x = np.linspace(-6, 6, 97).astype(np.float32)
    ours = ACTIVATIONS[act](torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(
        jlayers._ACTIVATIONS[act](jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    if act == "lipswish":
        np.testing.assert_allclose(lipswish(torch.as_tensor(x)).numpy(),
                                   np.asarray(jlayers.lipswish(x)),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("layers,act,final_tanh", [
    (1, "lipswish", False), (3, "relu", True), (2, "gelu", False)])
def test_mlp_matches_jax(layers, act, final_tanh):
    jm = jlayers.MLP.create(jax.random.PRNGKey(layers), 5, 3, 7, layers,
                            act, final_tanh)
    tm = carry(jm, MLP(5, 3, 7, layers, act, final_tanh))
    assert len(tm.layers) == layers + 1
    x = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="unknown activation"):
        MLP(2, 2, 2, 1, "swish")


@pytest.mark.parametrize("name", FIELD_NAMES)
@pytest.mark.parametrize("t", [0.4, "rows"])
def test_tutorial_field_f_g_match_jax(name, t):
    """f and g of each tutorial field at a scalar t and at a per-row t
    (the port's `time_column` keeps each row's time, as JAX's
    `_time_column` does)."""
    times, coeffs = _control()
    jf = getattr(jfields, name).create(jax.random.PRNGKey(3), C, H, H, 2)
    tf = carry(jf, getattr(tfields, name)(C, H, H, 2))
    jb = jf.bind(JaxPath(jnp.asarray(coeffs), times))
    tf.bind(CubicPath(torch.as_tensor(coeffs), times))
    rng = np.random.default_rng(2)
    y = rng.normal(size=(B, H)).astype(np.float32)
    tt = (np.float32(0.4) if t == 0.4 else
          rng.uniform(0, 1, size=(B,)).astype(np.float32))
    for fn in ("f", "g"):
        if t == "rows" and fn == "f" and name != "NeuralSDEFunc":
            continue             # the control path takes one time
        want = np.asarray(getattr(jb, fn)(jnp.asarray(tt), jnp.asarray(y)))
        got = getattr(tf, fn)(torch.as_tensor(tt), torch.as_tensor(y))
        assert got.shape == (B, H)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   rtol=RTOL, err_msg=f"{name}.{fn}")


def test_time_column_shapes():
    y = torch.zeros(3, 5)
    assert tfields.time_column(0.5, y).shape == (3, 1)
    assert tfields.time_column(torch.arange(3.0), y).shape == (3, 1)
    assert tfields.time_column(torch.arange(3.0)[:, None], y).shape == (3, 1)


def test_theory_properties_of_the_port():
    """tests/test_train.py's theory checks on the port: LSDE diffusion is
    state-independent, LNSDE diffusion linear in y, GSDE drift and
    diffusion vanish at y = 0."""
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(times, x), times)
    y = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32))
    t = torch.tensor(0.4)
    gen = lambda: torch.Generator().manual_seed(0)
    with torch.no_grad():
        lsde = tfields.NeuralLSDEFunc(C, H, H, 1, generator=gen()).bind(path)
        assert float((lsde.g(t, y) - lsde.g(t, y.flip(-1))).abs().max()) \
            < 1e-6
        lnsde = tfields.NeuralLNSDEFunc(C, H, H, 1,
                                        generator=gen()).bind(path)
        np.testing.assert_allclose(lnsde.g(t, 2.0 * y).numpy(),
                                   2.0 * lnsde.g(t, y).numpy(), rtol=1e-5,
                                   atol=1e-6)
        gsde = tfields.NeuralGSDEFunc(C, H, H, 1, generator=gen()).bind(path)
        zero = torch.zeros_like(y)
        assert float(gsde.f(t, zero).abs().max()) < 1e-7
        assert float(gsde.g(t, zero).abs().max()) < 1e-7


@pytest.mark.parametrize("method", ["euler", "milstein", "heun", "srk"])
@pytest.mark.parametrize("field", ["NeuralLSDEFunc", "NeuralLNSDEFunc"])
def test_nde_model_matches_jax_on_one_brownian_grid(method, field):
    """NDEModel (dt 0.05) on one injected BrownianGrid: the decoded
    trajectory to 1e-4 and every parameter's gradient of its mean square
    to 1e-4 of its scale."""
    times, coeffs = _control(seed=4)
    jm = JaxNDEModel.create(jax.random.PRNGKey(5), C, H, 1, 2,
                            vector_field=getattr(jfields, field),
                            method=method)
    tm = carry(jm, NDEModel(C, H, 1, 2,
                            vector_field=getattr(tfields, field),
                            method=method))
    grid, _ = make_grid(times, 0.05)
    rng = np.random.default_rng(6)
    sd = np.sqrt(np.diff(grid))[:, None, None]
    dW = (rng.normal(size=(len(grid) - 1, B, H)) * sd).astype(np.float32)
    U = (0.5 * np.diff(grid)[:, None, None]
         * (dW + rng.normal(size=dW.shape) * sd / np.sqrt(3.0))
         ).astype(np.float32) if method == "srk" else None
    jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW),
                          U=None if U is None else jnp.asarray(U))

    def jloss(m):
        out = m(jnp.asarray(coeffs), times, key=jax.random.PRNGKey(0),
                bm=jbm)
        return jnp.mean(out ** 2), out

    out_j, g_j = jax_value_and_grads(jloss, jm)
    bm = BrownianGrid(grid, torch.as_tensor(dW),
                      None if U is None else torch.as_tensor(U))
    out = tm(torch.as_tensor(coeffs), times, bm=bm)
    (out ** 2).mean().backward()
    assert out.shape == (B, L, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-4, rtol=0)
    assert_grads_match(tm, g_j)


def test_nde_model_draws_from_its_generator():
    """Without a grid the solve's noise comes from the generator: the same
    seed gives the same output, another seed another."""
    times, coeffs = _control()
    m = NDEModel(C, H, 1, 1, vector_field=tfields.NeuralSDEFunc,
                 generator=torch.Generator().manual_seed(0))
    run = lambda s: m(torch.as_tensor(coeffs), times,
                      generator=torch.Generator().manual_seed(s))
    with torch.no_grad():
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))


def test_readme_quick_start_takes_the_ou_tensors():
    """The README's quick start as written: generate_ou_paths' data and
    times tensors straight into hermite_cubic_coeffs and NDEModel, a
    finite [16, 20, 1]; the times tensor gives what its numpy copy
    gives."""
    data, times = generate_ou_paths(
        64, generator=torch.Generator().manual_seed(0))
    assert isinstance(times, torch.Tensor) and times.device == data.device
    coeffs = hermite_cubic_coeffs(times, data)
    model = NDEModel(input_dim=2, hidden_dim=32, output_dim=1, num_layers=1,
                     vector_field=tfields.NeuralLSDEFunc,
                     generator=torch.Generator().manual_seed(1))
    run = lambda t: model(coeffs[:16], t,
                          generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        pred = run(times)
        assert pred.shape == (16, 20, 1) and bool(torch.isfinite(pred).all())
        assert torch.equal(pred, run(times.numpy()))


def test_ou_paths_match_jax_with_its_eps():
    key = jax.random.PRNGKey(7)
    n, N = 16, 20
    data_j, times_j = jax_ou(key, n, N=N)
    eps = np.asarray(jax.random.normal(key, (n, N - 1)))
    data, times = generate_ou_paths(n, N=N, eps=eps)
    np.testing.assert_allclose(data.numpy(), np.asarray(data_j), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(times.numpy(), np.asarray(times_j),
                               atol=1e-7)
    with pytest.raises(ValueError, match="generator= or eps="):
        generate_ou_paths(n)


def test_ou_moments_match_the_closed_form():
    """The Euler recursion x' = (1 - theta dt) x + sigma sqrt(dt) eps from
    x0: mean x0 a^k, variance sigma^2 dt (1 - a^2k) / (1 - a^2) with a =
    1 - theta dt, at every step, within 5 standard errors."""
    n, N, T, theta, sigma, x0 = 20000, 20, 10.0, 0.2, 0.1, 1.0
    data, _ = generate_ou_paths(n, T, N, theta, 0.0, sigma, x0,
                                generator=torch.Generator().manual_seed(3))
    X = data[..., 1].double().numpy()
    np.testing.assert_allclose(data[0, :, 0].numpy(),
                               np.linspace(0, T, N), atol=1e-5)
    dt = T / N
    a = 1.0 - theta * dt
    k = np.arange(N)
    mean = x0 * a ** k
    var = sigma ** 2 * dt * (1 - a ** (2 * k)) / (1 - a ** 2)
    se_mean = np.sqrt(var / n)
    assert np.all(np.abs(X.mean(0) - mean) <= 5 * se_mean + 1e-7)
    se_var = var * np.sqrt(2.0 / (n - 1))
    assert np.all(np.abs(X.var(0, ddof=1) - var) <= 5 * se_var + 1e-9)


def test_ou_dataset_splits_and_coefficients():
    out = ou_dataset(50, generator=torch.Generator().manual_seed(0))
    assert out["train_data"].shape == (40, 20, 2)
    assert out["test_coeffs"].shape == (10, 19, 8)
    both = np.concatenate([out["train_data"], out["test_data"]])
    assert len(np.unique(both[:, -1, 1])) == 50       # a permutation
    coeffs = hermite_cubic_coeffs(out["times"],
                                  torch.as_tensor(out["train_data"]))
    np.testing.assert_allclose(coeffs.numpy(), out["train_coeffs"],
                               atol=1e-6)


@pytest.mark.parametrize("kind", tutorial.KINDS)
def test_tutorial_trains_each_kind(kind):
    """Three epochs at n=64 on the CPU: finite losses, and the kind's
    theory check holds."""
    res = tutorial.train(kind, epochs=3, n=64, hidden=8, verbose=False,
                         device="cpu")
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["check"]["ok"], res["check"]
    assert np.isfinite(res["check"]["value"])


def test_tutorial_ode_keeps_its_diffusion_zero():
    """The `ode` kind zeroes the diffusion net's output layer inside the
    forward: that layer gets no gradient and stays as drawn."""
    res = tutorial.train("ode", epochs=2, n=32, hidden=4, verbose=False,
                         device="cpu")
    last = res["model"].func.g_net.layers[-1]
    assert last.weight.grad is None and last.bias.grad is None
    host = torch.Generator().manual_seed(42)     # train's draws, in order
    tutorial.make_data(32, generator=host, device="cpu")
    fresh = tutorial.build_model("ode", hidden=4, generator=host)
    drawn = fresh.func.g_net.layers[-1]
    assert torch.equal(last.weight, drawn.weight)
    assert torch.equal(last.bias, drawn.bias)
    assert not torch.equal(res["model"].initial.weight, fresh.initial.weight)


def test_tutorial_entry_point_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tutorial.main(["--model", "lnsde", "--epochs", "1", "--n", "8"])
