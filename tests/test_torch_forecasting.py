"""The MuJoCo forecasting slice, port against the JAX package, on the CPU.

Natural cubic splines (clean and NaN-aware), the forecasting data path,
the forecasting model's loss and every gradient through the eager solvers
on the same (dW, I10), three coupled-L2 Adam steps against optax, and the
harness end to end at a tiny width.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.data import common as jcommon
from snsde.data import mujoco as jmujoco
from snsde.data.synthetic import synthetic_mujoco as jax_synthetic_mujoco
from snsde.harness.forecasting import make_forecast_model as jax_make_model
from snsde.nn.core import combine, filter_value_and_grad, partition
from snsde.ops import interp as jinterp
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.train import loop as jloop

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import common as tcommon
from snsde_torch.data import mujoco as tmujoco
from snsde_torch.data.synthetic import synthetic_mujoco
from snsde_torch.harness.forecasting import (ForecastConfig,
                                             make_forecast_model, run_mujoco)
from snsde_torch.ops import BrownianGrid, make_grid, natural_cubic_coeffs
from snsde_torch.train import loop as tloop

B, L, C, H, T = 8, 6, 3, 5, 2
LR, WD = 1e-3, 1e-5


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


def _holes(kind, rng, Bn=4, Ln=9, Cn=4):
    x = rng.normal(size=(Bn, Ln, Cn)).astype(np.float32)
    if kind == "clean":
        return x
    if kind == "random":
        x[rng.random(x.shape) < 0.35] = np.nan
    elif kind == "ends":                 # missing first and last points
        x[:, :2, 0] = np.nan
        x[:, -3:, 1] = np.nan
        x[1, 0, 2] = x[2, -1, 3] = np.nan
    elif kind == "once":                 # a channel observed only once
        x[:, :, 1] = np.nan
        x[:, 4, 1] = 2.5
        x[0, :, 2] = np.nan
        x[0, 0, 2] = -1.0
    elif kind == "all_nan":              # an all-NaN channel: zeros
        x[:, :, 0] = np.nan
        x[2, :, 3] = np.nan
    return x


@pytest.mark.parametrize("kind", ["clean", "random", "ends", "once",
                                  "all_nan"])
@pytest.mark.parametrize("irregular", [False, True])
def test_natural_cubic_coeffs_match_jax(kind, irregular):
    """Packed coefficients to atol 1e-5 / rtol 1e-5 (the two sides run the
    same masked Thomas solve in f32, in the same order); the NaN-aware path
    gives zeros for an all-NaN series and a constant for a series observed
    once."""
    rng = np.random.default_rng(len(kind) + 10 * irregular)
    x = _holes(kind, rng)
    times = (np.cumsum(rng.uniform(0.5, 1.5, x.shape[1])) if irregular
             else np.arange(x.shape[1])).astype(np.float32)
    ours = natural_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(x),
                                pack=True).numpy()
    ref = np.asarray(jinterp.natural_cubic_coeffs(jnp.asarray(times),
                                                  jnp.asarray(x), pack=True))
    assert ours.shape == ref.shape == (x.shape[0], x.shape[1] - 1,
                                       4 * x.shape[2])
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    if kind == "all_nan":
        assert not ours[..., 0::x.shape[2]].any()
    if kind == "once":
        a, b = ours[..., 1], ours[..., x.shape[2] + 1]
        np.testing.assert_array_equal(a, 2.5)
        assert not b.any()


def test_forecasting_data_matches_jax(tmp_path):
    """synthetic_mujoco, inject_missingness and drop_timestep_rows (the
    seed-56789 torch randperm stream) are equal to the JAX package's, bit
    for bit, and so are get_data's synthetic windows and load_windows on a
    trajectory bank."""
    for a, b in zip(synthetic_mujoco(n=40, seed=3),
                    jax_synthetic_mujoco(n=40, seed=3)):
        np.testing.assert_array_equal(a, b)
    X, _ = synthetic_mujoco(n=30, length=20, seed=1)
    np.testing.assert_array_equal(tcommon.inject_missingness(X, 0.3),
                                  jcommon.inject_missingness(X, 0.3))
    np.testing.assert_array_equal(tmujoco.drop_timestep_rows(X, 0.5),
                                  jmujoco.drop_timestep_rows(X, 0.5))
    assert np.isnan(tmujoco.drop_timestep_rows(X, 0.5)).any()
    absent = str(tmp_path / "absent.npy")
    ours = tmujoco.get_data(None, 12, 4, 0.25, n_synthetic=24, seed=2)
    ref = jmujoco.get_data(absent, 12, 4, 0.25, n_synthetic=24, seed=2)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    bank = str(tmp_path / "bank.npy")
    np.save(bank, np.random.default_rng(0).normal(size=(3, 30, 14)))
    for a, b in zip(tmujoco.load_windows(bank, 12, 4),
                    jmujoco.load_windows(bank, 12, 4)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tmujoco.get_data(absent)


def test_iterate_batches_matches_jax():
    """The same shuffled order and wrap-around padding as the JAX package;
    the valid rows of an epoch cover every sample once."""
    arrays = {"x": np.arange(23)}
    ours = list(tloop.iterate_batches(arrays, 8,
                                      rng=np.random.default_rng(4)))
    ref = list(jloop.iterate_batches(arrays, 8,
                                     rng=np.random.default_rng(4)))
    assert [n for _, n in ours] == [n for _, n in ref] == [8, 8, 7]
    for (a, _), (b, _) in zip(ours, ref):
        np.testing.assert_array_equal(a["x"], b["x"])
    valid = np.concatenate([b["x"][:n] for b, n in ours])
    np.testing.assert_array_equal(np.sort(valid), np.arange(23))
    tiny = list(tloop.iterate_batches({"x": np.arange(3)}, 8))
    np.testing.assert_array_equal(tiny[0][0]["x"], [0, 1, 2, 0, 1, 2, 0, 1])


@pytest.fixture(scope="module")
def forecast_setup():
    rng = np.random.default_rng(0)
    times = np.arange(L, dtype=np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    coeffs = np.array(jinterp.natural_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(x), pack=True))
    y = rng.normal(size=(B, T, C)).astype(np.float32)
    grid, _ = make_grid(times, 1.0)
    dts = np.diff(grid)[:, None, None]
    noise = []
    for _ in range(3):
        dW = rng.normal(size=(len(grid) - 1, B, H)) * np.sqrt(dts)
        U = 0.5 * dts * (dW + rng.normal(size=dW.shape) * np.sqrt(dts / 3))
        noise.append((dW.astype(np.float32), U.astype(np.float32)))
    return dict(times=times, coeffs=coeffs, y=y, grid=grid, noise=noise)


def jax_loss_fn(d, method, noise):
    bm = JaxBrownianGrid(grid=jnp.asarray(d["grid"]),
                         dW=jnp.asarray(noise[0]), U=jnp.asarray(noise[1]))

    def loss(m):
        pred = m(d["times"], jnp.asarray(d["coeffs"]),
                 key=jax.random.PRNGKey(0), bm=bm, method=method)
        return (jnp.mean((pred - jnp.asarray(d["y"])) ** 2)
                + jloop.weight_regularization(m.func, 0.01))

    return loss


def port_loss_fn(d, method, noise):
    bm = BrownianGrid(d["grid"], torch.as_tensor(noise[0]),
                      torch.as_tensor(noise[1]))

    def loss(m, batch, generator):
        pred = m(d["times"], batch["coeffs"], bm=bm, method=method)
        return (torch.mean((pred - batch["y"]) ** 2)
                + tloop.weight_regularization(m.func, 0.01)), pred

    return loss


def port_model(jm):
    model, _ = make_forecast_model("neurallnsde", C, H, H, 2, C, T)
    load_jax_arrays(model, jax_arrays(jm))
    return model


def _jax_model():
    jm, _ = jax_make_model(jax.random.PRNGKey(3), "neurallnsde", C, H, H, 2,
                           C, T)
    return jm


@pytest.mark.parametrize("method", ["srk", "euler"])
def test_forecasting_loss_and_every_grad_match_jax(forecast_setup, method):
    """mse + 0.01 L2 on the field: the loss to 1e-5 relative and every
    gradient leaf to 1e-4 relative to its largest entry (the reference
    bar); both sides run the eager solver on the same (dW, I10) and differ
    in f32 summation order only."""
    d = forecast_setup
    jm = _jax_model()
    loss_j, g_j = filter_value_and_grad(jax_loss_fn(d, method,
                                                    d["noise"][0]))(jm)
    model = port_model(jm)
    batch = {"coeffs": torch.as_tensor(d["coeffs"]),
             "y": torch.as_tensor(d["y"])}
    loss_t, pred = port_loss_fn(d, method, d["noise"][0])(model, batch, None)
    assert pred.shape == (B, T, C)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (
            f"{method} grad {name}: abs err {err:.2e}")


def test_three_coupled_adam_steps_match_optax(forecast_setup):
    """add_decayed_weights(1e-5) + adam(1e-3) against torch Adam with
    weight_decay=1e-5, three srk steps on fresh (dW, I10) each: every
    parameter to atol 1e-6 (1e-3 of one Adam step)."""
    d = forecast_setup
    jm = _jax_model()
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    opt_state = tx.init(partition(jm)[0])
    m = jm
    for noise in d["noise"]:
        _, grads = filter_value_and_grad(jax_loss_fn(d, "srk", noise))(m)
        params, rest = partition(m)
        updates, opt_state = tx.update(grads, opt_state, params)
        m = combine(optax.apply_updates(params, updates), rest)

    model = port_model(jm)
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=WD)
    batch = {"coeffs": torch.as_tensor(d["coeffs"]),
             "y": torch.as_tensor(d["y"])}
    for noise in d["noise"]:
        tloop.train_step(model, opt, port_loss_fn(d, "srk", noise), batch,
                         None)
    expected = port_model(m).state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_run_mujoco_on_cpu_trains_and_restores():
    """The harness end to end at a tiny width with srk on the CPU: finite
    MSEs on all three splits each epoch; the returned model is the best-val
    epoch's (a rerun stopped after that epoch, same seeds, gives the same
    parameters)."""
    cfg = ForecastConfig(hidden_channels=5, hidden_hidden_channels=5,
                         num_hidden_layers=2, lr=1e-2, batch_size=16,
                         time_seq=8, y_seq=3, time_augment=False,
                         method="srk", verbose=False)
    res = run_mujoco(cfg, n=60, max_epochs=3, device="cpu")
    assert len(res["history"]) == 3 and res["steps"] == 3 * 3
    for h in res["history"]:
        assert all(np.isfinite(h[k]) for k in ("train", "val", "test"))
    assert np.isfinite(res["test_mse"])
    vals = [h["val"] for h in res["history"]]
    best = int(np.argmin(vals))
    assert res["best_val_mse"] == vals[best]
    again = run_mujoco(cfg, n=60, max_epochs=best + 1, device="cpu")
    for (k, v), w in zip(res["model"].state_dict().items(),
                         again["model"].state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
