"""The port's NeuralSDEStream, its SDE registry names and the robustness
sweep over them, against the JAX package.

Both sides get the same weights (through snsde_torch.convert), the same
Hermite control path and the same numpy-drawn Brownian increments (and, for
srk, Lévy areas): an injected BrownianGrid on both sides, which takes the
eager solvers (the fused kernels draw their own paths; their modes are held
to the JAX kernels by tests/test_torch_fused_modes.py).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import snsde.ops.solve as jax_solve
from snsde.fields import DiffusionField as JaxField
from snsde.models.neuralsde import NeuralSDEStream as JaxStream
from snsde.nn.core import filter_value_and_grad
from snsde.ops.brownian import BrownianGrid as JaxGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.registry import make_seq_layer as jax_make_seq_layer

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.fields import DiffusionField
from snsde_torch.harness import robustness as trob
from snsde_torch.models import NeuralSDEStream, resolve_dt
from snsde_torch.ops import BrownianGrid, hermite_cubic_coeffs, make_grid
from snsde_torch.registry import MODEL_NAMES, PORTED_NAMES, make_seq_layer

from test_torch_fused_em import jax_arrays

B, L, C, H = 8, 6, 3, 5


@pytest.fixture(scope="module")
def setting():
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dts = np.diff(grid)[:, None, None]
    dW = rng.normal(size=(len(grid) - 1, B, H)) * np.sqrt(dts)
    I10 = 0.5 * dts * (dW + rng.normal(size=dW.shape) * np.sqrt(dts / 3.0))
    return times, x, grid, dW.astype(np.float32), I10.astype(np.float32)


def _grids(grid, dW, I10):
    """The same draws as a JAX and a port BrownianGrid."""
    return (JaxGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW),
                    U=None if I10 is None else jnp.asarray(I10)),
            BrownianGrid(grid, torch.as_tensor(dW),
                         None if I10 is None else torch.as_tensor(I10)))


def _compare_grads(ours, theirs, label, tol=5e-4):
    """Every gradient within tol of its largest finite entry; a NaN (the
    eager sqrt noise's gradient at a negative state, on both sides) only
    where the other side has one too."""
    assert set(theirs) <= set(ours)
    for name, ref in theirs.items():
        nan = np.isnan(ref)
        assert np.array_equal(nan, np.isnan(ours[name])), f"{label} {name}"
        ref, got = ref[~nan], ours[name][~nan]
        if not ref.size:
            continue
        denom = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(got - ref).max()) / denom
        assert err < tol, f"{label} grad {name}: rel err {err:.2e}"


@pytest.mark.parametrize("method", ["srk", "euler"])
@pytest.mark.parametrize("io,no", [(4, 17), (2, 16), (6, 17), (3, 18),
                                   (0, 7)])
def test_stream_matches_jax(setting, io, no, method):
    """NeuralSDEStream's (linear(z), z) and every parameter's gradient
    against the JAX stream model on the same weights, path and Brownian
    draws (srk, the registry's default, and euler): outputs to atol 2e-5,
    gradients to 5e-4 of their largest entry (the bar of the fused-kernel
    comparisons: float32 summation order)."""
    times, x, grid, dW, I10 = setting
    jg, tg = _grids(grid, dW, I10 if method == "srk" else None)
    k1, k2 = jax.random.split(jax.random.PRNGKey(io * 20 + no))
    jfield = JaxField.create(k1, C, H, H, 2, input_option=io,
                             noise_option=no)
    jm = JaxStream.create(k2, jfield, C, H, H, method=method)
    jco = jax_hermite(jnp.asarray(times), jnp.asarray(x))

    def jax_loss(m):
        out, z = m(times, jco, key=jax.random.PRNGKey(0), bm=jg)
        return jnp.mean(out ** 2) + jnp.mean(z ** 2), (out, z)

    (_, (out_j, z_j)), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        jm)

    model = NeuralSDEStream(DiffusionField(C, H, H, 2, input_option=io,
                                           noise_option=no),
                            C, H, H, method=method)
    load_jax_arrays(model, jax_arrays(jm))
    co = hermite_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(x))
    out, z = model(times, co, bm=tg)
    ((out ** 2).mean() + (z ** 2).mean()).backward()
    assert out.shape == (B, L, H) and z.shape == (B, L, H)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=2e-5)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j),
                               atol=2e-5)
    _compare_grads(grads_to_jax_layout(model), jax_arrays(g_j),
                   f"{method} ({io},{no})")


def test_stream_without_initial_network_starts_at_zero(setting):
    """initial=False starts the solve at zeros (the JAX stream's rule)."""
    times, x, grid, dW, _ = setting
    model = NeuralSDEStream(DiffusionField(C, H, H, 1, input_option=1,
                                           noise_option=0),
                            C, H, H, initial=False, method="euler")
    co = hermite_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(x))
    with torch.no_grad():
        _, z = model(times, co, bm=_grids(grid, dW, None)[1])
    assert torch.equal(z[:, 0], torch.zeros(B, H))


def _seq_and_coeffs(D=2, Ln=L, n=6):
    X, _, _ = synthetic_uea(n=n, length=Ln, channels=D, num_classes=2,
                            seed=0)
    data = trob.preprocess_ists(X, 0.3, interpolation="hermite", seed=0)
    return (torch.as_tensor(data["seq"]), torch.as_tensor(data["coeffs"]),
            data)


def test_every_sde_name_builds_and_runs():
    """All 143 SDE names of the registry (the 140 `neuralsde_{i}_{jj}` and
    `neuralsde-x/y/z`) are ported, build, and give finite (out, hidden)
    streams [N, L, hidden] on the CPU from a generator."""
    names = [n for n in MODEL_NAMES if n.startswith("neuralsde")]
    assert len(names) == 143 and set(names) <= set(PORTED_NAMES)
    seq, co, _ = _seq_and_coeffs()
    for name in names:
        layer = make_seq_layer(name, 2, L, 4,
                               generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out, hn = layer(seq, co,
                            generator=torch.Generator().manual_seed(1))
        assert out.shape == hn.shape == (seq.shape[0], L, 4), name
        assert torch.isfinite(out).all() and torch.isfinite(hn).all(), name
        if name.startswith("neuralsde_"):
            io, no = map(int, name.split("_")[1:])
            f = layer.inner.func
            assert (f.input_option, f.noise_option) == (io, no), name
            assert layer.inner.method == "srk", name


def test_sde_names_refuse_to_run_without_a_generator():
    """An SDE name draws its Brownian path from the caller's generator,
    and raises without one (no hidden default draw)."""
    seq, co, _ = _seq_and_coeffs()
    layer = make_seq_layer("neuralsde_4_17", 2, L, 4)
    with pytest.raises(ValueError, match="generator"):
        layer(seq, co)


@pytest.mark.parametrize("name", ["neuralsde-x", "neuralsde-y",
                                  "neuralsde-z"])
def test_scalar_noise_sdes_match_jax(monkeypatch, name):
    """neuralsde-x/y/z's streams and gradients against the JAX registry's
    `_ScalarNoiseSDE` on shared Brownian increments (the JAX sdeint
    wrapped here to take them; the port's takes them as `bm`): outputs to
    atol 2e-5, gradients to 5e-4 of their largest entry."""
    seq, co, _ = _seq_and_coeffs()
    Ln, N, HID = seq.shape[2], seq.shape[0], 4
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    rng = np.random.default_rng(5)
    dW = (rng.normal(size=(len(grid) - 1, N, HID))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    jg, tg = _grids(grid, dW, None)
    real = jax_solve.sdeint
    monkeypatch.setattr(jax_solve, "sdeint",
                        lambda *a, **k: real(*a, **{**k, "bm": jg}))
    jl = jax_make_seq_layer(jax.random.PRNGKey(3), name, 2, Ln, HID)

    def jax_loss(inner):
        out, hn = inner(jnp.asarray(co.numpy()), times,
                        key=jax.random.PRNGKey(0))
        return jnp.mean(out ** 2) + jnp.mean(hn ** 2), (out, hn)

    (_, (out_j, hn_j)), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        jl.inner)
    layer = make_seq_layer(name, 2, Ln, HID)
    load_jax_arrays(layer.inner, jax_arrays(jl.inner))
    out, hn = layer.inner(co, times, bm=tg)
    ((out ** 2).mean() + (hn ** 2).mean()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=2e-5)
    np.testing.assert_allclose(hn.detach().numpy(), np.asarray(hn_j),
                               atol=2e-5)
    _compare_grads(grads_to_jax_layout(layer.inner), jax_arrays(g_j), name)


def test_robustness_sweep_trains_an_sde_name(tmp_path):
    """The sweep's default first model, neuralsde_4_17, trains through
    ISTSClassifier on the CPU and writes a record with an accuracy and no
    error (its Brownian paths from generators seeded from the run)."""
    cfg = trob.SweepConfig(models=("neuralsde_4_17",), missing_rates=(0.3,),
                           seeds=(0,), hidden_dim=6, batch_size=16,
                           max_epochs=1, out_dir=str(tmp_path),
                           save_preds=True)
    recs = trob.run_robustness_sweep(
        cfg, n=32, data_fn=lambda n: synthetic_uea(
            n=n, length=8, channels=2, num_classes=2, seed=0),
        verbose=False, device="cpu")
    assert len(recs) == 1 and "error" not in recs[0], recs
    assert 0.0 <= recs[0]["accuracy"] <= 1.0
    assert recs[0]["method"] == "srk"
    assert (tmp_path / "synthetic_uea" / "30" / "neuralsde_4_17_0.npz"
            ).exists()


def test_sweep_seeds_draw_different_training_paths(monkeypatch):
    """train_ists_model seeds its noise generator from the run's seed, so
    two seeds draw different Brownian paths (the JAX package derives its
    key from the run) and one seed draws the same path twice."""
    seen = []
    real = trob.ists_train_step

    def spy(model, optimizer, batch, use_fused=True, generator=None, **kw):
        seen.append(torch.randn(3, generator=_copy_gen(generator)))
        return real(model, optimizer, batch, use_fused, generator, **kw)

    monkeypatch.setattr(trob, "ists_train_step", spy)
    X, y, _ = synthetic_uea(n=24, length=6, channels=2, num_classes=2,
                            seed=0)
    data = trob.preprocess_ists(X, 0.0, interpolation="hermite", seed=0)
    firsts = []
    for seed in (0, 1, 0):
        seen.clear()
        model = trob.ISTSClassifier("neuralsde_4_17", 2, 6, 4, 2,
                                    generator=torch.Generator().manual_seed(0))
        trob.train_ists_model(model, data, y, trob.make_fixed_splits(
            y, seeds=(0,))[0], batch_size=8, max_epochs=1, seed=seed)
        firsts.append(seen[0])
    assert not torch.equal(firsts[0], firsts[1])
    assert torch.equal(firsts[0], firsts[2])


def _copy_gen(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g
