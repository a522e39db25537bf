"""The port's building blocks against the JAX package, on the CPU.

Interpolation, grids, the drift/diffusion field, the eager solver, the
losses, metrics and schedule, the layers and the data pipeline: each is
fed the same numpy inputs on both sides, with the tolerance beside each
assert.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.data import common as jcommon
from snsde.data.synthetic import synthetic_sepsis as jax_synthetic_sepsis
from snsde.fields import DiffusionField as JaxField
from snsde.harness.classification import parse_model_name as jax_parse
from snsde.models.neuralsde import resolve_dt as jax_resolve_dt
from snsde.nn.layers import BatchNorm as JaxBatchNorm
from snsde.ops import interp as jinterp
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.solve import make_grid as jax_make_grid
from snsde.ops.solve import sdeint as jax_sdeint
from snsde.train import loop as jloop
from snsde.train import metrics as jmetrics
from snsde.train.schedule import ReduceLROnPlateau as JaxPlateau

from snsde_torch.convert import load_jax_arrays
from snsde_torch.data import common as tcommon
from snsde_torch.data.synthetic import synthetic_sepsis
from snsde_torch.fields import DiffusionField
from snsde_torch.harness.classification import parse_model_name
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.nn.layers import BatchNorm, Dropout
from snsde_torch.ops import interp as tinterp
from snsde_torch.ops.brownian import BrownianGrid
from snsde_torch.ops.solve import make_grid, sdeint
from snsde_torch.train import loop as tloop
from snsde_torch.train import metrics as tmetrics
from snsde_torch.train.schedule import ReduceLROnPlateau


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


def _nan_series(seed=0, B=4, L=9, C=5):
    """Irregular missingness: random holes, leading and trailing NaN runs,
    one all-NaN channel, one channel observed once."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, :3, 1] = np.nan                    # leading run
    x[:, -2:, 2] = np.nan                   # trailing run
    x[:, :, 3] = np.nan                     # all-NaN channel
    x[:, :, 4] = np.nan
    x[:, 4, 4] = 1.5                        # a single observation
    times = np.cumsum(rng.uniform(0.2, 1.0, L)).astype(np.float32)
    return times, x


def test_fill_and_hermite_coeffs_match_jax():
    """Same f32 formulas on both sides: atol 1e-5 on the packed
    coefficients (divisions by short knot gaps reach |c| ~ 1e2)."""
    times, x = _nan_series()
    ref = np.asarray(jinterp.hermite_cubic_coeffs(jnp.asarray(times),
                                                  jnp.asarray(x)))
    ours = tinterp.hermite_cubic_coeffs(torch.as_tensor(times),
                                        torch.as_tensor(x)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-6)
    fill_ref = np.asarray(jinterp.fill_missing_linear(jnp.asarray(times),
                                                      jnp.asarray(x)))
    fill = tinterp.fill_missing_linear(torch.as_tensor(times),
                                       torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(fill, fill_ref, atol=1e-6)
    assert (fill[:, :, 3] == 0).all() and (fill[:, :, 4] == 1.5).all()


def test_pack_unpack_roundtrip():
    times, x = _nan_series(1)
    parts = tinterp.hermite_cubic_coeffs(torch.as_tensor(times),
                                         torch.as_tensor(x), pack=False)
    packed = tinterp.pack_coeffs(*parts)
    for a, b in zip(tinterp.unpack_coeffs(packed), parts):
        assert torch.equal(a, b)


def test_cubic_path_evaluate_and_grid_match_jax():
    """Bucket rule searchsorted(side='left') - 1, clipped: knots, points
    before t0 and after the last knot; atol 1e-5 (f32 Horner)."""
    times, x = _nan_series(2)
    coeffs = np.array(jinterp.hermite_cubic_coeffs(jnp.asarray(times),
                                                   jnp.asarray(x)))
    jpath = jinterp.CubicPath(jnp.asarray(coeffs), times)
    path = tinterp.CubicPath(torch.as_tensor(coeffs), times)
    ts = np.concatenate([times, times[:-1] + 0.37 * np.diff(times),
                         [times[0] - 0.5, times[-1] + 0.7]]).astype(np.float32)
    for t in ts:
        np.testing.assert_allclose(
            path.evaluate(torch.tensor(t)).numpy(),
            np.asarray(jpath.evaluate(jnp.float32(t))), atol=1e-5, rtol=1e-6)
    grid = np.sort(ts).astype(np.float64)
    np.testing.assert_allclose(path.evaluate_grid(grid).numpy(),
                               np.asarray(jpath.evaluate_grid(grid)),
                               atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("mode", ["equal", "torchsde"])
@pytest.mark.parametrize("ts,dt", [
    (np.array([0.0, 0.3, 1.0]), 0.25),
    (np.arange(6) * 0.7, 0.7 / 3.0),
    (np.array([0.0, 0.1, 0.15, 2.0]), 0.05),
    (np.arange(72, dtype=np.float32), 1.0),
    (np.linspace(0.0, 1.0, 5), None),
])
def test_make_grid_matches_jax_exactly(ts, dt, mode):
    grid, idx = make_grid(ts, dt, mode=mode)
    jgrid, jidx = jax_make_grid(ts, dt, mode=mode)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(idx, jidx)


def test_resolve_dt_matches_jax():
    for ts in (np.arange(72, dtype=np.float32), np.array([0.0, 1e-5, 1.0]),
               np.linspace(0, 1, 11)):
        assert resolve_dt(ts) == jax_resolve_dt(ts)


FIELD_CASES = [(0, 2), (1, 18), (2, 16), (3, 7), (4, 17), (5, 14), (6, 17),
               (2, 5), (4, 12), (6, 19), (1, 3), (3, 11)]


@pytest.mark.parametrize("io,no", FIELD_CASES)
def test_diffusion_field_f_g_match_jax(io, no):
    """The eager field with JAX weights (through convert) on the same
    control path: f and g to atol 2e-6 / rtol 1e-5, the bar
    tests/test_reference_parity.py sets between JAX and the reference."""
    rng = np.random.default_rng(io * 20 + no)
    B, L, C, H = 6, 5, 3, 4
    times = np.linspace(0.0, 2.0, L).astype(np.float32)
    coeffs = np.array(jinterp.hermite_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(rng.normal(size=(B, L, C)),
                                        jnp.float32)))
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    jfield = jfield.bind(jinterp.CubicPath(jnp.asarray(coeffs), times))
    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield.replace(path=None)))
    field.bind(tinterp.CubicPath(torch.as_tensor(coeffs), times))
    y = rng.normal(size=(B, H)).astype(np.float32)
    with torch.no_grad():
        for t in (0.0, 0.61, 2.0):
            tt = torch.tensor(t, dtype=torch.float32)
            for name in ("f", "g"):
                ours = getattr(field, name)(tt, torch.as_tensor(y)).numpy()
                ref = np.asarray(getattr(jfield, name)(jnp.float32(t),
                                                       jnp.asarray(y)))
                np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=1e-5,
                                           err_msg=f"{name} t={t}")


def test_sdeint_with_injected_dw_matches_jax_scan():
    """Eager EM on both sides with the same dW: trajectory to atol 2e-5
    (f32 rounding differs per step)."""
    rng = np.random.default_rng(3)
    B, L, C, H = 6, 6, 3, 5
    times = (np.arange(L) * 0.7).astype(np.float32)
    coeffs = np.array(jinterp.hermite_cubic_coeffs(
        jnp.asarray(times), jnp.asarray(rng.normal(size=(B, L, C)),
                                        jnp.float32)))
    grid, _ = make_grid(times, resolve_dt(times) / 2)
    dW = (rng.normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    y0 = rng.normal(size=(B, H)).astype(np.float32)
    jfield = JaxField.create(jax.random.PRNGKey(2), C, H, H, 2,
                             input_option=4, noise_option=17)
    jb = jfield.bind(jinterp.CubicPath(jnp.asarray(coeffs), times))
    ref = jax_sdeint(jb.f, jb.g, jnp.asarray(y0), times,
                     bm=JaxBrownianGrid(grid=jnp.asarray(grid),
                                        dW=jnp.asarray(dW), U=None))
    field = DiffusionField(C, H, H, 2, input_option=4, noise_option=17)
    load_jax_arrays(field, jax_arrays(jfield))
    field.bind(tinterp.CubicPath(torch.as_tensor(coeffs), times))
    with torch.no_grad():
        ours = sdeint(field.f, field.g, torch.as_tensor(y0), times,
                      bm=BrownianGrid(grid, torch.as_tensor(dW)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def test_brownian_sampler_ou_moments():
    """The port's own sampler (a torch.Generator, not JAX's RBG bits): OU
    mean and variance at t=1 against the closed form, within ~2.5 sigma of
    the Monte-Carlo estimator at B=8192 (the bars of tests/test_solve.py)."""
    theta, mu, sigma, x0 = 1.5, 0.3, 0.4, 1.0
    gen = torch.Generator().manual_seed(0)
    ys = sdeint(lambda t, y: theta * (mu - y),
                lambda t, y: torch.full_like(y, sigma),
                torch.full((8192, 1), x0), np.linspace(0.0, 1.0, 11),
                generator=gen, dt=0.01)
    mean_an = mu + (x0 - mu) * np.exp(-theta)
    var_an = sigma ** 2 / (2 * theta) * (1 - np.exp(-2 * theta))
    assert abs(float(ys[-1].mean()) - mean_an) < 7e-3
    assert abs(float(ys[-1].var()) - var_an) / var_an < 0.08


def test_bce_and_weight_regularization_match_jax():
    """BCE(pos_weight=10) on logits up to |40| (log-sigmoid stays finite),
    and 0.01 x sum of parameter L2 norms over a field: rtol 1e-6."""
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=64) * 15).astype(np.float32)
    labels = (rng.random(64) < 0.3).astype(np.float32)
    ref = np.asarray(jloop.bce_with_logits_per_sample(
        jnp.asarray(logits), jnp.asarray(labels), 10.0))
    ours = tloop.bce_with_logits_per_sample(torch.as_tensor(logits),
                                            torch.as_tensor(labels), 10.0)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(tloop.bce_with_logits(torch.as_tensor(logits),
                                    torch.as_tensor(labels), 10.0)),
        float(jloop.bce_with_logits(jnp.asarray(logits),
                                    jnp.asarray(labels), 10.0)), rtol=1e-6)
    jfield = JaxField.create(jax.random.PRNGKey(5), 7, 6, 6, 2,
                             input_option=4, noise_option=17)
    field = DiffusionField(7, 6, 6, 2, input_option=4, noise_option=17)
    load_jax_arrays(field, jax_arrays(jfield))
    with torch.no_grad():
        reg = float(tloop.weight_regularization(field))
    np.testing.assert_allclose(reg,
                               float(jloop.weight_regularization(jfield)),
                               rtol=1e-6)


def test_metrics_match_jax():
    """Host numpy copies: equal to the last bit, ties included."""
    rng = np.random.default_rng(6)
    y = (rng.random(300) < 0.2).astype(np.int64)
    score = np.round(rng.normal(size=300) + y, 1)      # many ties
    assert tmetrics.auroc(y, score) == jmetrics.auroc(y, score)
    assert (tmetrics.average_precision(y, score)
            == jmetrics.average_precision(y, score))
    pred = (score > 0).astype(np.int64)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(y, pred, 2),
                                  jmetrics.confusion_matrix(y, pred, 2))
    a = tmetrics.classification_metrics(y, score, 0.5, 2).as_dict()
    b = jmetrics.classification_metrics(y, score, 0.5, 2).as_dict()
    assert a == b
    assert np.isnan(tmetrics.auroc(np.zeros(5), np.arange(5.0)))


@pytest.mark.parametrize("mode", ["max", "min"])
def test_reduce_lr_on_plateau_matches_jax(mode):
    rng = np.random.default_rng(7)
    metrics = np.concatenate([np.linspace(0.5, 0.8, 6), np.full(14, 0.79),
                              rng.uniform(0.7, 0.9, 20)])
    ours = ReduceLROnPlateau(lr=1e-3, mode=mode, patience=3)
    ref = JaxPlateau(lr=1e-3, mode=mode, patience=3)
    lrs = [(ours.step(float(m)), ref.step(float(m))) for m in metrics]
    assert all(a == b for a, b in lrs)
    assert min(a for a, _ in lrs) < 1e-3            # the rate was cut


def test_batchnorm_matches_jax_semantics():
    """Train mode normalises with the biased batch variance and keeps the
    unbiased one (momentum 0.1); eval mode uses the running statistics:
    atol 1e-5."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(32, 6)) * 3 + 1).astype(np.float32)
    jbn = JaxBatchNorm.create(6)
    jy, jbn2 = jbn(jnp.asarray(x), train=True)
    bn = BatchNorm(6)
    bn.train()
    y = bn(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jbn2.running_var.value), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jbn2.running_mean.value), atol=1e-6)
    bn.eval()
    jy_eval, _ = jbn2(jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jy_eval), atol=1e-5)


def test_dropout_keep_rate_and_scaling():
    """Rate 0.3 over 200k entries: the dropped share within 0.005 of 0.3
    (~7 sigma), kept entries scaled by 1/0.7; identity in eval mode, at
    rate 0 and without a generator; the same generator seed gives the
    same mask."""
    x = torch.ones(200_000)
    drop = Dropout(0.3)
    drop.train()
    out = drop(x, generator=torch.Generator().manual_seed(0))
    zero = (out == 0).float().mean().item()
    assert abs(zero - 0.3) < 0.005
    torch.testing.assert_close(out[out != 0],
                               torch.full_like(out[out != 0], 1 / 0.7))
    again = drop(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert torch.equal(drop(x), x)
    assert torch.equal(Dropout(0.0)(x, generator=torch.Generator()), x)
    drop.eval()
    assert torch.equal(drop(x, generator=torch.Generator()), x)


def test_synthetic_sepsis_is_bit_identical():
    ours = synthetic_sepsis(n=64, seed=3)
    ref = jax_synthetic_sepsis(n=64, seed=3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_preprocess_classification_matches_jax():
    """Same split, normalisation and intensity channels (exact); Hermite
    coefficients from the port's own interp to atol 1e-5."""
    X, static, y, lengths, _ = synthetic_sepsis(n=80, length=12, seed=1)
    times = np.arange(12, dtype=np.float32)
    ours = tcommon.preprocess_classification(X, y, lengths,
                                             use_intensity=True, times=times)
    ref = jcommon.preprocess_classification(X, y, lengths,
                                            use_intensity=True, times=times)
    assert ours["input_channels"] == ref["input_channels"] == 69
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(ours[split]["y"], ref[split]["y"])
        np.testing.assert_array_equal(ours[split]["final_index"],
                                      ref[split]["final_index"])
        np.testing.assert_allclose(ours[split]["coeffs"],
                                   ref[split]["coeffs"], atol=1e-5,
                                   rtol=1e-6)
    for a, b in zip(tcommon.stratified_split(y, seed=4),
                    jcommon.stratified_split(y, seed=4)):
        np.testing.assert_array_equal(a, b)
    # natural cubic coefficients over the NaN-laden sepsis channels
    ours = tcommon.preprocess_classification(X, y, lengths, times=times,
                                             interpolation="natural")
    ref = jcommon.preprocess_classification(X, y, lengths, times=times,
                                            interpolation="natural")
    for split in ("train", "val", "test"):
        np.testing.assert_allclose(ours[split]["coeffs"],
                                   ref[split]["coeffs"], atol=1e-5,
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="unknown interpolation"):
        tcommon.preprocess_classification(X, y, lengths,
                                          interpolation="linear")


def test_parse_model_name_matches_jax():
    for name in ("staticsde", "naivesde", "neuralsde", "neurallsde",
                 "neurallnsde", "neuralgsde", "neuralsde_0_0",
                 "neuralsde_6_19", "neuralsde_3_7"):
        assert parse_model_name(name) == jax_parse(name)
    for bad in ("neuralsde_7_0", "neuralsde_1_20", "lstm"):
        with pytest.raises(ValueError):
            parse_model_name(bad)
