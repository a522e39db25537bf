"""The robustness sweep's Neural CDE slice, port against the JAX package, on
the CPU.

The UEA-shaped synthetic data and its (x, mask, delta) preprocessing with
seeded missingness; `ISTSClassifier("neuralcde")` (NeuralCDEStream with a
FinalTanh field on a natural cubic control, rk4) in train mode: the loss,
every gradient after the 100x fc2 hook and the global-norm clip at 10, and
three clip + Adam steps against optax on the same weights (carried across
by snsde_torch.convert); the clip and StepLR against their JAX
counterparts; and the sweep loop end to end at a tiny width, with its
records and resume.

The classifier runs through the port's eager `cdeint` (what a CPU tensor
gets) and through the fused solve's autograd.Function with its plain
versions (the route a CUDA tensor takes to the kernels); the JAX package
runs its scan `cdeint`.

Tolerances: the loss 1e-5 relative; every gradient 1e-4 relative to its
largest entry, with an absolute floor of 1e-7 for layer.inner.linear.bias,
whose true gradient is 0 (train-mode BatchNorm right after it cancels it,
so both sides hold float32 noise there); after 3 steps every parameter to
atol 1e-6 (1e-3 of one Adam step) and the BatchNorm statistics to 1e-5.
For the steps, that bias's gradient is set to its true value 0 on both
sides: Adam would blow each side's noise up to a step of its own, and
through the bias the BatchNorm running mean would drift apart too.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.data.synthetic import synthetic_uea as jax_synthetic_uea
from snsde.harness import robustness as jrob
from snsde.nn.core import combine, filter_value_and_grad, partition
from snsde.registry import MODEL_NAMES as JAX_MODEL_NAMES
from snsde.train import loop as jloop
from snsde.train.schedule import StepLR as JaxStepLR

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.data.common import stratified_split
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.models import neuralcde as tcde
from snsde_torch.registry import MODEL_NAMES, PORTED_NAMES, make_seq_layer
from snsde_torch.train import loop as tloop
from snsde_torch.train.schedule import StepLR

B, L, D, HID, K = 8, 6, 2, 5, 3
LR = 1e-3
BN_CANCELLED = "layer.inner.linear.bias"


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


def test_synthetic_uea_matches_jax():
    for a, b in zip(synthetic_uea(n=40, length=9, channels=3, seed=4),
                    jax_synthetic_uea(n=40, length=9, channels=3, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["natural", "hermite"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_preprocess_ists_matches_jax(rate, family):
    """seq (x with NaN as 0, mask, delta) exactly; the packed coefficients
    to 1e-5 of their largest entry (the time channel is linear, so its
    second and third coefficients are float32 noise on both sides, scaled
    by 1/dt^2 and 1/dt^3)."""
    X, _, _ = synthetic_uea(n=12, length=9, channels=3, seed=1)
    ours = trob.preprocess_ists(X, rate, interpolation=family, seed=3)
    theirs = jrob.preprocess_ists(X, rate, interpolation=family, seed=3)
    assert ours["seq"].shape == (12, 3, 9, 3)
    np.testing.assert_array_equal(ours["seq"], theirs["seq"])
    np.testing.assert_array_equal(ours["times"], theirs["times"])
    assert np.isfinite(ours["coeffs"]).all()
    ref = np.asarray(theirs["coeffs"])
    err = float(np.abs(ours["coeffs"] - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def test_coeff_family_and_registry_names_match_jax():
    assert MODEL_NAMES == JAX_MODEL_NAMES
    for name in MODEL_NAMES:
        assert trob.coeff_family(name) == jrob.coeff_family(name), name
    for name in MODEL_NAMES:
        if name in PORTED_NAMES:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_seq_layer(name, D, L, HID)
    with pytest.raises(NotImplementedError, match="unknown model name"):
        make_seq_layer("neuralcde-x", D, L, HID)


@pytest.fixture(scope="module")
def slice_setup():
    """Three batches of preprocessed UEA-shaped series (30% missing,
    natural coefficients) and the JAX classifier."""
    X, y, _ = synthetic_uea(n=3 * B, length=L, channels=D, num_classes=K,
                            seed=2)
    data = trob.preprocess_ists(X, 0.3, interpolation="natural", seed=0)
    batches = [{"seq": data["seq"][i * B:(i + 1) * B],
                "coeffs": data["coeffs"][i * B:(i + 1) * B],
                "y": y[i * B:(i + 1) * B]} for i in range(3)]
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), "neuralcde", D, L,
                                    HID, K, num_hidden_layers=2)
    return jm, batches


def jax_loss(m, batch):
    logits, new_m, _ = m(jnp.asarray(batch["seq"]),
                         jnp.asarray(batch["coeffs"]),
                         key=jax.random.PRNGKey(0), train=True)
    return jloop.softmax_cross_entropy(logits, jnp.asarray(batch["y"])), new_m


def jax_grads(m, batch):
    """(loss, the model after the BatchNorm update, the gradients after the
    100x fc2 hook and the clip at 10, the global norm the clip saw)."""
    (loss, new_m), g = filter_value_and_grad(jax_loss, has_aux=True)(m, batch)
    g = jloop.readout_grad_hook("fc2")(g)
    norm = float(optax.global_norm(g))
    clip = optax.clip_by_global_norm(trob.CLIP_NORM)
    g, _ = clip.update(g, clip.init(g))
    return loss, new_m, g, norm


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_model(jm):
    model = trob.ISTSClassifier("neuralcde", D, L, HID, K,
                                num_hidden_layers=2)
    load_jax_arrays(model, jax_arrays(jm))
    return model


@pytest.fixture(params=["eager", "fused"])
def route(request, monkeypatch):
    """'fused' sends the CPU tensors through FusedCDE (its plain versions),
    the route a CUDA tensor takes to the kernels."""
    if request.param == "fused":
        def dispatch(path, func, z0, ts, *, dt, method, use_fused=True):
            return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)

        monkeypatch.setattr(tcde, "cde_solve_dispatch", dispatch)
    return request.param


def test_loss_and_every_grad_after_hook_and_clip_match_jax(slice_setup,
                                                           route):
    jm, batches = slice_setup
    loss_j, _, g_j, norm_j = jax_grads(jm, batches[0])
    assert norm_j > trob.CLIP_NORM          # the clip acts on this batch
    model = port_model(jm)
    model.train()
    hooks = tloop.readout_grad_hook("fc2")(model)
    b = port_batch(batches[0])
    loss_t = tloop.softmax_cross_entropy(model(b["seq"], b["coeffs"]),
                                         b["y"])
    loss_t.backward()
    for h in hooks:
        h.remove()
    norm_t = tloop.clip_by_global_norm(list(model.parameters()),
                                       trob.CLIP_NORM)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(norm_t), norm_j, rtol=1e-4)
    ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        floor = 1e-7 if name == BN_CANCELLED else 0.0
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + floor, (
            f"{route} grad {name}: abs err {err:.2e}")


def test_three_clip_adam_steps_match_jax(slice_setup, route):
    """optax.chain(clip_by_global_norm(10), adam(1e-3)) with the hook before
    it, three batches: every parameter and BatchNorm statistic after the
    third step (the BatchNorm-cancelled bias's gradient zeroed on both
    sides, see the module's docstring)."""
    jm, batches = slice_setup
    tx = optax.chain(optax.clip_by_global_norm(trob.CLIP_NORM),
                     optax.adam(LR))
    opt_state = tx.init(partition(jm)[0])
    m = jm
    for batch in batches:
        _, new_m, g, _ = jax_grads(m, batch)
        g = g.replace(layer=g.layer.replace(inner=g.layer.inner.replace(
            linear=g.layer.inner.linear.replace(
                bias=jnp.zeros_like(g.layer.inner.linear.bias)))))
        # jax_grads already clipped; clipping twice is the identity
        params, rest = partition(new_m)
        updates, opt_state = tx.update(g, opt_state, params)
        m = combine(optax.apply_updates(params, updates), rest)

    model = port_model(jm)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    hooks = tloop.readout_grad_hook("fc2")(model)
    hooks.append(model.get_parameter(BN_CANCELLED).register_hook(
        torch.zeros_like))
    for batch in batches:
        trob.ists_train_step(model, opt, port_batch(batch))
    for h in hooks:
        h.remove()
    expected = port_model(m).state_dict()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-5 if "running" in k else 1e-6
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_is_optax(scale):
    """Below the limit the gradients stay; above it every gradient is
    scaled by max_norm / norm (optax), not max_norm / (norm + 1e-6)."""
    rng = np.random.default_rng(0)
    gs = [scale * rng.normal(size=s).astype(np.float32)
          for s in ((3, 4), (5,), (2, 2, 2))]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(params, gs):
        p.grad = torch.as_tensor(g.copy())
    norm = tloop.clip_by_global_norm(params, 1.0)
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(gs))
    np.testing.assert_allclose(float(norm), float(optax.global_norm(gs)),
                               rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_step_lr_matches_jax():
    ours, theirs = StepLR(lr=1e-3), JaxStepLR(lr=1e-3)
    for _ in range(35):
        assert ours.step() == theirs.step()


def _tiny_data(n):
    return synthetic_uea(n=n, length=12, channels=2, num_classes=2, seed=0)


def test_run_robustness_sweep_writes_records_and_resumes(tmp_path,
                                                         monkeypatch):
    """A tiny sweep on the CPU: the Neural CDE trains and gets an accuracy,
    an unported name becomes an error record (the reference sweep's
    blanket skip), each record is a JSON file, and a second call reads
    them back without training."""
    cfg = trob.SweepConfig(models=("neuralcde", "tlstm"),
                           missing_rates=(0.3,),
                           seeds=(0,), hidden_dim=6, batch_size=16,
                           max_epochs=2, out_dir=str(tmp_path))
    trained = {}
    recs = trob.run_robustness_sweep(cfg, n=60, data_fn=_tiny_data,
                                     verbose=False, device="cpu",
                                     models=trained)
    assert [r["model"] for r in recs] == ["neuralcde", "tlstm"]
    cde, tlstm = recs
    assert 0.0 <= cde["accuracy"] <= 1.0 and cde["method"] == "rk4"
    assert "error" not in cde
    assert "NotImplementedError" in tlstm["error"]
    assert set(trained) == {(0.3, "neuralcde", 0)}
    files = sorted(p.name for p in (tmp_path / "synthetic_uea" / "30")
                   .iterdir())
    assert files == ["neuralcde_0.json", "tlstm_0.json"]

    def no_training(*a, **k):
        raise AssertionError("trained again")

    monkeypatch.setattr(trob, "train_ists_model", no_training)
    again = trob.run_robustness_sweep(cfg, n=60, data_fn=_tiny_data,
                                      verbose=False, device="cpu")
    assert again == recs
    # pack_seeds reads the same records back too (nothing left to pack)
    monkeypatch.setattr(trob, "train_ists_ensemble", no_training)
    assert trob.run_robustness_sweep(cfg, n=60, data_fn=_tiny_data,
                                     pack_seeds=True, verbose=False,
                                     device="cpu") == recs


def test_sweep_save_preds_writes_the_test_predictions(tmp_path):
    """save_preds writes (y_true, y_pred, logits) of the test split beside
    the record: predict_ists of the trained model, whose accuracy is the
    record's."""
    cfg = trob.SweepConfig(models=("neuralcde",), missing_rates=(0.3,),
                           seeds=(1,), hidden_dim=6, batch_size=16,
                           max_epochs=1, out_dir=str(tmp_path),
                           save_preds=True)
    trained = {}
    rec, = trob.run_robustness_sweep(cfg, n=60, data_fn=_tiny_data,
                                     verbose=False, device="cpu",
                                     models=trained)
    dump = np.load(tmp_path / "synthetic_uea" / "30" / "neuralcde_1.npz")
    X, y, _ = _tiny_data(60)
    data = trob.preprocess_ists(X, 0.3, interpolation="natural", seed=1)
    test_idx = stratified_split(y, seed=1)[2]
    yt, yp, lo = trob.predict_ists(trained[(0.3, "neuralcde", 1)], data, y,
                                   test_idx, batch_size=16)
    np.testing.assert_array_equal(dump["y_true"], y[test_idx])
    np.testing.assert_array_equal(dump["y_true"], yt)
    np.testing.assert_array_equal(dump["y_pred"], yp)
    np.testing.assert_array_equal(dump["logits"], lo)
    assert lo.shape == (len(test_idx), 2)
    assert rec["accuracy"] == pytest.approx(float(np.mean(yp == yt)))


def test_sweep_needs_cuda_unless_told_cpu(tmp_path, monkeypatch):
    """The entry point runs on CUDA by default; without a card it raises
    before any record is written (not as an error record)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trob.SweepConfig(models=("neuralcde",), missing_rates=(0.0,),
                           out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trob.run_robustness_sweep(cfg, n=20, data_fn=_tiny_data)
    assert not list(tmp_path.iterdir())
