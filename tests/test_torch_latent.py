"""The Latent SDE and the EM pair's latent mode, port against the JAX
package, on the CPU.

`LatentSDE` (snsde_torch/models/latent_sde.py) is carried across from the
JAX model's arrays (snsde_torch.convert, its buffers included): its f, g,
h, f_aug, g_aug and kl_initial to the reference's f/g bar (atol 2e-6,
rtol 1e-5), and its whole forward (out, latent, logqp) with the same
injected Brownian increments, and every gradient of a loss on it, to the
EM bar (1e-4 of each output's and gradient's largest entry). The plain
versions of the latent kernels (`fused_latent_em_solve` on CPU tensors)
are held to the JAX kernel's latent mode in Pallas interpret mode with
`dW_override`, trajectory (KL lane included) and every gradient to 1e-4
relative (ROADMAP's bar); the robustness classifier with `latentsde`: one
batch's loss with the weighted KL term and every gradient against the JAX
loss of train_ists_model (:186-191) on the same increments; and the sweep
with both latent names end to end at a tiny width, records and resume.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.harness import robustness as jrob
from snsde.models import latent_sde as jlat
from snsde.models.neuralsde import resolve_dt as jax_resolve_dt
from snsde.nn.core import filter_value_and_grad
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import loop as jloop

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels import _solver
from snsde_torch.kernels import fused_em as fe
from snsde_torch.models import latent_sde as tlat
from snsde_torch.models.latent_sde import LatentSDE
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import BrownianGrid, hermite_cubic_coeffs, make_grid
from snsde_torch.registry import PORTED_NAMES, make_seq_layer

B, L, C, H, HH = 8, 7, 3, 6, 5


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (buffers without
    their `.value`), the key format of snsde_torch.convert."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) / max(
        float(np.abs(np.asarray(b)).max()), 1e-6)


def _models(layers, sigma=0.5, seed=1):
    jm = jlat.LatentSDE.create(jax.random.PRNGKey(seed), C, H, HH, layers,
                               sigma=sigma, method="euler")
    tm = LatentSDE(C, H, HH, layers, sigma=sigma, method="euler")
    load_jax_arrays(tm, jax_arrays(jm))
    return jm, tm


def _setting(seed=0, Bn=B, Ln=L):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, C)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dW = (rng.normal(size=(len(grid) - 1, Bn, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    aug0 = np.concatenate([rng.normal(size=(Bn, H - 1)),
                           np.zeros((Bn, 1))], -1).astype(np.float32)
    return times, x, grid, dW, aug0


@pytest.mark.parametrize("layers", [1, 2])
def test_convert_carries_buffers_and_parameters(layers):
    """Every JAX leaf lands in the port's module: the buffers (theta, mu,
    sigma and the prior's py0_mean/py0_logvar) as buffers without a
    gradient, qy0_mean/qy0_logvar as parameters."""
    jm, tm = _models(layers, sigma=0.7)
    names = dict(tm.named_parameters())
    for b in ("theta", "mu", "sigma", "py0_mean", "py0_logvar"):
        assert b in dict(tm.named_buffers()) and b not in names
    assert {"qy0_mean", "qy0_logvar"} <= set(names)
    ours = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    for key, ref in jax_arrays(jm).items():
        got = ours[key]
        np.testing.assert_array_equal(got.T if got.ndim == 2 and key.endswith(
            "weight") else got, ref)
    assert len(tm.linears) == layers - 1


@pytest.mark.parametrize("fn", ["f", "g", "h", "f_aug", "g_aug"])
def test_vector_fields_match_jax(fn):
    """f, g, h on the latent state and f_aug, g_aug on the augmented one,
    at a scalar t, to the reference's f/g bar."""
    jm, tm = _models(2)
    rng = np.random.default_rng(3)
    width = H if fn.endswith("aug") else H - 1
    y = rng.normal(size=(B, width)).astype(np.float32)
    t = np.float32(0.37)
    ours = getattr(tm, fn)(torch.tensor(t), torch.as_tensor(y))
    theirs = getattr(jm, fn)(jnp.asarray(t), jnp.asarray(y))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=2e-6, rtol=1e-5)


def test_kl_initial_matches_jax():
    jm, tm = _models(1)
    jm = jm.replace(qy0_mean=jnp.full((1, 1), 0.3),
                    qy0_logvar=jnp.full((1, 1), -1.1))
    load_jax_arrays(tm, jax_arrays(jm))
    np.testing.assert_allclose(float(tm.kl_initial().detach()),
                               float(jm.kl_initial()), rtol=1e-6)


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_forward_and_every_grad_match_jax(route, monkeypatch):
    """The whole forward with an injected BrownianGrid on both sides (the
    port's eager sdeint, or its latent kernels' plain route), and the
    gradients of sum(out * w) + 10 logqp, each to 1e-4 of its largest
    entry."""
    times, x, grid, dW, _ = _setting()
    jm, tm = _models(2)
    w = np.random.default_rng(5).normal(size=(B, L, H)).astype(np.float32)
    jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW), U=None)
    jc = jax_hermite(jnp.asarray(times), jnp.asarray(x))

    def jloss(m):
        out, latent, logqp = m(jc, times, key=jax.random.PRNGKey(0), bm=jbm)
        return jnp.sum(out * w) + 10.0 * logqp, (out, latent, logqp)

    (_, (out_j, lat_j, kl_j)), g_j = filter_value_and_grad(
        jloss, has_aux=True)(jm)
    if route == "fused":
        real = fe.fused_latent_em_solve
        monkeypatch.setattr(
            tlat, "latent_solve_dispatch",
            lambda model, times, aug0, **kw: real(
                model, times, aug0, dt=kw["dt"], dW=kw["bm"].dW))
    coeffs = hermite_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(x))
    out, latent, logqp = tm(coeffs, times,
                            bm=BrownianGrid(grid, torch.as_tensor(dW)))
    (torch.sum(out * torch.as_tensor(w)) + 10.0 * logqp).backward()
    assert _rel(out.detach(), out_j) < 1e-4
    assert _rel(latent.detach(), lat_j) < 1e-4
    np.testing.assert_allclose(float(logqp), float(kl_j), rtol=1e-4)
    ours, theirs = grads_to_jax_layout(tm), jax_arrays(g_j)
    assert set(ours) == set(theirs) - {"theta", "mu", "sigma", "py0_mean",
                                       "py0_logvar"}
    for name, ref in ours.items():
        assert _rel(ref, theirs[name]) < 1e-4, name


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_plain_latent_em_matches_jax_kernel(layers, split, monkeypatch):
    """The latent kernels' plain versions (fused_latent_em_solve on CPU
    tensors; with `split` the backward as the card runs it: the
    recurrence's plain version, then the weight gradient's on its streams)
    against the JAX kernel's latent mode in Pallas interpret mode with
    dW_override: the trajectory with the KL lane and every gradient of an
    ELBO-shaped loss (terminal latent squares + the KL lane, and aug0's)
    to 1e-4 relative."""
    from snsde.kernels.fused_em import fused_latent_em_solve as jax_solve
    from test_torch_fused_em import _split_backward

    if split:
        monkeypatch.setattr(fe, "fused_em_backward_reference",
                            _split_backward)
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")
    times, _, _, dW, aug0 = _setting(seed=layers)
    jm, tm = _models(layers)
    dt = jax_resolve_dt(times)

    def jloss(tree):
        m, a0 = tree
        ys = jax_solve(m, times, a0, jax.random.PRNGKey(0), dt=dt,
                       dW_override=jnp.asarray(dW))
        return jnp.sum(ys[-1, :, :-1] ** 2) + jnp.sum(ys[:, :, -1]), ys

    (_, ys_j), g_j = filter_value_and_grad(jloss, has_aux=True)(
        (jm, jnp.asarray(aug0)))
    a0 = torch.as_tensor(aug0).requires_grad_(True)
    ys = fe.fused_latent_em_solve(tm, times, a0, dt=dt,
                                  dW=torch.as_tensor(dW))
    (torch.sum(ys[-1, :, :-1] ** 2) + torch.sum(ys[:, :, -1])).backward()
    assert float(np.abs(np.asarray(ys_j[-1, :, -1])).max()) > 1e-3
    assert _rel(ys.detach(), ys_j) < 1e-4
    ours = grads_to_jax_layout(tm)
    ours["aug0"] = a0.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["aug0"] = np.asarray(g_j[1])
    compared = 0
    for name, ref in theirs.items():
        if name not in ours or not np.abs(ref).max():
            continue
        assert _rel(ours[name], ref) < 1e-4, name
        compared += 1
    assert compared >= 2 * layers + 3


def test_latent_mode_checks():
    """The latent mode is drift 'yy' with noise 'precomp' and neither
    mult_y nor geometric (the JAX kernel's one cfg_key), and takes its rows
    exactly when latent."""
    m = _solver.sde_mode(False, False, "yy", "precomp", 0, True)
    assert m.latent and m.codes == (_solver.DRIFT_CODE["yy"],
                                    _solver.LATENT_CODE)
    for bad in ((True, False, "yy", "precomp"), (False, True, "yy", "precomp"),
                (False, False, "embm", "precomp"),
                (False, False, "yy", "net1")):
        with pytest.raises(ValueError, match="latent mode"):
            _solver.sde_mode(*bad, 0, True)
    _, tm = _models(1)
    times, _, grid, dW, aug0 = _setting()
    inp = fe.latent_inputs(tm, grid, torch.as_tensor(aug0),
                           torch.as_tensor(dW))
    args = [inp[k] for k in fe._ARG_ORDER]
    flags = {k: inp[k] for k in fe._MODE_KEYS}
    with pytest.raises(ValueError, match="lat not taken"):
        fe.fused_em_forward(*args, **flags)
    with pytest.raises(ValueError, match="lat missing"):
        fe.fused_em_forward(*args[:-1], None, **flags, latent=True)


@pytest.fixture(scope="module")
def sweep_setup():
    X, y, _ = synthetic_uea(n=3 * B, length=L, channels=2, num_classes=3,
                            seed=2)
    data = trob.preprocess_ists(X, 0.3, interpolation="hermite", seed=0)
    batch = {"seq": data["seq"][:B], "coeffs": data["coeffs"][:B],
             "y": y[:B]}
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), "latentsde", 2, L,
                                    H, 3)
    return jm, batch


def test_sweep_batch_loss_with_kl_matches_jax(sweep_setup, monkeypatch):
    """ISTSClassifier('latentsde') in train mode on one batch: the loss
    cross-entropy + kl_weight x logqp (kl_weight 1e-4 and 1, so the KL term
    shows) and every gradient against the JAX loss of train_ists_model,
    both sides solving with the same increments (each package's sdeint
    given the same BrownianGrid)."""
    jm, batch = sweep_setup
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dW = (np.random.default_rng(7).normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    jreal, treal = jlat.sdeint, tlat.sdeint
    jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW), U=None)
    monkeypatch.setattr(jlat, "sdeint",
                        lambda *a, **k: jreal(*a, **{**k, "bm": jbm}))
    monkeypatch.setattr(tlat, "sdeint", lambda *a, **k: treal(
        *a, **{**k, "bm": BrownianGrid(grid, torch.as_tensor(dW))}))
    for kl_weight in (1e-4, 1.0):
        def jloss(m):
            logits, new_m, aux = m(jnp.asarray(batch["seq"]),
                                   jnp.asarray(batch["coeffs"]),
                                   key=jax.random.PRNGKey(0), train=True)
            loss = jloop.softmax_cross_entropy(logits,
                                               jnp.asarray(batch["y"]))
            return loss + kl_weight * aux, aux

        (loss_j, aux_j), g_j = filter_value_and_grad(jloss, has_aux=True)(jm)
        model = trob.ISTSClassifier("latentsde", 2, L, H, 3)
        load_jax_arrays(model, jax_arrays(jm))
        model.train()
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss_t, _ = trob.ists_loss(model, b, kl_weight=kl_weight)
        loss_t.backward()
        _, aux_t = model(b["seq"], b["coeffs"], with_aux=True)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
        for name, g in ours.items():
            # the BatchNorm-cancelled embedding bias: 0 in truth, noise on
            # both sides (the ROADMAP's parity trap)
            floor = 1e-7 if name == "layer.inner.embedding.bias" else 0.0
            err = float(np.abs(g - theirs[name]).max())
            assert err <= 1e-4 * float(np.abs(theirs[name]).max()) + floor, \
                f"kl_weight {kl_weight} grad {name}: abs err {err:.2e}"


def test_latent_names_are_ported_and_run_euler():
    for name in ("latentsde", "latentsde-kl"):
        assert name in PORTED_NAMES
        layer = make_seq_layer(name, 2, L, H)
        assert isinstance(layer.inner, LatentSDE)
        assert layer.inner.method == "euler"
    assert make_seq_layer("latentsde", 2, L, H, method="srk").inner.method \
        == "srk"


def test_sweep_with_the_latent_names_writes_records_and_resumes(tmp_path):
    """run_robustness_sweep with latentsde and latentsde-kl at a tiny width
    on the CPU: one record each with an accuracy, the KL weight from
    SweepConfig, and a rerun resumes from the records."""
    cfg = trob.SweepConfig(models=("latentsde", "latentsde-kl"),
                           missing_rates=(0.3,), hidden_dim=5, batch_size=16,
                           max_epochs=2, out_dir=str(tmp_path))
    assert cfg.kl_weight == 1e-4
    kw = dict(n=40, verbose=False, device="cpu",
              data_fn=lambda n: synthetic_uea(n=n, length=8, channels=2))
    recs = trob.run_robustness_sweep(cfg, **kw)
    assert [r["model"] for r in recs] == ["latentsde", "latentsde-kl"]
    assert all("error" not in r and 0.0 <= r["accuracy"] <= 1.0
               and r["method"] == "euler" for r in recs)
    assert trob.run_robustness_sweep(cfg, **kw) == recs
