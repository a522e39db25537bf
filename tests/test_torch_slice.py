"""The sepsis training slice, port against the JAX package, on the CPU.

The sepsis model (static encoder -> z0 -> LNSDE -> BatchNorm readout) is
built by both packages from the same arrays (through snsde_torch.convert),
with the readout's dropout at rate 0 (the two sides draw different masks)
and the same injected Brownian increments. One train-mode loss and every
gradient must agree, and so must the parameters and BatchNorm buffers after
three coupled-Adam steps with the 100x readout hook.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.harness.classification import InitialValueModel as JaxIVM
from snsde.harness.classification import make_sde_model as jax_make_sde
from snsde.nn.core import combine, filter_value_and_grad, partition
from snsde.nn.layers import Dropout as JaxDropout
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import loop as jloop

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.harness.classification import (HarnessConfig,
                                                InitialValueModel,
                                                make_sde_model, run_sepsis)
from snsde_torch.ops import BrownianGrid, make_grid
from snsde_torch.train import loop as tloop

B, L, C, H, S = 12, 7, 5, 6, 4
LR = 1e-3


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


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(0)
    times = np.arange(L, dtype=np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = np.nan
    coeffs = np.array(jax_hermite(jnp.asarray(times), jnp.asarray(x)))
    static = rng.normal(size=(B, S)).astype(np.float32)
    y = (rng.random(B) < 0.3).astype(np.float32)
    final_index = rng.integers(L // 2, L, size=B).astype(np.int64)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0               # a padded final batch: 3 wrapped rows
    grid, _ = make_grid(times, 1.0)
    dws = [(rng.normal(size=(len(grid) - 1, B, H))
            * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
           for _ in range(3)]

    sde, _ = jax_make_sde(jax.random.PRNGKey(0), "neurallnsde", C, H, H, 2,
                          1, initial=False)
    jm = JaxIVM.create(jax.random.PRNGKey(1), S, H, sde)
    jm = jm.replace(sde=jm.sde.replace(
        readout=jm.sde.readout.replace(dropout=JaxDropout(rate=0.0))))
    data = dict(times=times, coeffs=coeffs, static=static, y=y,
                final_index=final_index, mask=mask, grid=grid, dws=dws)
    return jm, data


def jax_loss_fn(d, dW):
    bm = JaxBrownianGrid(grid=jnp.asarray(d["grid"]), dW=jnp.asarray(dW),
                         U=None)

    def loss(m):
        logits, new_m = m(d["times"], jnp.asarray(d["coeffs"]),
                          jnp.asarray(d["static"]),
                          jnp.asarray(d["final_index"]),
                          key=jax.random.PRNGKey(0), train=True, bm=bm)
        per = jloop.bce_with_logits_per_sample(logits[..., 0],
                                               jnp.asarray(d["y"]), 10.0)
        mask = jnp.asarray(d["mask"])
        value = jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0)
        return value + jloop.weight_regularization(m.sde.func, 0.01), new_m

    return loss


def port_model(jm):
    sde, _ = make_sde_model("neurallnsde", C, H, H, 2, 1, initial=False)
    model = InitialValueModel(S, H, sde)
    model.sde.readout.dropout.rate = 0.0
    load_jax_arrays(model, jax_arrays(jm))
    return model


def port_loss_fn(d, dW):
    bm = BrownianGrid(d["grid"], torch.as_tensor(dW))

    def apply_fn(m, batch, generator):
        return m(d["times"], batch["coeffs"], batch["static"],
                 batch["final_index"], generator=generator, bm=bm)[..., 0]

    return tloop.make_loss_fn(apply_fn, lambda m: m.sde.func,
                              tloop.TrainConfig(pos_weight=10.0))


def port_batch(d):
    return {"coeffs": torch.as_tensor(d["coeffs"]),
            "static": torch.as_tensor(d["static"]),
            "final_index": torch.as_tensor(d["final_index"]),
            "y": torch.as_tensor(d["y"]),
            "_mask": torch.as_tensor(d["mask"])}


def test_train_mode_loss_and_every_grad_match_jax(slice_setup):
    """Loss to 1e-5 relative and every gradient leaf to 1e-4 relative (the
    reference bar of tests/test_reference_parity.py): both sides run the
    eager solver on the same dW; they differ in f32 summation order only.
    The unused NeuralSDE.initial_network has a zero gradient on both."""
    jm, d = slice_setup
    (loss_j, _), g_j = filter_value_and_grad(jax_loss_fn(d, d["dws"][0]),
                                             has_aux=True)(jm)
    model = port_model(jm)
    model.train()
    loss_t, _ = port_loss_fn(d, d["dws"][0])(model, port_batch(d), None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        # atol 1e-7 for sde.readout.linear1.bias, whose true gradient is 0
        # (train-mode BatchNorm cancels it): both sides hold f32 noise there
        err = float(np.abs(ours[name] - ref).max())
        assert err < 1e-4 * float(np.abs(ref).max()) + 1e-7, (
            f"grad {name}: abs err {err:.2e}")
    assert not np.abs(theirs["sde.initial_network.weight"]).any()


def test_three_adam_steps_match_jax(slice_setup):
    """Coupled L2 (wd = lr * 0.01) + Adam, the 100x hook on
    sde.readout.linear2 before the decay, zero gradients for unused
    parameters (optax still decays them), the BatchNorm running-statistics
    update: after 3 steps every parameter to atol 1e-6 (an Adam step moves
    a parameter by ~lr, so this is 1e-3 of one step) and every buffer to
    atol 1e-5. sde.readout.linear1.bias gets atol 1e-5: its true gradient
    is 0 (BatchNorm cancels it), so Adam normalises f32 noise plus the
    decay term, and the noise moves it by ~1e-3 of a step per step."""
    jm, d = slice_setup
    tx = optax.chain(optax.add_decayed_weights(LR * 0.01), optax.adam(LR))
    hook = jloop.readout_grad_hook("sde.readout.linear2")
    opt_state = tx.init(partition(jm)[0])
    m = jm
    for dW in d["dws"]:
        (_, new_m), grads = filter_value_and_grad(jax_loss_fn(d, dW),
                                                  has_aux=True)(m)
        params, rest = partition(new_m)
        updates, opt_state = tx.update(hook(grads), opt_state, params)
        m = combine(optax.apply_updates(params, updates), rest)

    model = port_model(jm)
    cfg = tloop.TrainConfig(lr=LR, pos_weight=10.0)
    opt = tloop.make_optimizer(model, cfg)
    hooks = tloop.readout_grad_hook("sde.readout.linear2")(model)
    for dW in d["dws"]:
        tloop.train_step(model, opt, port_loss_fn(d, dW), port_batch(d), None)
    for h in hooks:
        h.remove()

    expected = port_model(m).state_dict()  # JAX's result, port layout
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-5 if "running" in k or k == "sde.readout.linear1.bias" \
            else 1e-6
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), atol=tol,
                                   err_msg=k)
    # the unused initial_network moved by weight decay on both sides
    w0 = jax_arrays(jm)["sde.initial_network.weight"]
    assert np.abs(expected["sde.initial_network.weight"].numpy()
                  - w0.T).max() > 0


def test_readout_hook_scales_only_its_subtree():
    sde, _ = make_sde_model("neurallnsde", C, H, H, 2, 1, initial=False,
                            generator=torch.Generator().manual_seed(0))
    model = InitialValueModel(S, H, sde,
                              generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    times = np.arange(L, dtype=np.float32)
    batch = {"coeffs": torch.as_tensor(rng.normal(size=(B, L - 1, 4 * C))
                                       .astype(np.float32)),
             "static": torch.as_tensor(rng.normal(size=(B, S))
                                       .astype(np.float32)),
             "final_index": torch.full((B,), L - 1),
             "y": torch.as_tensor((rng.random(B) < 0.5).astype(np.float32))}

    def grads(with_hook):
        model.zero_grad(set_to_none=True)
        hooks = (tloop.readout_grad_hook("sde.readout.linear2")(model)
                 if with_hook else [])
        logits = model(times, batch["coeffs"], batch["static"],
                       batch["final_index"],
                       generator=torch.Generator().manual_seed(2))
        tloop.bce_with_logits(logits[..., 0], batch["y"]).backward()
        for h in hooks:
            h.remove()
        return {k: p.grad.clone() for k, p in model.named_parameters()
                if p.grad is not None}

    plain, hooked = grads(False), grads(True)
    for k in plain:
        scale = 100.0 if k.startswith("sde.readout.linear2.") else 1.0
        torch.testing.assert_close(hooked[k], plain[k] * scale)


def test_run_sepsis_on_cpu_trains_and_restores():
    """The harness end to end at a tiny width on the CPU: finite losses,
    metrics on all three splits that cover the data once, AUROC in
    [0, 1]."""
    cfg = HarnessConfig(hidden_channels=6, hidden_hidden_channels=6,
                        batch_size=64)
    res = run_sepsis(cfg, n=160, max_epochs=2, device="cpu")
    assert len(res.history) == 2
    for h in res.history:
        assert np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
    assert 0.0 <= res.test_metrics.auroc <= 1.0
    sizes = [m.dataset_size for m in (res.train_metrics, res.val_metrics,
                                      res.test_metrics)]
    assert sum(sizes) == 160 and min(sizes) > 0
    assert res.parameters == sum(p.numel() for p in res.model.parameters())
