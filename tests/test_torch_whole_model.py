"""The whole sepsis model's loss and every gradient, the JAX package's
written to tests/goldens/sepsis_whole_model.npz and the port's held to it
(tests/sepsis_whole_model.py has the model, the data and the tolerances;
the same check runs through the EM kernels on the card in
tests/test_torch_cuda.py and chip_smoke.py).

The JAX side runs its scan solver on the CPU with the increments injected
(BrownianGrid); so does the port here (its eager solve: CPU tensors take no
kernel). The golden is written when it is missing and otherwise held to
the JAX package's values of this run within 1e-6, so a change on either
side shows.
"""

import os

import numpy as np

import jax
import jax.numpy as jnp

from snsde.harness.classification import InitialValueModel as JaxIVM
from snsde.harness.classification import make_sde_model as jax_make_sde
from snsde.nn.core import filter_value_and_grad
from snsde.nn.layers import Dropout as JaxDropout
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import loop as jloop

import sepsis_whole_model as wm


def jax_arrays(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def _jax_loss_and_grads():
    d = wm.data()
    sde, _ = jax_make_sde(jax.random.PRNGKey(0), wm.MODEL, wm.C, wm.H, wm.H,
                          wm.LAYERS, 1, initial=False)
    jm = JaxIVM.create(jax.random.PRNGKey(1), wm.S, wm.H, sde)
    jm = jm.replace(sde=jm.sde.replace(
        readout=jm.sde.readout.replace(dropout=JaxDropout(rate=0.0))))
    leaves = jax_arrays(jm)
    arrays = wm.params({k: v.shape for k, v in leaves.items()})
    # jax_arrays keeps the flattening order: refill the leaves in it
    treedef = jax.tree_util.tree_structure(jm)
    jm = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[k]) for k in leaves])
    grid = np.arange(wm.L, dtype=np.float64)
    bm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(d["dW"]),
                         U=None)
    coeffs = jax_hermite(jnp.asarray(d["times"]), jnp.asarray(d["x"]))
    mask = jnp.asarray(d["mask"])

    def loss(m):
        logits, new_m = m(d["times"], coeffs, jnp.asarray(d["static"]),
                          jnp.asarray(d["final_index"]),
                          key=jax.random.PRNGKey(0), train=True, bm=bm)
        per = jloop.bce_with_logits_per_sample(logits[..., 0],
                                               jnp.asarray(d["y"]), 10.0)
        value = jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0)
        return value + jloop.weight_regularization(m.sde.func, 0.01), new_m

    (value, _), g = filter_value_and_grad(loss, has_aux=True)(jm)
    return float(value), jax_arrays(g)


def test_golden_is_the_jax_packages_whole_model_loss_and_grads():
    loss, grads = _jax_loss_and_grads()
    fresh = {"loss": np.float64(loss),
             **{f"grad.{k}": v.astype(np.float32) for k, v in grads.items()}}
    if not os.path.exists(wm.GOLDEN):
        np.savez_compressed(wm.GOLDEN, **fresh)
    golden = np.load(wm.GOLDEN)
    assert set(golden.files) == set(fresh)
    assert abs(float(golden["loss"]) - loss) <= 1e-6 * abs(loss)
    for k, v in fresh.items():
        if k.startswith("grad."):
            scale = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(golden[k] - v).max()) <= 1e-6 * scale, k


def test_the_ports_eager_model_matches_the_golden(monkeypatch):
    """The port's whole sepsis model on the CPU, the increments handed to
    its eager solver, against the JAX package's loss and gradients."""
    import torch

    import snsde_torch.ops.solve as tsolve

    d = wm.data()
    monkeypatch.setattr(tsolve, "brownian_increments",
                        lambda *a, **k: torch.as_tensor(d["dW"]))
    model = wm.port_model("cpu")
    loss, grads = wm.port_loss_and_grads(model, d, torch.Generator())
    wm.check(loss, grads, np.load(wm.GOLDEN))
