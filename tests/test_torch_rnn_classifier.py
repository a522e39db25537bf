"""The robustness sweep's recurrent classifiers, port against the JAX
package, on the CPU: `ISTSClassifier` with the registry's `gru`, `grud`,
`lstm` and `bilstm` (the loss, every gradient after the 100x fc2 hook and
the clip at 10, three clip + Adam steps against optax), each through the
eager loop and through the fused route (see tests/test_torch_rnn.py, which
holds the models themselves).

Tolerances: the loss 1e-5 relative; every gradient 1e-4 relative to its
largest entry, where a bias is measured at the larger of its own scale and
its sibling weight's (`linear.bias` beside `linear.weight`, `b_ih` beside
`w_ih`). BatchNorm sits right after the recurrence's last step, so it
cancels the part of a bias's gradient that shifts every row alike:
`layer.inner.linear.bias` of the SeqRNN classifiers has a true gradient of
0 (float32 noise of 1.1e-7 to 1.9e-7 on the JAX side, 6.8e-7 on the
port's, against 0.055-0.088 on its weight), and GRUDFull's `b_ih` keeps
0.0042 of sums of terms the size of its weight's 0.021 (the port 5.6e-7
from a float64 run of itself, JAX 2e-8). After 3 clip + Adam steps every
parameter to atol 1e-6 and the BatchNorm statistics to 1e-5. Adam's first
step moves an entry by lr times the sign of its gradient, so an entry
whose gradient is float32 noise (below 1e-5 of its gradient's scale: the
cancelled bias, and e.g. one w_ih entry of the LSTM classifier at 6.6e-8
against noise of 8e-8) takes a step of noise: such entries are set to 0
on both sides at each step, from the JAX gradient.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.harness import robustness as jrob
from snsde.nn.core import combine, filter_value_and_grad, partition
from snsde.train import loop as jloop

from snsde_torch.convert import (_name_map, grads_to_jax_layout,
                                 load_jax_arrays)
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan
from snsde_torch.models import rnn as trnn
from snsde_torch.models import time_rnn as ttime
from snsde_torch.nn import layers as tlayers
from snsde_torch.train import loop as tloop

B, L, D, HID, K = 8, 6, 2, 6, 3
LR = 1e-3
NOISE = 1e-5
_SIBLING = {"bias": "weight", "b_ih": "w_ih", "b_hh": "w_hh"}


def grad_scale(grads, key):
    """The scale a gradient is held at: its largest entry, for a bias the
    larger of that and its sibling weight's."""
    scale = float(np.abs(grads[key]).max())
    head, _, leaf = key.rpartition(".")
    if leaf in _SIBLING:
        scale = max(scale, float(np.abs(
            grads[f"{head}.{_SIBLING[leaf]}"]).max()))
    return scale


def _key(path):
    return ".".join(k.name if isinstance(k, jax.tree_util.GetAttrKey)
                    else str(k.idx) for k in path
                    if not isinstance(k, jax.tree_util.FlattenedIndexKey))


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path, the key format of
    snsde_torch.convert."""
    return {_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def drop_noise(g):
    """(g with every entry below NOISE times its gradient's scale set to 0,
    the kept entries by key)."""
    arrs = jax_arrays(g)
    keep = {k: np.abs(v) >= NOISE * grad_scale(arrs, k)
            for k, v in arrs.items()}
    flat, treedef = jax.tree_util.tree_flatten_with_path(g)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.where(keep[_key(path)], leaf, 0.0) for path, leaf in flat]), keep


@pytest.fixture(params=["eager", "fused"])
def route(request, monkeypatch):
    """'fused' sends the CPU tensors through fused_gru_scan /
    fused_lstm_scan (the plain versions behind the autograd.Functions), the
    route a CUDA tensor takes to the kernels."""
    if request.param == "fused":
        def run(cell, xs, reverse=False, use_fused=True):
            if isinstance(cell, tlayers.LSTMCell):
                return fused_lstm_scan(cell, xs, reverse=reverse)
            if isinstance(cell, tlayers.GRUCell):
                return fused_gru_scan(cell, xs, reverse=reverse)
            return trnn.scan_cell(cell, xs, reverse)

        monkeypatch.setattr(trnn.SeqRNN, "_run", staticmethod(run))
        monkeypatch.setattr(ttime.GRUDFull, "forward",
                            lambda self, x, m, d, use_fused=True:
                            self._fused_path(x, m, d))
    return request.param


NAMES = ["gru", "grud", "lstm", "bilstm"]


@pytest.fixture(scope="module")
def batches():
    X, y, _ = synthetic_uea(n=3 * B, length=L, channels=D, num_classes=K,
                            seed=2)
    data = trob.preprocess_ists(X, 0.3, seed=0)
    return [{"seq": data["seq"][i * B:(i + 1) * B],
             "coeffs": data["coeffs"][i * B:(i + 1) * B],
             "y": y[i * B:(i + 1) * B]} for i in range(3)]


def jax_grads(m, batch):
    """(the model after the BatchNorm update, the gradients after the 100x
    fc2 hook and the clip at 10, the loss, the norm the clip saw)."""
    def loss(mod):
        logits, new_m, _ = mod(jnp.asarray(batch["seq"]),
                               jnp.asarray(batch["coeffs"]),
                               key=jax.random.PRNGKey(0), train=True)
        return jloop.softmax_cross_entropy(logits,
                                           jnp.asarray(batch["y"])), new_m

    (value, new_m), g = filter_value_and_grad(loss, has_aux=True)(m)
    g = jloop.readout_grad_hook("fc2")(g)
    norm = float(optax.global_norm(g))
    clip = optax.clip_by_global_norm(trob.CLIP_NORM)
    g, _ = clip.update(g, clip.init(g))
    return new_m, g, value, norm


def port_model(name, jm):
    model = trob.ISTSClassifier(name, D, L, HID, K)
    load_jax_arrays(model, jax_arrays(jm))
    return model


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", NAMES)
def test_classifier_loss_and_every_grad_match_jax(name, batches, route):
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), name, D, L, HID, K)
    _, g_j, loss_j, norm_j = jax_grads(jm, batches[0])
    model = port_model(name, jm)
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
    for key, ref in theirs.items():
        err = float(np.abs(ours[key] - ref).max())
        assert err <= 1e-4 * grad_scale(theirs, key), (
            f"{name} {route} grad {key}: abs err {err:.2e}")


@pytest.mark.parametrize("name", NAMES)
def test_classifier_three_clip_adam_steps_match_jax(name, batches, route):
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), name, D, L, HID, K)
    tx = optax.chain(optax.clip_by_global_norm(trob.CLIP_NORM),
                     optax.adam(LR))
    opt_state = tx.init(partition(jm)[0])
    m = jm
    keeps = []          # per step: the entries above the noise, by key
    for batch in batches:
        new_m, g, _, _ = jax_grads(m, batch)
        g, keep = drop_noise(g)
        keeps.append(keep)
        params, rest = partition(new_m)
        updates, opt_state = tx.update(g, opt_state, params)
        m = combine(optax.apply_updates(params, updates), rest)

    model = port_model(name, jm)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    hooks = tloop.readout_grad_hook("fc2")(model)
    step = [0]
    for pname, (jkey, tr) in _name_map(model).items():
        if pname in dict(model.named_parameters()):
            def mask(grad, jkey=jkey, tr=tr):
                keep = torch.as_tensor(keeps[step[0]][jkey])
                return grad * (keep.T if tr else keep)

            hooks.append(model.get_parameter(pname).register_hook(mask))
    for batch in batches:
        trob.ists_train_step(model, opt, port_batch(batch))
        step[0] += 1
    for h in hooks:
        h.remove()
    expected = port_model(name, m).state_dict()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-5 if "running" in k else 1e-6
        np.testing.assert_allclose(v.numpy(), expected[k].numpy(), atol=tol,
                                   err_msg=f"{name} {route} {k}")
