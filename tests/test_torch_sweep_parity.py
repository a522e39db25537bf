"""A whole sweep run of the `gru` classifier, port against the JAX package,
on the CPU (ROADMAP Queue 3 item 3).

In the port's 20-problem sweep (PERF.md section 7) its `gru` and `grud`
came out 5.5 and 3.6 accuracy points above the JAX package's. The known
differences of those runs: the initial draws (each framework's generator),
the batch order of seeds 1 and 2 (the port seeds it from the run, JAX
from 0 for every run), and card against TPU. This test removes the first
two: JAX's classifier is built from PRNGKey(0) and carried into the port
(convert.py), both train on one small sweep-shaped problem (the same
preprocessed arrays, split and labels) with their own train_ists_model at
seed 0, where both shuffle with numpy's default_rng(0), and the
validation metrics of every epoch (and the test metrics of the restored
model) are compared: the loss within 1e-4 relative, the accuracy equal.

One parameter is pinned on both sides, the trap of ROADMAP "A trap for
parity tests": the bias of the stream's linear readout, which the
BatchNorm after it cancels, so its true gradient is 0 and each side
holds float32 noise there. Adam turns that noise into steps of the
learning rate in a random direction, and the bias reaches the evaluation
through BatchNorm's running mean (after one epoch every other parameter
agrees to 3e-7 while this bias differs by 2e-3 and the running mean by
3e-4). Its gradient is set to 0 on both sides (in the 100x hook that both
trainers look up), so the comparison sees the training path itself.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import snsde.harness.robustness as jrob
from snsde.data.common import stratified_split
from snsde.data.synthetic import synthetic_uea

import snsde_torch.harness.robustness as trob
from snsde_torch.convert import load_jax_arrays

EPOCHS, HID, BATCH = 8, 16, 32


def jax_arrays(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def _recording(monkeypatch, module):
    """Record every metrics object a trainer computes (each epoch's
    validation, then the test split's)."""
    seen = []
    real = module.classification_metrics

    def record(*args, **kwargs):
        m = real(*args, **kwargs)
        seen.append(m)
        return m

    monkeypatch.setattr(module, "classification_metrics", record)
    return seen


def _pin_the_cancelled_bias(monkeypatch):
    """Both trainers' 100x hook also zeroes layer.inner.linear.bias's
    gradient."""
    jreal, treal = jrob.readout_grad_hook, trob.readout_grad_hook

    def jax_hook(path):
        hook = jreal(path)

        def pinned(g):
            g = hook(g)
            lin = g.layer.inner.linear
            return g.replace(layer=g.layer.replace(
                inner=g.layer.inner.replace(linear=lin.replace(
                    bias=jnp.zeros_like(lin.bias)))))
        return pinned

    def port_hook(path):
        register = treal(path)

        def pinned(model):
            handles = register(model)
            bias = model.layer.inner.linear.bias
            return handles + [bias.register_hook(torch.zeros_like)]
        return pinned

    monkeypatch.setattr(jrob, "readout_grad_hook", jax_hook)
    monkeypatch.setattr(trob, "readout_grad_hook", port_hook)


@pytest.mark.parametrize("model_name", ["gru"])
def test_a_whole_gru_run_stays_with_jax_epoch_by_epoch(monkeypatch,
                                                       model_name):
    X, y, _ = synthetic_uea(n=160, length=20, channels=3, num_classes=2,
                            seed=4)
    data = jrob.preprocess_ists(X, missing_rate=0.3, seed=0)
    splits = stratified_split(y, seed=0)
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), model_name,
                                    X.shape[-1], X.shape[1], HID,
                                    int(y.max()) + 1)
    model = trob.ISTSClassifier(model_name, X.shape[-1], X.shape[1], HID,
                                int(y.max()) + 1)
    load_jax_arrays(model, jax_arrays(jm))
    _pin_the_cancelled_bias(monkeypatch)

    jax_seen = _recording(monkeypatch, jrob)
    jrob.train_ists_model(jax.random.PRNGKey(0), jm, data, y, splits,
                          batch_size=BATCH, max_epochs=EPOCHS, patience=99)
    port_seen = _recording(monkeypatch, trob)
    trob.train_ists_model(model, data, y, splits, batch_size=BATCH,
                          max_epochs=EPOCHS, patience=99, seed=0)

    assert len(jax_seen) == len(port_seen) == EPOCHS + 1
    for epoch, (j, t) in enumerate(zip(jax_seen, port_seen)):
        what = "test" if epoch == EPOCHS else f"epoch {epoch} val"
        assert abs(t.loss - j.loss) <= 1e-4 * abs(j.loss), (
            f"{what} loss: port {t.loss:.7f}, JAX {j.loss:.7f}")
        assert t.accuracy == j.accuracy, (
            f"{what} accuracy: port {t.accuracy}, JAX {j.accuracy}")
