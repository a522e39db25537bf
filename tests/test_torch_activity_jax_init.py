"""run_activity from JAX's initial weights (its `init=` seam), against
JAX's run_activity on the CPU, and the checked-in initial weights that
`chip_smoke.py --activity-jax-init` trains from on the card.

At seed 0 the port's run, started from the leaves JAX's run draws
(tests/torch_activity_jax_init.py) and handed JAX's own sample noise for
every batch (the model's `eps=` seam, drawn from the keys JAX's
run_activity splits, in its order: the training batches, then the
validation and test batches), holds JAX's first epoch: the train loss,
val loss and accuracy and the test metrics to 1e-4 relative (an epoch of
Adam updates over float32 models that agree to 1e-5, tests/torch_zoo.py).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax

from snsde.harness import activity as jact

from snsde_torch.convert import load_jax_arrays
from snsde_torch.harness import activity as tact

from torch_activity_jax_init import FLAGSHIP, OUT, SEEDS, initial_leaves

N, K, SMALL = 96, 2, dict(latent_dim=4, rec_hidden=8, embed_time=8)


def _jax_noise(cfg, n_train, n_val, n_test):
    """Every batch's sample noise of JAX's first epoch, in the order
    run_activity uses it (snsde/harness/activity.py:143-232)."""
    B, L, lat = cfg.batch_size, 50, cfg.latent_dim
    nb = lambda n: -(-n // B)
    key = jax.random.PRNGKey(cfg.seed)
    key, _ = jax.random.split(key)
    key, ke = jax.random.split(key)
    keys = list(jax.random.split(ke, nb(n_train)))
    key, k1, k2 = jax.random.split(key, 3)
    keys += list(jax.random.split(k1, nb(n_val)))
    keys += list(jax.random.split(k2, nb(n_test)))
    return [torch.as_tensor(np.array(jax.random.normal(
        k, (cfg.k_iwae, B, L, lat)))) for k in keys]


def test_seed0_run_from_jax_initial_leaves_holds_jax_first_epoch(
        monkeypatch):
    cfg = dict(max_epochs=1, batch_size=16, k_iwae=K, seed=0, verbose=False,
               **SMALL)
    ref = jact.run_activity(jact.ActivityConfig(**cfg), n=N)
    tcfg = tact.ActivityConfig(**cfg)
    splits = tact.activity_splits(N, tcfg.data_seed)
    noise = _jax_noise(tcfg, *(len(ix) for ix in splits))
    real = tact.loss_fn

    def with_jax_noise(model, batch, k_iwae, **kw):
        kw.pop("generator", None)
        return real(model, batch, k_iwae, eps=noise.pop(0), **kw)

    monkeypatch.setattr(tact, "loss_fn", with_jax_noise)
    init = initial_leaves(0, D=12, L=50, num_heads=1, classes=7,
                          learn_emb=True, **SMALL)
    res = tact.run_activity(tcfg, n=N, device="cpu", init=init)
    assert not noise
    (h,), (hj,) = res.history, ref.history
    assert set(hj) <= set(h)
    for k in hj:
        np.testing.assert_allclose(h[k], hj[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(res.test_accuracy, ref.test_accuracy,
                               rtol=1e-4)
    # without the seam the port draws its own start
    monkeypatch.undo()
    own = tact.run_activity(tcfg, n=N, device="cpu")
    assert own.history[0]["train_loss"] != h["train_loss"]


@pytest.mark.parametrize("seed", SEEDS)
def test_checked_in_initial_weights_are_jaxs(seed):
    """goldens/activity_jax_init.npz holds, for each seed, exactly the
    leaves JAX's run_activity draws at the flagship's setting, and they
    load into the port's classifier (every leaf lands)."""
    z = np.load(OUT)
    pre = f"seed{seed}/"
    got = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    want = initial_leaves(seed, **FLAGSHIP)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = tact._ActivityModel(
        FLAGSHIP["D"], np.linspace(0.0, 1.0, FLAGSHIP["L"], dtype=np.float32),
        FLAGSHIP["latent_dim"], FLAGSHIP["rec_hidden"],
        FLAGSHIP["embed_time"], FLAGSHIP["num_heads"], FLAGSHIP["classes"],
        FLAGSHIP["learn_emb"])
    load_jax_arrays(model, got)
