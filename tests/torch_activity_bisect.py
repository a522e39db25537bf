"""The activity flagship at one seed, epoch by epoch, in the port and in
the JAX package on the CPU: the port's run_activity starts from the leaves
JAX's run_activity draws at the seed (tests/torch_activity_jax_init.py)
and takes JAX's own sample noise for every batch (the model's `eps=` seam,
drawn on the fly from the keys JAX's run splits, in its order: each
epoch's training batches, then its validation and, when the validation
loss improved, its test batches). Both runs are printed side by side, and
the first epoch whose train loss parts beyond float32 noise (REL, the bar
a seed-0 epoch holds in tests/test_torch_activity_jax_init.py) is named.

    JAX_PLATFORMS=cpu python tests/torch_activity_bisect.py [SEED [EPOCHS [N]]]

Defaults: seed 2, 200 epochs, n=1024, the flagship's model and warmup
(chip_smoke.py's ACTIVITY_R5; tests/torch_activity_jax_init.py's
FLAGSHIP). With a fourth argument `nudge` it prints float32's own yardstick
instead: JAX's run beside JAX's run from the same leaves nudged by one ulp
(np.nextafter), with the same noise; the epoch where those two part is
where rounding alone makes runs part. Not collected as a test module: it
imports the JAX package and runs for tens of minutes."""

import json
import os
import sys
import time

import numpy as np
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from snsde.harness import activity as jact  # noqa: E402

from snsde_torch.harness import activity as tact  # noqa: E402

from torch_activity_jax_init import FLAGSHIP, initial_leaves  # noqa: E402

REL = 1e-4
KEYS = ("train_loss", "val_loss", "val_acc")


class JaxNoise:
    """JAX's sample noise in the order the port's run_activity asks for it:
    training batches run with autograd on, evaluation batches without, so
    a batch with autograd on after the epoch's training batches starts the
    next epoch (its test keys unused when the validation loss did not
    improve)."""

    def __init__(self, cfg, n_train, n_val, n_test):
        self.cfg, self.L = cfg, FLAGSHIP["L"]
        nb = lambda n: -(-n // cfg.batch_size)
        self.nb = (nb(n_train), nb(n_val), nb(n_test))
        key = jax.random.PRNGKey(cfg.seed)
        self.key, _ = jax.random.split(key)
        self.epoch_keys, self.i = None, 0

    def _next_epoch(self):
        self.key, ke = jax.random.split(self.key)
        keys = list(jax.random.split(ke, self.nb[0]))
        self.key, k1, k2 = jax.random.split(self.key, 3)
        keys += list(jax.random.split(k1, self.nb[1]))
        keys += list(jax.random.split(k2, self.nb[2]))
        self.epoch_keys, self.i = keys, 0

    def __call__(self):
        if self.epoch_keys is None or (torch.is_grad_enabled()
                                       and self.i >= self.nb[0]):
            self._next_epoch()
        k = self.epoch_keys[self.i]
        self.i += 1
        c = self.cfg
        return torch.as_tensor(np.array(jax.random.normal(
            k, (c.k_iwae, c.batch_size, self.L, c.latent_dim))))


def config(mod, seed, epochs):
    return mod.ActivityConfig(
        max_epochs=epochs, k_iwae=5, warmup_epochs=5, seed=seed,
        latent_dim=FLAGSHIP["latent_dim"], rec_hidden=FLAGSHIP["rec_hidden"],
        embed_time=FLAGSHIP["embed_time"], num_heads=FLAGSHIP["num_heads"],
        learn_emb=FLAGSHIP["learn_emb"], verbose=False)


def port_run(seed, epochs, n):
    """The port's run on the CPU from JAX's leaves with JAX's noise."""
    cfg = config(tact, seed, epochs)
    noise = JaxNoise(cfg, *(len(ix) for ix in
                            tact.activity_splits(n, cfg.data_seed)))
    real = tact.loss_fn

    def with_jax_noise(model, batch, k_iwae, **kw):
        kw.pop("generator", None)
        return real(model, batch, k_iwae, eps=noise(), **kw)

    tact.loss_fn = with_jax_noise
    try:
        return tact.run_activity(cfg, n=n, device="cpu",
                                 init=initial_leaves(seed, **FLAGSHIP))
    finally:
        tact.loss_fn = real


def jax_nudged_run(seed, epochs, n):
    """JAX's run from its own initial leaves, each floating leaf one ulp
    up."""
    create = jact._ActivityModel.create

    def nudged(*args, **kw):
        return jax.tree_util.tree_map(
            lambda v: (np.nextafter(np.asarray(v), np.float32(np.inf))
                       if hasattr(v, "dtype") and v.dtype == np.float32
                       else v), create(*args, **kw))

    jact._ActivityModel.create = nudged
    try:
        return jact.run_activity(config(jact, seed, epochs), n=n)
    finally:
        jact._ActivityModel.create = create


def first_parting(hj, ht, rel=REL):
    """The first epoch whose train loss parts by more than rel (relative),
    or None."""
    for e, (a, b) in enumerate(zip(hj, ht)):
        if abs(a["train_loss"] - b["train_loss"]) > rel * abs(a["train_loss"]):
            return e
    return None


def main(seed=2, epochs=200, n=1024, other="port"):
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    t0 = time.time()
    ref = jact.run_activity(config(jact, seed, epochs), n=n)
    t1 = time.time()
    res = (jax_nudged_run if other == "nudge" else port_run)(seed, epochs, n)
    t2 = time.time()
    hj, ht = ref.history, res.history
    name = "JAX nudged" if other == "nudge" else "port"
    print(f"seed {seed}, {epochs} epochs, n={n}: JAX {t1 - t0:.0f} s, "
          f"{name} {t2 - t1:.0f} s (CPU)")
    print(f"epoch | JAX train_loss val_loss val_acc | {name} train_loss "
          "val_loss val_acc | rel train_loss")
    for a, b in zip(hj, ht):
        d = abs(a["train_loss"] - b["train_loss"]) / abs(a["train_loss"])
        print(f"{a['epoch']:4d} | " + " ".join(f"{a[k]:.6f}" for k in KEYS)
              + " | " + " ".join(f"{b[k]:.6f}" for k in KEYS)
              + f" | {d:.2e}")
    e = first_parting(hj, ht)
    print(f"test accuracy: JAX {ref.test_accuracy:.4f}, {name} "
          f"{res.test_accuracy:.4f}")
    print("first epoch whose train loss parts beyond "
          f"{REL:g} relative: {e}")
    print(json.dumps({"seed": seed, "epochs": epochs, "n": n,
                      "first_parting_epoch": e, "other": name,
                      "test_accuracy": {"jax": ref.test_accuracy,
                                        name: res.test_accuracy},
                      "jax": hj, name: ht}, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:4]), *sys.argv[4:5]))
