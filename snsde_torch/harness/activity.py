"""PersonActivity per-time-point classification harness (counterpart of
snsde/harness/activity.py).

The mTAN recognition encoder runs over the observed (values ‖ mask,
times) and gives a posterior (mu, logvar) at each reference point; k_iwae
reparameterised samples feed a 300-300 MLP classifier at each time point,
and the loss is the per-time-point cross entropy over the activity labels,
averaged over the samples and the time points. The splits are 80/20 test,
then 80/20 val of the rest (64/16/20 overall), from numpy's
default_rng(data_seed), and the batch orders from default_rng(seed), both
JAX's. Model selection keeps the epoch of strictly lowest val loss and
reports the test metrics taken at it.

The encoder's BiGRU runs on the fused GRU kernels on a CUDA device. The
samples come from one generator on the model's device seeded with
cfg.seed, in training and in evaluation, or through the `eps=` seam.
With `warmup_epochs`, update s (counted from 0) takes the rate
lr min(s, T) / T over T = warmup_epochs x steps an epoch, the value of
optax.linear_schedule(0, lr, T) at the update count before the update: the
first update has rate 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.person_activity import NUM_CLASSES, synthetic_person_activity
from ..models.mtan import MTANEncoder
from ..nn.layers import make_linear
from ..train.loop import _to_device, padded_index_grid

__all__ = ["ActivityConfig", "ActivityResult", "run_activity", "loss_fn",
           "warmup_lr", "activity_splits"]


@dataclass
class ActivityConfig:
    latent_dim: int = 32
    rec_hidden: int = 32
    embed_time: int = 128
    num_heads: int = 1
    k_iwae: int = 5
    lr: float = 1e-3
    # linear rate warmup over the first N epochs (0: a constant rate)
    warmup_epochs: int = 0
    batch_size: int = 128
    max_epochs: int = 30
    learn_emb: bool = True
    seed: int = 0
    data_seed: int = 0
    verbose: bool = True


@dataclass
class ActivityResult:
    test_accuracy: float
    test_loss: float
    val_accuracy: float
    val_loss: float
    history: list
    wall_time: float
    parameters: int


class _ActivityModel(nn.Module):
    """mTAN recognition encoder + per-time-point MLP classifier (latent ->
    300 -> 300 -> num_classes): forward(x [B, L, 2D], tp [B, L], k_iwae)
    -> logits [k, B, L, num_classes]."""

    def __init__(self, input_dim: int, query, latent_dim: int,
                 rec_hidden: int, embed_time: int, num_heads: int,
                 num_classes: int, learn_emb: bool, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.rec = MTANEncoder(input_dim, query, latent_dim, rec_hidden,
                               embed_time, num_heads, learn_emb=learn_emb,
                               **kw)
        self.fc1 = make_linear(latent_dim, 300, **kw)
        self.fc2 = make_linear(300, 300, **kw)
        self.fc3 = make_linear(300, num_classes, **kw)

    def forward(self, x, tp, k_iwae: int, *,
                generator: Optional[torch.Generator] = None, eps=None,
                use_fused: bool = True):
        out = self.rec(x, tp, use_fused=use_fused)      # [B, Lq, 2 latent]
        latent = out.shape[-1] // 2
        mu, logvar = out[..., :latent], out[..., latent:]
        if eps is None:
            eps = torch.randn((k_iwae,) + mu.shape, generator=generator,
                              dtype=mu.dtype, device=mu.device)
        z = eps * torch.exp(0.5 * logvar) + mu
        h = torch.relu(self.fc1(z))
        h = torch.relu(self.fc2(h))
        return self.fc3(h)


def loss_fn(model: _ActivityModel, batch: Dict[str, torch.Tensor],
            k_iwae: int, *, generator: Optional[torch.Generator] = None,
            eps=None, use_fused: bool = True):
    """(loss, accuracy) of one batch: the per-time-point cross entropy
    averaged over the samples and the time points, and the accuracy of the
    samples' mean logits, each a mean over the valid rows
    (batch["_mask"] [B])."""
    logits = model(batch["x"], batch["tp"], k_iwae, generator=generator,
                   eps=eps, use_fused=use_fused)
    logp = torch.log_softmax(logits, dim=-1)
    y = batch["y"]                                       # [B, L]
    ce = -torch.gather(logp, -1, y[None, ..., None].expand(
        logp.shape[:-1] + (1,)))[..., 0]                 # [k, B, L]
    bmask = batch["_mask"]
    nvalid = bmask.sum().clamp_min(1.0)
    loss = (ce.mean(dim=0).mean(dim=-1) * bmask).sum() / nvalid
    hit = (logits.mean(dim=0).argmax(-1) == y).to(logits.dtype)
    return loss, (hit.mean(dim=-1) * bmask).sum() / nvalid


def activity_splits(N: int, data_seed: int):
    """(train, val, test) row indices: a permutation by
    default_rng(data_seed), 20% test first, then 20% of the rest val."""
    perm = np.random.default_rng(data_seed).permutation(N)
    n_test = N - int(0.8 * N)
    n_val = int(0.8 * N) - int(0.8 * 0.8 * N)
    return (perm[n_test + n_val:], perm[n_test:n_test + n_val],
            perm[:n_test])


def warmup_lr(lr: float, total: int, step: int) -> float:
    """optax.linear_schedule(0, lr, total) at update count `step`."""
    frac = 1 - min(step, total) / total
    return (0.0 - lr) * frac + lr


def run_activity(cfg: ActivityConfig = ActivityConfig(), n: int = 512,
                 data: Optional[Dict] = None, device=None) -> ActivityResult:
    """Train the activity classifier for cfg.max_epochs epochs on
    synthetic_person_activity(n, data_seed), or on `data` (vals, mask, tp,
    labels); returns the metrics at the best-val-loss epoch. Runs on CUDA
    unless `device` says otherwise."""
    dev = resolve_device(device)
    if data is None:
        vals, mask, tp, labels = synthetic_person_activity(
            n=n, seed=cfg.data_seed)
    else:
        vals, mask, tp, labels = (data["vals"], data["mask"], data["tp"],
                                  data["labels"])
    N, L, D = vals.shape
    num_classes = int(labels.max()) + 1 if data is not None else NUM_CLASSES

    splits = tuple(zip(("train", "val", "test"),
                       activity_splits(N, cfg.data_seed)))
    x_all = np.concatenate([vals, mask], axis=-1).astype(np.float32)
    sets = {name: _to_device({"x": x_all[ix],
                              "tp": tp[ix].astype(np.float32),
                              "y": labels[ix].astype(np.int64)}, dev)
            for name, ix in splits}

    query = np.linspace(0.0, 1.0, L, dtype=np.float32)
    model = _ActivityModel(
        D, query, cfg.latent_dim, cfg.rec_hidden, cfg.embed_time,
        cfg.num_heads, num_classes, cfg.learn_emb,
        generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    n_params = sum(p.numel() for p in params)
    optimizer = torch.optim.Adam(params, lr=cfg.lr)
    n_train = len(splits[0][1])
    warmup = cfg.warmup_epochs * -(-n_train // cfg.batch_size)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def batches(name, perm, masks):
        for idx, bm in zip(perm, masks):
            it = torch.as_tensor(idx, dtype=torch.long, device=dev)
            batch = {k: v[it] for k, v in sets[name].items()}
            batch["_mask"] = torch.as_tensor(bm, device=dev)
            yield batch

    def evaluate(name):
        perm, masks, _ = padded_index_grid(
            np.arange(sets[name]["y"].shape[0]), cfg.batch_size)
        with torch.no_grad():
            out = torch.stack([torch.stack(loss_fn(model, b, cfg.k_iwae,
                                                   generator=gen))
                               for b in batches(name, perm, masks)])
        losses, accs = out.T.cpu().numpy()
        ns = masks.sum(axis=1)
        return (float((losses * ns).sum() / ns.sum()),
                float((accs * ns).sum() / ns.sum()))

    host_rng = np.random.default_rng(cfg.seed)
    best = {"val_loss": np.inf}
    history = []
    step = 0
    t0 = time.time()
    for epoch in range(cfg.max_epochs):
        perm, masks, _ = padded_index_grid(host_rng.permutation(n_train),
                                           cfg.batch_size)
        losses = []
        for batch in batches("train", perm, masks):
            if warmup > 0:
                for group in optimizer.param_groups:
                    group["lr"] = warmup_lr(cfg.lr, warmup, step)
            optimizer.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch, cfg.k_iwae, generator=gen)
            loss.backward()
            optimizer.step()
            step += 1
            losses.append(loss.detach())
        val_loss, val_acc = evaluate("val")
        rec = {"epoch": epoch,
               "train_loss": float(torch.stack(losses).mean()),
               "val_loss": val_loss, "val_acc": val_acc}
        if val_loss < best["val_loss"]:
            test_loss, test_acc = evaluate("test")
            best = {"val_loss": val_loss, "val_acc": val_acc,
                    "test_loss": test_loss, "test_acc": test_acc}
            rec.update(test_loss=test_loss, test_acc=test_acc)
        history.append(rec)
        if cfg.verbose:
            print(f"epoch {epoch}: val_loss {val_loss:.3f} "
                  f"val_acc {val_acc:.3f}", flush=True)

    return ActivityResult(
        test_accuracy=best.get("test_acc", 0.0),
        test_loss=best.get("test_loss", np.inf),
        val_accuracy=best.get("val_acc", 0.0),
        val_loss=best["val_loss"],
        history=history,
        wall_time=time.time() - t0,
        parameters=n_params,
    )
