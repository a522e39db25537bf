"""K seed replicas of a classifier trained at once (counterpart of
snsde/train/ensemble_loop.py:40-345).

The reference trains each of a cell's repeats in its own process on the
same data; they differ only in their initial weights and training noise.
Here the K members train together, their SDE solve one member-axis launch
(models/ensemble.py), while the policy stays per member and follows the
solo loop (train/loop.py):

  * the loss is each member's masked mean over the batch plus its L2 term,
    summed over members, so each member's gradients are its solo ones
    (their parameters are disjoint);
  * each member has its own Adam (coupled L2 decay lr0 x 0.01, fixed when
    its rate is cut, as optax's add_decayed_weights + adam), its own
    ReduceLROnPlateau rate, its own best-state snapshot and restore and its
    own plateau termination;
  * a terminated member freezes entirely while the others train on: its
    parameter update is masked to zero (its Adam state still advances, as
    the JAX loop's `upd * active[k]` after `tx.update`), and its BatchNorm
    running statistics are put back to their values before the step (the
    shared train-mode forward still moves them);
  * every member draws its noise (Brownian paths, dropout masks) from its
    own generator (`member_generators`), and the batch order is the JAX
    loop's (numpy, the config's seed).
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .loop import (FitResult, TrainConfig, _padded_grid, _to_device,
                   bce_with_logits_per_sample, clip_by_global_norm,
                   weight_regularization)
from .metrics import classification_metrics
from .schedule import ReduceLROnPlateau

__all__ = ["member_generators", "freeze_inactive_rest",
           "fit_classifier_ensemble", "ensemble_step"]


def member_generators(seed: int, K: int, device) -> List[torch.Generator]:
    """K generators on `device`, member k's seeded with the k-th of K
    64-bit seeds drawn by a CPU generator seeded with `seed`: the same
    members' noise on every device and run."""
    draw = torch.Generator().manual_seed(int(seed))
    seeds = torch.randint(0, 2 ** 62, (K,), generator=draw).tolist()
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def freeze_inactive_rest(model, active, before: Dict[int, Dict]) -> None:
    """Put back each inactive member's buffers (BatchNorm running
    statistics) to their values before the step (`before`: member ->
    name -> tensor, from `_buffers_of`), in place (ensemble_loop.py:40)."""
    with torch.no_grad():
        for k, bufs in before.items():
            if not active[k]:
                for name, b in model.member(k).named_buffers():
                    b.copy_(bufs[name])


def _buffers_of(model, k: int) -> Dict[str, torch.Tensor]:
    return {n: b.detach().clone() for n, b in model.member(k).named_buffers()}


def _per_member_loss(logits, y, mask, nc: int, pos_weight: float):
    """logits [K, B(, C)], y [B], mask [B] -> each member's masked mean
    [K]."""
    K = logits.shape[0]
    if nc == 2:
        per = bce_with_logits_per_sample(logits, y[None], pos_weight)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        per = -torch.gather(logp, -1,
                            y.long()[None, :, None].expand(K, -1, 1))[..., 0]
    m = mask.to(per.dtype)[None]
    return (per * m).sum(1) / m.sum(1).clamp_min(1.0)


def fit_classifier_ensemble(model, apply_fn: Callable,
                            train_data: Dict[str, np.ndarray],
                            val_data: Dict[str, np.ndarray],
                            test_data: Optional[Dict[str, np.ndarray]],
                            config: TrainConfig,
                            member_grad_hook: Optional[Callable] = None
                            ) -> List[FitResult]:
    """Train every member of an ensemble on the model's device.

    model: an nn.Module with n_members, member(k) (member k's modules:
    parameters and buffers) and member_reg(k) (the module its L2 term
    covers), e.g. models.ensemble.InitialValueSeedEnsemble.
    apply_fn(model, batch, generators) -> logits [K, B(, C)].
    member_grad_hook(member module) registers gradient hooks on one
    member's parameters (e.g. readout_grad_hook("readout.linear2"), the
    100x readout hook).

    Returns one FitResult per member; each result's `model` is the whole
    ensemble, every member restored to its own best-val state."""
    cfg = config
    nc, K = cfg.num_classes, model.n_members
    device = next(model.parameters()).device
    params = [[p for p in model.member(k).parameters() if p.requires_grad]
              for k in range(K)]
    opts = [torch.optim.Adam(ps, lr=cfg.lr,
                             weight_decay=cfg.lr * cfg.weight_decay_ratio)
            for ps in params]
    hooks = []
    if member_grad_hook is not None:
        for k in range(K):
            hooks += member_grad_hook(model.member(k))
    gens = member_generators(cfg.seed, K, device)

    def loss_fn(batch):
        logits = apply_fn(model, batch, gens)
        y = batch["y"]
        mask = batch.get("_mask", torch.ones_like(y, dtype=torch.float32))
        losses = _per_member_loss(logits, y, mask, nc, cfg.pos_weight)
        regs = torch.stack([weight_regularization(model.member_reg(k),
                                                  cfg.reg_scaling)
                            for k in range(K)])
        return losses + regs, logits

    dtrain = _to_device(train_data, device)
    resident = {id(train_data): dtrain}

    def evaluate(data):
        ddata = resident.setdefault(id(data), _to_device(data, device))
        n = next(iter(data.values())).shape[0]
        perm, masks = _padded_grid(np.arange(n), cfg.eval_batch_size
                                   or cfg.batch_size)
        model.eval()
        logits, losses = [], []
        with torch.no_grad():
            for idx, mask in zip(perm, masks):
                it = torch.as_tensor(idx, device=device)
                batch = {k: v[it] for k, v in ddata.items()}
                batch["_mask"] = torch.as_tensor(mask, device=device)
                ml, lo = loss_fn(batch)
                logits.append(lo)
                losses.append(ml)
        model.train()
        logits = torch.cat(logits, dim=1).cpu().numpy()      # [K, n', ...]
        losses = torch.stack(losses).cpu().numpy()           # [nb, K]
        n_valid = masks.sum(axis=1)
        valid = masks.reshape(-1) > 0
        y_true = np.asarray(data["y"])[perm.reshape(-1)[valid]]
        return [classification_metrics(
            y_true, logits[k][valid],
            float((losses[:, k] * n_valid).sum() / n_valid.sum()), nc)
            for k in range(K)]

    scheds = [ReduceLROnPlateau(
        lr=cfg.lr,
        mode="min" if cfg.step_mode in ("trainloss", "valloss") else "max",
        patience=cfg.plateau_patience) for _ in range(K)]
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    rng = np.random.default_rng(cfg.seed)
    lrs = np.full(K, cfg.lr, np.float64)
    active = np.ones(K, bool)
    n_train = next(iter(train_data.values())).shape[0]
    best_val_acc = np.full(K, -np.inf)
    best_state = [copy.deepcopy(model.member(k).state_dict())
                  for k in range(K)]
    best_train_loss = np.full(K, np.inf)
    best_train_acc = np.full(K, -np.inf)
    best_tl_epoch = np.zeros(K, int)
    best_ta_epoch = np.zeros(K, int)
    histories: List[List[Dict]] = [[] for _ in range(K)]
    n_steps = 0
    t_start = time.time()

    for epoch in range(cfg.max_epochs):
        perm, masks = _padded_grid(rng.permutation(n_train), cfg.batch_size)
        for idx, mask in zip(perm, masks):
            it = torch.as_tensor(idx, device=device)
            batch = {k: v[it] for k, v in dtrain.items()}
            batch["_mask"] = torch.as_tensor(mask, device=device)
            ensemble_step(model, opts, params, loss_fn, batch, active)
            n_steps += int(active.sum())

        train_ms = evaluate(train_data)
        val_ms = evaluate(val_data)
        for k in range(K):
            if not active[k]:
                histories[k].append(histories[k][-1])
                continue
            tm, vm = train_ms[k], val_ms[k]
            if tm.loss * 1.0001 < best_train_loss[k]:
                best_train_loss[k], best_tl_epoch[k] = tm.loss, epoch
            if tm.accuracy > best_train_acc[k] * 1.001:
                best_train_acc[k], best_ta_epoch[k] = tm.accuracy, epoch
            if vm.accuracy > best_val_acc[k]:
                best_val_acc[k] = vm.accuracy
                best_state[k] = copy.deepcopy(model.member(k).state_dict())
            metric = {"trainloss": tm.loss, "valloss": vm.loss,
                      "valaccuracy": vm.accuracy,
                      "valauc": (vm.auroc if vm.auroc is not None
                                 else vm.accuracy)}.get(cfg.step_mode)
            if metric is not None:
                lrs[k] = scheds[k].step(metric)
                for group in opts[k].param_groups:
                    group["lr"] = lrs[k]
            histories[k].append({"epoch": epoch, "lr": float(lrs[k]),
                                 "train": tm.as_dict(),
                                 "val": vm.as_dict()})
            if (epoch > best_tl_epoch[k] + cfg.plateau_terminate
                    or epoch > best_ta_epoch[k] + cfg.plateau_terminate):
                active[k] = False
        if cfg.verbose:
            accs = " ".join(f"{v.accuracy:.3f}" for v in val_ms)
            print(f"epoch {epoch}: val_acc [{accs}] active "
                  f"{int(active.sum())}/{K}", flush=True)
        if not active.any():
            if cfg.verbose:
                print("early stop: all members plateaued", flush=True)
            break

    wall = time.time() - t_start
    for h in hooks:
        h.remove()
    for k in range(K):
        model.member(k).load_state_dict(best_state[k])
    train_ms = evaluate(train_data)
    val_ms = evaluate(val_data)
    test_ms = evaluate(test_data) if test_data is not None else [None] * K
    return [FitResult(model=model, history=histories[k],
                      train_metrics=train_ms[k], val_metrics=val_ms[k],
                      test_metrics=test_ms[k], wall_time=wall,
                      steps_per_sec=n_steps / max(wall, 1e-9),
                      parameters=n_params // K)
            for k in range(K)]


def ensemble_step(model, opts, params, loss_fn, batch, active,
                  clip_norm: Optional[float] = None) -> None:
    """One update of every member in train mode: the summed per-member
    losses (loss_fn(batch) -> ([K] losses, logits)) backward, each
    member's gradients clipped to a global norm of `clip_norm` when it is
    given (optax's rule, a member's own norm), each member's optimizer
    step; an inactive member's parameters and buffers are put back
    afterwards (its optimizer state has advanced). No host
    synchronisation."""
    K = len(opts)
    model.train()
    for o in opts:
        o.zero_grad(set_to_none=True)
    frozen = [k for k in range(K) if not active[k]]
    before = {k: _buffers_of(model, k) for k in frozen}
    saved = {k: [p.detach().clone() for p in params[k]] for k in frozen}
    losses, _ = loss_fn(batch)
    losses.sum().backward()
    for k in range(K):
        for p in params[k]:
            if p.grad is None:      # on no path: zero, as optax moves it
                p.grad = torch.zeros_like(p)
        if clip_norm is not None:
            clip_by_global_norm(params[k], clip_norm)
        opts[k].step()
    with torch.no_grad():
        for k in frozen:
            for p, s in zip(params[k], saved[k]):
                p.copy_(s)
    freeze_inactive_rest(model, active, before)
