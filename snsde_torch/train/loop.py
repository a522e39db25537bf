"""Training loop and policy (counterpart of snsde/train/loop.py:48-110,
195-598).

Losses: BCE-with-logits for the binary heads, softmax cross-entropy for
the multiclass ones (Speech Commands, the robustness harness), and a
global-norm gradient clip with optax's rule (`clip_by_global_norm`).

  * loss = BCE-with-logits (pos_weight) for two classes, softmax
    cross-entropy for more, masked to the valid rows of the batch, plus
    0.01 x the sum of L2 norms of the vector field's parameters;
  * Adam with coupled L2 weight decay lr0 x 0.01 (`torch.optim.Adam`'s
    `weight_decay` adds wd*p to the gradient before the moments, and stays
    at its construction value when the rate is cut);
  * the 100x gradient hook on the readout's last linear fires during
    backward, before the weight decay, as the reference's register_hook;
  * ReduceLROnPlateau on the step metric, plateau-terminate after 50 stale
    epochs, and a restore of the best-val-accuracy state (parameters and
    BatchNorm buffers) at the end.

Two choices follow the JAX package, not torch habit:
  * a parameter that no path reaches (the NeuralSDE's initial_network when
    z0 comes from the static encoder) gets a zero gradient, so weight decay
    and Adam still move it, as optax does; `torch.optim.Adam` would skip a
    parameter whose grad is None;
  * the last partial batch is padded by wrap-around to the full batch and
    the padded rows are masked out of the loss; BatchNorm's batch
    statistics still see the duplicates.

`fit_classifier(mesh=)` trains data-parallel, one process a device (the
JAX package's mesh path, snsde/train/loop.py:247-369): every rank holds
the datasets, takes its rows of each global batch (`shard_batch`), and
takes the step one process takes on the whole batch: BatchNorm's
statistics, the noise, the loss's count of valid rows and the gradients
are global (`parallel/data_parallel.py`), the L2 term enters on rank 0
alone, and evaluation gathers the logits in rank order. Every rank ends
with the same weights and metrics. A batch size that does not divide by
the world size is not split: every rank takes the whole batch (the JAX
package replicates it, `snsde/parallel/mesh.py:68`).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import data_parallel as dp
from ..parallel.mesh import replicate, shard_batch
from ..utils.observability import memory_delta
from .metrics import ClassificationMetrics, classification_metrics
from .schedule import ReduceLROnPlateau

__all__ = ["bce_with_logits", "bce_with_logits_per_sample",
           "softmax_cross_entropy", "softmax_cross_entropy_per_sample",
           "clip_by_global_norm",
           "weight_regularization", "readout_grad_hook", "TrainConfig",
           "FitResult", "make_loss_fn", "make_optimizer", "train_step",
           "fit_classifier", "padded_index_grid", "rank_batch"]


def bce_with_logits_per_sample(logits, labels, pos_weight: float = 1.0):
    """torch BCEWithLogitsLoss(pos_weight, reduction='none')."""
    labels = labels.to(logits.dtype)
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def bce_with_logits(logits, labels, pos_weight: float = 1.0):
    return bce_with_logits_per_sample(logits, labels, pos_weight).mean()


def softmax_cross_entropy_per_sample(logits, labels):
    """Per-sample cross entropy; labels are int class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def softmax_cross_entropy(logits, labels):
    """Mean cross entropy; labels are int class ids."""
    return softmax_cross_entropy_per_sample(logits, labels).mean()


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the parameters' .grad, in place: when
    the global L2 norm of all gradients is at least max_norm, every
    gradient becomes g / norm * max_norm (torch's clip_grad_norm_ divides
    by norm + 1e-6 instead). Runs on the device, with no host
    synchronisation; returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def weight_regularization(module: torch.nn.Module, scaling: float = 0.01):
    """scaling x sum of ||p||_2 over the module's trainable parameters."""
    return scaling * sum(torch.linalg.vector_norm(p.reshape(-1))
                         for p in module.parameters() if p.requires_grad)


def readout_grad_hook(attr_path: str, scale: float = 100.0) -> Callable:
    """A function model -> hook handles that scales the gradient of every
    parameter under `attr_path` (e.g. "sde.readout.linear2") by `scale`
    as backward computes it."""

    def register(model: torch.nn.Module):
        sub = model.get_submodule(attr_path)
        return [p.register_hook(lambda g: g * scale)
                for p in sub.parameters()]

    return register


@dataclass
class TrainConfig:
    lr: float = 1e-3
    batch_size: int = 1024
    max_epochs: int = 200
    num_classes: int = 2
    pos_weight: float = 1.0
    step_mode: str = "valauc"   # trainloss|valloss|valaccuracy|valauc|none
    plateau_patience: int = 5
    plateau_terminate: int = 50
    reg_scaling: float = 0.01
    weight_decay_ratio: float = 0.01   # wd = lr * ratio
    eval_batch_size: Optional[int] = None
    seed: int = 0
    verbose: bool = True


@dataclass
class FitResult:
    model: Any
    history: List[Dict]
    train_metrics: ClassificationMetrics
    val_metrics: ClassificationMetrics
    test_metrics: Optional[ClassificationMetrics]
    wall_time: float
    steps_per_sec: float
    memory_usage: Optional[int] = None      # peak device bytes delta
    parameters: Optional[int] = None


def make_loss_fn(apply_fn: Callable, reg_subtree_fn: Callable,
                 config: TrainConfig) -> Callable:
    """(model, batch, generator) -> (loss, logits). apply_fn(model, batch,
    generator) -> logits: [B] for the binary head (BCE with pos_weight),
    [B, num_classes] otherwise (softmax cross-entropy), as the JAX loop's
    per-sample loss (snsde/train/loop.py:276-291); batch["_mask"] marks
    the valid rows of either. Under data parallelism batch["_count"] is the
    global batch's count of valid rows (the divisor of the masked mean)
    and batch["_reg"] is False on every rank but rank 0, so the L2 term
    enters the summed loss and gradients once."""
    if config.num_classes == 2:
        per_sample = lambda lo, y: bce_with_logits_per_sample(
            lo, y, config.pos_weight)
    else:
        per_sample = softmax_cross_entropy_per_sample

    def loss_fn(model, batch, generator):
        logits = apply_fn(model, batch, generator)
        per = per_sample(logits, batch["y"])
        mask = batch.get("_mask")
        count = batch.get("_count")
        if mask is None:
            loss = per.mean()
        elif count is None:
            loss = (per * mask).sum() / mask.sum().clamp_min(1.0)
        else:
            loss = (per * mask).sum() / count
        if not batch.get("_reg", True):
            return loss, logits
        reg = weight_regularization(reg_subtree_fn(model),
                                    config.reg_scaling)
        return loss + reg, logits

    return loss_fn


def make_optimizer(model: torch.nn.Module,
                   config: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=config.lr,
                            weight_decay=config.lr * config.weight_decay_ratio)


def train_step(model, optimizer, loss_fn, batch, generator,
               clip_norm: Optional[float] = None,
               grad_group=None) -> torch.Tensor:
    """One optimizer update in train mode, the gradients clipped to a
    global norm of `clip_norm` (optax's rule) when it is given; returns the
    loss (no host synchronisation). With `grad_group` (a process group),
    the gradients are summed over its ranks before the clip and the
    update."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, generator)
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_group is not None:
        dp.all_reduce_grads(params, grad_group)
    if clip_norm is not None:
        clip_by_global_norm(params, clip_norm)
    optimizer.step()
    return loss.detach()


def iterate_batches(arrays: Dict[str, Any], batch_size: int,
                    rng: Optional[np.random.Generator] = None,
                    pad: bool = True):
    """Yield (batch_dict, n_valid) over arrays (numpy arrays or tensors,
    indexed by a numpy index vector), shuffled by `rng` when given. The
    final batch is padded by wrap-around to the full batch size, so every
    step sees the same shapes."""
    n = next(iter(arrays.values())).shape[0]
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        sel = idx[start:start + batch_size]
        n_valid = sel.shape[0]
        if pad and n_valid < batch_size:
            extra = idx[:batch_size - n_valid]
            if extra.shape[0] < batch_size - n_valid:  # tiny dataset
                extra = np.resize(idx, batch_size - n_valid)
            sel = np.concatenate([sel, extra])
        yield {k: v[sel] for k, v in arrays.items()}, n_valid


def padded_index_grid(idx, batch_size: int):
    """Pad a 1-D index vector by wrap-around to a [nb, batch_size] grid
    (np.resize covers a pad longer than the vector), the JAX package's
    padded_index_grid (snsde/train/loop.py:117-135): (perm [nb, B] int32,
    mask [nb, B] float32 with the padded tail zeroed, nb)."""
    idx = np.asarray(idx)
    n = idx.shape[0]
    nb = max(1, -(-n // batch_size))
    pad = nb * batch_size - n
    mask = np.ones(nb * batch_size, np.float32)
    if pad:
        idx = np.concatenate([idx, np.resize(idx, pad)])
        mask[-pad:] = 0.0
    return (idx.reshape(nb, batch_size).astype(np.int32),
            mask.reshape(nb, batch_size), nb)


def _padded_grid(idx: np.ndarray, batch_size: int):
    """(perm, mask) of padded_index_grid."""
    return padded_index_grid(idx, batch_size)[:2]


def rank_batch(ddata: Dict[str, torch.Tensor], idx: np.ndarray,
               mask: np.ndarray, mesh=None) -> Dict[str, torch.Tensor]:
    """The rows of one padded global batch (`idx`, `mask`: [B]) that this
    rank takes, gathered from the device-resident `ddata`, with its
    "_mask". Where the mesh splits the batch (`data_parallel.sharded`) the
    batch also carries "_count", the global count of valid rows, and
    "_reg", True on rank 0 alone (make_loss_fn); run the step inside
    `data_parallel.shard_rows(mesh, len(idx))`."""
    device = next(iter(ddata.values())).device
    split = dp.sharded(mesh, len(idx))
    rows, part = (shard_batch((idx, mask), mesh, mesh.axis_names[0])
                  if split else (idx, mask))
    batch = {k: v[torch.as_tensor(rows, device=device)]
             for k, v in ddata.items()}
    batch["_mask"] = torch.as_tensor(part, device=device)
    if split:
        batch["_count"] = torch.as_tensor(max(float(mask.sum()), 1.0),
                                          dtype=torch.float32, device=device)
        batch["_reg"] = mesh.rank == 0
    return batch


def _to_device(data: Dict[str, np.ndarray], device) -> Dict:
    """Integer arrays as int64, the rest as float32, on `device`."""
    return {k: torch.as_tensor(
        v, device=device,
        dtype=torch.long if np.issubdtype(np.asarray(v).dtype, np.integer)
        else torch.float32) for k, v in data.items()}


def fit_classifier(model: torch.nn.Module, apply_fn: Callable,
                   reg_subtree_fn: Callable,
                   train_data: Dict[str, np.ndarray],
                   val_data: Dict[str, np.ndarray],
                   test_data: Optional[Dict[str, np.ndarray]],
                   config: TrainConfig, mesh=None,
                   grad_hook: Optional[Callable] = None) -> FitResult:
    """Classification fit on the model's device (binary or multiclass by
    config.num_classes).

    apply_fn(model, batch, generator) -> logits [B] (binary) or [B, C];
    `reg_subtree_fn(model)`
    is the module to L2-regularise; `grad_hook(model)` registers gradient
    hooks (see readout_grad_hook). The datasets are numpy dicts uploaded to
    the device once; the Brownian increments and dropout masks come from a
    torch.Generator seeded with config.seed, the batch order from a numpy
    generator with the same seed (the JAX package's order).

    mesh: a `parallel.Mesh` to train data-parallel over its ranks (every
    rank calls fit_classifier with the same arguments, the model on the
    mesh's device; rank 0's weights are broadcast first), or None for one
    process."""
    cfg = config
    device = next(model.parameters()).device
    dp_group = mesh.group if mesh is not None and mesh.size > 1 else None
    if dp_group is not None:
        replicate(model, mesh)
    loss_fn = make_loss_fn(apply_fn, reg_subtree_fn, cfg)
    optimizer = make_optimizer(model, cfg)
    hooks = grad_hook(model) if grad_hook is not None else []
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    dtrain = _to_device(train_data, device)
    resident = {id(train_data): dtrain}
    ebs = cfg.eval_batch_size or cfg.batch_size
    split_train = dp.sharded(mesh, cfg.batch_size)
    split_eval = dp.sharded(mesh, ebs)
    verbose = cfg.verbose and (mesh is None or mesh.rank == 0)

    def evaluate(data) -> ClassificationMetrics:
        ddata = resident.setdefault(id(data), _to_device(data, device))
        n = next(iter(data.values())).shape[0]
        perm, masks = _padded_grid(np.arange(n), ebs)
        model.eval()
        logits, losses = [], []
        with torch.no_grad():
            for idx, mask in zip(perm, masks):
                with dp.shard_rows(mesh, ebs):
                    loss, lo = loss_fn(model, rank_batch(ddata, idx, mask,
                                                         mesh), generator)
                logits.append(lo)
                losses.append(loss)
        model.train()
        logits = torch.stack(logits).cpu().numpy()
        losses = torch.stack(losses).cpu().numpy()
        if split_eval:
            logits = dp.gather_rows(logits, dp_group, axis=1)
            losses = dp.sum_over_ranks(losses, dp_group)
        logits = logits.reshape((-1,) + logits.shape[2:])
        n_valid = masks.sum(axis=1)
        loss = float((losses * n_valid).sum() / n_valid.sum())
        valid = masks.reshape(-1) > 0
        return classification_metrics(
            np.asarray(data["y"])[perm.reshape(-1)[valid]], logits[valid],
            loss, cfg.num_classes)

    sched = ReduceLROnPlateau(
        lr=cfg.lr,
        mode="min" if cfg.step_mode in ("trainloss", "valloss") else "max",
        patience=cfg.plateau_patience,
    )
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    on_cuda = device.type == "cuda"
    mem = memory_delta(device).__enter__()
    lr = cfg.lr
    n_train = next(iter(train_data.values())).shape[0]
    best_val_acc = -np.inf
    best_state = copy.deepcopy(model.state_dict())
    best_train_loss = np.inf
    best_train_acc = -np.inf
    best_train_loss_epoch = best_train_acc_epoch = 0
    history: List[Dict] = []
    n_steps = 0
    t_start = time.time()

    for epoch in range(cfg.max_epochs):
        perm, masks = _padded_grid(rng.permutation(n_train), cfg.batch_size)
        for idx, mask in zip(perm, masks):
            with dp.shard_rows(mesh, cfg.batch_size):
                train_step(model, optimizer, loss_fn,
                           rank_batch(dtrain, idx, mask, mesh), generator,
                           grad_group=dp_group if split_train else None)
            n_steps += 1

        train_m = evaluate(train_data)
        val_m = evaluate(val_data)
        if train_m.loss * 1.0001 < best_train_loss:
            best_train_loss = train_m.loss
            best_train_loss_epoch = epoch
        if train_m.accuracy > best_train_acc * 1.001:
            best_train_acc = train_m.accuracy
            best_train_acc_epoch = epoch
        if val_m.accuracy > best_val_acc:
            best_val_acc = val_m.accuracy
            best_state = copy.deepcopy(model.state_dict())

        metric = {
            "trainloss": train_m.loss,
            "valloss": val_m.loss,
            "valaccuracy": val_m.accuracy,
            "valauc": (val_m.auroc if val_m.auroc is not None
                       else val_m.accuracy),
        }.get(cfg.step_mode)
        if metric is not None:
            lr = sched.step(metric)
            for group in optimizer.param_groups:
                group["lr"] = lr

        history.append({"epoch": epoch, "lr": lr,
                        "train": train_m.as_dict(), "val": val_m.as_dict()})
        if verbose:
            auc = (f" train_auc {train_m.auroc:.3f} val_auc "
                   f"{val_m.auroc:.3f}" if train_m.auroc is not None else "")
            print(f"epoch {epoch}: train_loss {train_m.loss:.3f} "
                  f"train_acc {train_m.accuracy:.3f} val_loss "
                  f"{val_m.loss:.3f} val_acc {val_m.accuracy:.3f}{auc} "
                  f"lr {lr:.2e}", flush=True)
        if (epoch > best_train_loss_epoch + cfg.plateau_terminate
                or epoch > best_train_acc_epoch + cfg.plateau_terminate):
            if verbose:
                print("early stop: training plateau", flush=True)
            break

    wall = time.time() - t_start
    mem.__exit__(None, None, None)
    for h in hooks:
        h.remove()
    model.load_state_dict(best_state)
    train_m = evaluate(train_data)
    val_m = evaluate(val_data)
    test_m = evaluate(test_data) if test_data is not None else None
    return FitResult(model=model, history=history, train_metrics=train_m,
                     val_metrics=val_m, test_metrics=test_m, wall_time=wall,
                     steps_per_sec=n_steps / max(wall, 1e-9),
                     memory_usage=mem.delta if on_cuda else None,
                     parameters=n_params)
