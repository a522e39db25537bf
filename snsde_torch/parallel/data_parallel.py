"""The collectives of an exact data-parallel step.

The JAX package's sharded jit computes the single-device function: XLA
reduces BatchNorm's batch statistics, the loss and the gradients over the
whole batch. With one process a device the port must do the same by hand,
so that W ranks, each holding 1/W of every batch's rows, take the step one
process takes on the whole batch:

  * `shard_rows(mesh, rows)` marks the block in which this rank holds its
    rows of a global batch of `rows` (a no-op for one process, or when
    `rows` does not divide, where every rank holds the whole batch);
  * `draw_rows` draws noise of the global shape and keeps this rank's
    rows: every Brownian increment and dropout mask is the one the single
    process draws for that row (every rank's generator advances alike);
  * `BatchNorm` in training mode (`nn/layers.py`) takes its statistics over
    the global batch through `GlobalBatchNorm`, which all-reduces [sum,
    sum of squares, count] forward and [sum dy, sum dy x_hat] backward;
    torch's SyncBatchNorm refuses CPU tensors and needs an all-gather,
    which gloo does not give for CUDA tensors;
  * `all_reduce_grads` sums the gradients over the ranks (the loss divides
    by the global count of valid rows, and the L2 term enters on rank 0
    alone);
  * `gather_rows` and `sum_over_ranks` bring evaluation's logits and losses
    together through CPU copies (`all_gather_object`), in rank order.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["RowShard", "shard_rows", "active_shard", "sharded", "on_host",
           "draw_rows", "GlobalBatchNorm", "global_batch_norm",
           "all_reduce_grads", "gather_rows", "sum_over_ranks"]


@dataclass(frozen=True)
class RowShard:
    """Rows [start, stop) of a global batch of `total` rows, reduced over
    `group`."""

    start: int
    stop: int
    total: int
    group: object

    @property
    def rows(self) -> int:
        return self.stop - self.start


_SHARD: contextvars.ContextVar = contextvars.ContextVar("snsde_row_shard",
                                                        default=None)


def sharded(mesh, rows: int) -> bool:
    """Whether a global batch of `rows` is split over the mesh's ranks
    (more than one rank, and `rows` divides by their count)."""
    return (mesh is not None and mesh.group is not None and mesh.size > 1
            and rows % mesh.size == 0)


@contextlib.contextmanager
def shard_rows(mesh, rows: int):
    """Within the block this rank holds its rows of a global batch of
    `rows` (yields the RowShard, or None where the batch is whole on every
    rank)."""
    if not sharded(mesh, rows):
        yield None
        return
    k = rows // mesh.size
    token = _SHARD.set(RowShard(mesh.rank * k, (mesh.rank + 1) * k, rows,
                                mesh.group))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def active_shard() -> Optional[RowShard]:
    return _SHARD.get()


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              dim: int = 0) -> torch.Tensor:
    """draw(shape), where `shape[dim]` counts this rank's rows: inside a
    row shard the draw is of the global shape and this rank's rows of
    `dim` are kept."""
    s = _SHARD.get()
    shape = tuple(shape)
    if s is None:
        return draw(shape)
    if shape[dim] != s.rows:
        raise ValueError(f"a draw of shape {shape} inside a row shard of "
                         f"{s.rows} rows: dimension {dim} is not the batch")
    full = shape[:dim] + (s.total,) + shape[dim + 1:]
    return draw(full).narrow(dim, s.start, s.rows)


def on_host(collective: Callable[[torch.Tensor], None], t: torch.Tensor,
            group) -> torch.Tensor:
    """Run an in-place collective on t; a CUDA tensor goes through a CPU
    copy under gloo (whose CUDA paths stage through the host anyway)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        collective(host)
        t.copy_(host)
    else:
        collective(t)
    return t


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return on_host(lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                             group=group), t, group)


class GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation over the rows of every rank:
    x [n, C] or [n, C, L] (channel dim 1) -> (x - mean) / sqrt(var + eps)
    * weight + bias, with the mean and the biased variance of the global
    batch (accumulated in float64). Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = [d for d in range(x.dim()) if d != 1]
        C = x.shape[1]
        x64 = x.double()
        n = torch.full((1,), x.numel() // C, dtype=torch.float64,
                       device=x.device)
        stats = _all_reduce(torch.cat([x64.sum(dims), (x64 * x64).sum(dims),
                                       n]), group)
        count = stats[-1]
        mean = stats[:C] / count
        var = (stats[C:2 * C] / count - mean * mean).clamp_min(0.0)
        shape = [1, C] + [1] * (x.dim() - 2)
        invstd = torch.rsqrt(var + eps).to(x.dtype).reshape(shape)
        xhat = (x - mean.to(x.dtype).reshape(shape)) * invstd
        y = xhat
        if weight is not None:
            y = y * weight.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.dims, ctx.count = group, dims, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        dims, C = ctx.dims, xhat.shape[1]
        shape = [1, C] + [1] * (xhat.dim() - 2)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        g = _all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        n = ctx.count.to(dy.dtype)
        scale = invstd if weight is None else invstd * weight.reshape(shape)
        dx = scale * (dy - (g[:C] / n).reshape(shape)
                      - xhat * (g[C:] / n).reshape(shape))
        # this rank's parts of d weight and d bias: the gradient all-reduce
        # sums them
        dw = sum_dy_xhat if weight is not None else None
        db = sum_dy if weight is not None else None
        return dx, dw, db, None, None


def global_batch_norm(x: torch.Tensor, bn: torch.nn.modules.batchnorm._BatchNorm,
                      shard: RowShard) -> torch.Tensor:
    """`bn` in training mode over the global batch: the output, and the
    running statistics updated as torch's BatchNorm updates them (the
    unbiased variance, momentum or the cumulative average)."""
    y, mean, var = GlobalBatchNorm.apply(
        x, bn.weight if bn.affine else None, bn.bias if bn.affine else None,
        bn.eps, shard.group)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            f = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                 else bn.momentum)
            n = x.numel() // x.shape[1] * (shard.total // shard.rows)
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.mul_(1 - f).add_(f * mean.to(x.dtype))
            bn.running_var.mul_(1 - f).add_(f * unbiased.to(x.dtype))
    return y


def all_reduce_grads(params: Sequence[torch.Tensor], group) -> None:
    """Sum every parameter's .grad over the ranks, in place, through one
    flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _gather_objects(obj, group) -> List:
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_rows(local: np.ndarray, group, axis: int = 0) -> np.ndarray:
    """Every rank's rows of a host array, concatenated in rank order on
    `axis`."""
    return np.concatenate(_gather_objects(np.asarray(local), group),
                          axis=axis)


def sum_over_ranks(local: np.ndarray, group) -> np.ndarray:
    """The sum over ranks of a host array, added in rank order (the same
    bits on every rank)."""
    parts = _gather_objects(np.asarray(local), group)
    total = parts[0].copy()
    for p in parts[1:]:
        total = total + p
    return total
