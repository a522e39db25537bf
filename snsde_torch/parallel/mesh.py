"""The process mesh (counterpart of snsde/parallel/mesh.py) on
torch.distributed: one process a device.

The JAX package builds a `jax.sharding.Mesh` over the devices of one SPMD
program and lets XLA insert the collectives. Here every device has a
process of its own (rank r of a world of W), joined by a
`torch.distributed` process group, and the collectives are written out
(`parallel/data_parallel.py`). A `Mesh` holds the axis names and sizes,
the rank, the world size, the rank's device and the process group; with no
initialised group it is the single process, world size 1, and every
function below is the identity on it.

The JAX names keep their roles:
  * `batch_sharding(mesh, rows)` is the row slice this rank holds of a
    leading dimension of `rows` (JAX's NamedSharding(mesh, P('data'))),
    `slice(None)` when `rows` does not divide by the axis size;
  * `replicated(mesh)` is `slice(None)`: every rank holds every row (JAX's
    NamedSharding(mesh, P())); `replicate` makes it so for parameters and
    buffers by a broadcast from rank 0;
  * `shard_batch` keeps this rank's rows of each leaf. A leaf whose leading
    dimension does not divide by the axis size is kept whole on every rank,
    as the JAX package does (`snsde/parallel/mesh.py:68`, a known fault of
    the reference: the batch is silently replicated);
  * `init_multihost` is `torch.distributed.init_process_group`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated",
           "shard_batch", "replicate", "init_multihost",
           "local_device_count", "pad_to_multiple"]


@dataclass(frozen=True)
class Mesh:
    """This process's place in the mesh. `shape` maps each axis name to
    its size (JAX's `Mesh.shape`); their product is the world size."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def size(self) -> int:
        """Processes (devices) in the mesh."""
        return math.prod(self.shape.values())


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """The mesh over the initialised process group (world size and rank
    from torch.distributed), or over this process alone when there is no
    group. shape: per-axis sizes; None puts every process on the first
    axis. devices: one device for this rank, or a sequence of one device a
    rank (rank r takes devices[r]); None takes CUDA device r mod the local
    count, and raises without CUDA (pass devices="cpu")."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if shape is None:
        shape = [world] + [1] * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} over axes "
                         f"{tuple(axis_names)} does not hold {world} "
                         f"processes")
    if devices is None:
        resolve_device(None)                  # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
    else:
        dev = resolve_device(list(devices)[rank])
    return Mesh(tuple(axis_names), dict(zip(axis_names, map(int, shape))),
                rank, dev, dist.group.WORLD if grouped else None)


def batch_sharding(mesh: Mesh, rows: int, axis: str = "data") -> slice:
    """This rank's slice of a leading dimension of `rows` split over
    `axis`; every row (slice(None)) when `rows` does not divide."""
    n = mesh.shape[axis]
    if n <= 1 or rows % n != 0:
        return slice(None)
    k = rows // n
    i = mesh.rank % n
    return slice(i * k, (i + 1) * k)


def replicated(mesh: Mesh) -> slice:
    """Every row on every rank."""
    return slice(None)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """This rank's rows of every array or tensor leaf (dicts, lists and
    tuples are walked), each leaf keeping its type and device. A 0-d leaf,
    or one whose leading dimension does not divide by the axis size, is
    kept whole (replicated), as the JAX package's shard_batch."""

    def _rows(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        return x[batch_sharding(mesh, x.shape[0], axis)]

    return _map(_rows, tree)


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank: a module's parameters and buffers are
    broadcast in place (the module is returned), a tensor leaf is replaced
    by rank 0's (dicts, lists and tuples are walked). The identity for one
    process."""
    if mesh.group is None or mesh.size == 1:
        return tree
    from .data_parallel import on_host

    def bcast(t):
        on_host(lambda x: dist.broadcast(x, src=0, group=mesh.group), t,
                mesh.group)

    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                bcast(t.data)
        return tree

    def _bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        out = x.detach().clone().contiguous()
        bcast(out)
        return out

    return _map(_bcast, tree)


def pad_to_multiple(arr, multiple: int, axis: int = 0, value=0.0):
    """Pad `axis` up to a multiple (needed to shard uneven final batches).
    Returns (padded, original_length)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(np.asarray(arr), widths, constant_values=value), n


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Optional[str]:
    """Join the process group (torch.distributed.init_process_group); a
    no-op on a single process, as in the JAX package. `coordinator` is an
    init method, `tcp://host:port` or `file:///path` (a bare `host:port`
    is taken as tcp). The backend is nccl when CUDA is present and every
    rank can own a distinct local GPU (rank r takes cuda:r), gloo
    otherwise (two ranks on one card, where nccl refuses, or the CPU).
    Prints and returns the backend chosen."""
    if num_processes is None or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator is None:
        raise ValueError("init_multihost needs a coordinator address "
                         "(tcp://host:port or file:///path)")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    distinct = (torch.cuda.is_available()
                and torch.cuda.device_count() >= num_processes)
    backend = "nccl" if distinct else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    print(f"init_multihost: rank {process_id} of {num_processes}, backend "
          f"{backend}", flush=True)
    return backend


def local_device_count() -> int:
    """CUDA devices on this host, or 1 (the CPU) without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
