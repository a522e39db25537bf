"""Tracing, profiling and memory accounting (counterpart of
snsde/utils/observability.py).

  * `profile_trace(log_dir)` — a context manager around `torch.profiler`
    (CPU and, where present, CUDA activity), its Chrome trace written to
    `log_dir/trace.json` (open it in chrome://tracing or Perfetto);
  * `device_memory_stats()` / `memory_delta()` — each CUDA device's live,
    peak and total bytes, and the peak-memory delta across a block (the
    reference's reset_max_memory_allocated / max_memory_allocated pattern,
    which fills `memory_usage` in the results payloads);
  * `StepTimer` — per-step wall timing with a percentile summary;
  * `log_jsonl` — a structured event sink, one JSON object a line;
  * `seed_everything` — seeds Python's and numpy's generators and returns a
    `torch.Generator` where the JAX package returns a PRNGKey.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["profile_trace", "device_memory_stats", "memory_delta",
           "StepTimer", "log_jsonl", "seed_everything"]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile everything inside the block with torch.profiler and export
    its Chrome trace to log_dir/trace.json on exit. Yields the profiler
    (its `key_averages()` splits the time by op)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_devices(device=None) -> List[torch.device]:
    """`device` alone when it is a CUDA device, every CUDA device when it
    is None, none otherwise (the CPU keeps no allocator statistics)."""
    if not torch.cuda.is_available():
        return []
    if device is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    device = torch.device(device)
    if device.type != "cuda":
        return []
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return [torch.device("cuda", index)]


def device_memory_stats(device=None) -> Dict[str, Dict[str, int]]:
    """Bytes of each CUDA device (or of `device` alone): `bytes_in_use`
    (torch's memory_allocated), `peak_bytes_in_use` (max_memory_allocated
    since the last reset) and `bytes_limit` (the device's total memory).
    `{}` for the CPU, as the JAX package returns for a device without
    memory stats."""
    out = {}
    for d in _cuda_devices(device):
        out[str(d)] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(d)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_limit": int(torch.cuda.get_device_properties(d)
                               .total_memory),
        }
    return out


class memory_delta:
    """Context manager recording the peak-memory delta across the block
    (the reference's reset_max_memory_allocated / max_memory_allocated
    pattern, common_sde.py:250-279): on enter it synchronises, records the
    bytes in use and resets the peak; on exit `peak` is the peak bytes and
    `delta` the peak less the bytes in use on enter. Over every CUDA
    device, or `device` alone; 0 on the CPU."""

    def __init__(self, device=None):
        self.devices = _cuda_devices(device)

    def __enter__(self):
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.baseline = sum(int(torch.cuda.memory_allocated(d))
                            for d in self.devices)
        for d in self.devices:
            torch.cuda.reset_peak_memory_stats(d)
        return self

    def __exit__(self, *exc):
        self.peak = sum(int(torch.cuda.max_memory_allocated(d))
                        for d in self.devices)
        self.delta = max(self.peak - self.baseline, 0)
        return False


class StepTimer:
    """Wall time of each start()/stop() pair; summary() in milliseconds."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "steps": len(arr),
        }


def log_jsonl(path: str, record: Dict) -> None:
    """Append `record` (with a `ts` of time.time() unless it has one) to
    `path` as one JSON line."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    record = dict(record)
    record.setdefault("ts", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def seed_everything(seed: int) -> torch.Generator:
    """The reference's seed_everything (model_run.py:32-41) for the host
    side: seeds Python's `random` and numpy's global generator and sets
    PYTHONHASHSEED; returns a CPU torch.Generator seeded with `seed`, the
    port's explicit source of draws (where the JAX package returns a
    PRNGKey). torch's global generator is left alone: nothing in the port
    draws from it."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)
