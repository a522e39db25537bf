"""The port's tracing, profiling and memory accounting
(snsde_torch/utils/observability.py) on the CPU, against the JAX package's
snsde/utils/observability.py where the two share semantics: StepTimer's
summary, log_jsonl's records and seed_everything's host seeding."""

import torch_threads  # noqa: F401  (one intra-op thread)

import json
import os
import random
import time

import numpy as np
import pytest
import torch

import snsde.utils.observability as jax_obs
from snsde_torch.harness.classification import HarnessConfig, run_sepsis
from snsde_torch.utils import (StepTimer, device_memory_stats, log_jsonl,
                               memory_delta, profile_trace, seed_everything)


def test_device_memory_stats_empty_without_cuda():
    assert device_memory_stats() == {}
    assert device_memory_stats("cpu") == {}


def test_memory_delta_is_zero_on_the_cpu():
    with memory_delta() as mem:
        x = torch.ones(1000)
    assert x.sum() == 1000
    assert (mem.baseline, mem.peak, mem.delta) == (0, 0, 0)


def test_memory_delta_on_a_stubbed_cuda_allocator(monkeypatch):
    """On a CUDA device: the bytes in use on enter, the peak reset on enter
    and read on exit, their difference clamped at 0 (the pattern the fit
    used inline: snsde_torch/train/loop.py's memory_usage)."""
    state = {"alloc": 300, "peak": 900, "resets": 0}
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(cuda, "memory_allocated", lambda d: state["alloc"])
    monkeypatch.setattr(cuda, "max_memory_allocated", lambda d: state["peak"])

    def reset(d):
        state["resets"] += 1
        state["peak"] = state["alloc"]

    monkeypatch.setattr(cuda, "reset_peak_memory_stats", reset)
    with memory_delta("cuda:0") as mem:
        state["peak"] = 1300
    assert state["resets"] == 1
    assert (mem.baseline, mem.peak, mem.delta) == (300, 1300, 1000)
    with memory_delta("cuda:0") as mem:
        pass
    assert mem.delta == 0
    assert memory_delta("cpu").devices == []


def test_step_timer_summary_matches_jax():
    ours, theirs = StepTimer(), jax_obs.StepTimer()
    assert ours.summary() == theirs.summary() == {}
    ours.stop()                                 # stop before start: nothing
    for _ in range(5):
        ours.start()
        time.sleep(0.001)
        ours.stop()
    theirs.times = list(ours.times)
    got, ref = ours.summary(), theirs.summary()
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == pytest.approx(ref[k])
    assert got["steps"] == 5 and got["p50_ms"] >= 1.0


def test_log_jsonl_matches_jax(tmp_path):
    ours, theirs = tmp_path / "a" / "log.jsonl", tmp_path / "b" / "log.jsonl"
    for rec in ({"step": 1, "loss": 0.5}, {"step": 2, "ts": 7.0}):
        log_jsonl(str(ours), rec)
        jax_obs.log_jsonl(str(theirs), rec)
    a = [json.loads(l) for l in ours.read_text().splitlines()]
    b = [json.loads(l) for l in theirs.read_text().splitlines()]
    assert [r.keys() for r in a] == [r.keys() for r in b]
    assert a[1] == b[1] == {"step": 2, "ts": 7.0}
    assert a[0]["step"] == 1 and isinstance(a[0]["ts"], float)


def test_seed_everything_seeds_the_host_as_jax_does():
    gen = seed_everything(11)
    ours = (random.random(), np.random.rand())
    env = os.environ["PYTHONHASHSEED"]
    jax_obs.seed_everything(11)
    assert ours == (random.random(), np.random.rand())
    assert env == os.environ["PYTHONHASHSEED"] == "11"
    assert isinstance(gen, torch.Generator)
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=seed_everything(11)))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert any("mm" in e.key for e in prof.key_averages())


def test_fit_reports_no_memory_on_the_cpu():
    res = run_sepsis(HarnessConfig(hidden_channels=4,
                                   hidden_hidden_channels=4,
                                   num_hidden_layers=1, batch_size=32),
                     n=64, max_epochs=1, device="cpu")
    assert res.memory_usage is None
