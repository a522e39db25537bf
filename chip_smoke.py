#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snsde_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card: name, and name and power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the main path from
     snsde_torch/csrc/ (sm_90a), with the build seconds and ptxas report;
  3. kernels vs their plain PyTorch versions on the card, on the same
     inputs, at the main-path shape (B=1024, L=72, C=69, H=HH=49, two
     hidden layers, neurallnsde (4,17)), then (2,16) and (6,17) at B=128:
     the trajectory and every backward output, within stated tolerances;
  4. main path: the sepsis harness `run_sepsis` (neurallnsde, H=49, batch
     1024, C=69) on synthetic_sepsis(n=4096) for 2 epochs; the losses must
     be finite and both kernels must have been launched by that run; the
     trained model's fused solve must match the eager solver on a small
     batch with the same Brownian increments;
  5. times (CUDA events, median of 30 after warm-up): each kernel and its
     plain version, and one full training step (forward + backward + Adam)
     through the kernels and through the eager solver; a torch.profiler
     window of the kernel step gives device time by kernel and the
     device's busy share.
It prints one JSON line of the kernels, the card's name and power limit,
and last `{"ok": true, "device": {...}}`. It exits non-zero, printing no
result, without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
MAIN = dict(B=1024, L=72, C=69, H=49, layers=2, model="neurallnsde")
TOL_YS = 5e-5       # max abs error of the trajectory (measured 2.4e-5)
TOL_GRAD = 1e-5     # max abs error of a cotangent over its max (measured 1.1e-6)
REPS, WARMUP = 30, 5
N_SEPSIS = 4096     # samples of synthetic_sepsis on the main path
DEV = "cuda"


def card() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {name} | nvidia-smi: {smi}", flush=True)
    return smi


def build():
    from snsde_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(["fused_em"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")


def kernel_inputs(model_name, B, L, C, H, layers, seed=0):
    """Detached kernel inputs of a random field on a random control path,
    with Brownian increments from numpy, on the card."""
    from snsde_torch.harness.classification import make_sde_model
    from snsde_torch.kernels.fused_em import fused_em_inputs
    from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    sde, _ = make_sde_model(model_name, C, H, H, layers, 1, generator=gen)
    field = sde.func.to(DEV)
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times), x).to(DEV),
                     times)
    grid, _ = make_grid(times, 1.0)
    M = grid.shape[0] - 1
    dW = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32))
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    with torch.no_grad():
        inp = fused_em_inputs(field.bind(path), path, grid, y0, dW.to(DEV))
    inp = {k: (v.detach().contiguous() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    # the cotangent of a batch-mean loss: O(1/B) per entry
    gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32) / B)
    return inp, gys.to(DEV)


def _split(inp):
    flags = dict(mult_y=inp["mult_y"], geometric=inp["geometric"])
    fwd = [inp[k] for k in ("y0", "xh", "dw", "a", "gk", "dts", "theta",
                            "wy", "w_inner", "b_inner", "wout", "bo")]
    return fwd, flags


def compare(model_name, B, L, C, H, layers):
    """Kernel vs plain version on the same inputs; returns max abs errors
    of the forward and the backward (over all its outputs)."""
    from snsde_torch.kernels import fused_em as fe

    inp, gys = kernel_inputs(model_name, B, L, C, H, layers)
    fwd, flags = _split(inp)
    ys_k = fe.fused_em_forward(*fwd, **flags)
    ys_p = fe.fused_em_forward_reference(*fwd, **flags)
    bwd_args = [fwd[0], ys_p, gys] + fwd[1:]
    g_k = fe.fused_em_backward(*bwd_args, **flags)
    g_p = fe.fused_em_backward_reference(*bwd_args, **flags)
    torch.cuda.synchronize()
    err_f = float((ys_k - ys_p).abs().max())
    print(f"  {model_name} B={B}: ys max abs err {err_f:.3e} "
          f"(tol {TOL_YS:g})")
    if not err_f <= TOL_YS:
        raise AssertionError(f"forward kernel disagrees: {err_f}")
    err_b = 0.0
    for name, a, b in zip(g_k._fields, g_k, g_p):
        if b.numel() == 0:
            continue
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        err_b = max(err_b, err)
        print(f"    d{name[1:]:9s} max abs err {err:.3e} rel {rel:.3e} "
              f"(tol rel {TOL_GRAD:g})")
        if not rel <= TOL_GRAD:
            raise AssertionError(f"backward kernel disagrees on {name}")
    return err_f, err_b


def main_config():
    from snsde_torch.harness.classification import HarnessConfig

    return HarnessConfig(model_name=MAIN["model"], hidden_channels=MAIN["H"],
                         hidden_hidden_channels=MAIN["H"],
                         num_hidden_layers=MAIN["layers"],
                         batch_size=MAIN["B"])


def main_path():
    from snsde_torch.harness.classification import run_sepsis
    from snsde_torch.kernels import fused_em as fe

    cfg = main_config()
    fe.FWD_LAUNCHES = fe.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_sepsis(cfg, n=N_SEPSIS, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = {"fwd": fe.FWD_LAUNCHES, "bwd": fe.BWD_LAUNCHES}
    wall = time.perf_counter() - t0
    losses = [h[s]["loss"] for h in res.history for s in ("train", "val")]
    losses += [res.train_metrics.loss, res.val_metrics.loss,
               res.test_metrics.loss]
    print(f"main path: run_sepsis 2 epochs in {wall:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, val AUROC "
          f"{res.val_metrics.auroc:.4f}, test AUROC "
          f"{res.test_metrics.auroc:.4f}, launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss on the main path")
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise AssertionError(f"main path did not run the kernels: {launches}")
    check_trained_solve(res.model)
    return launches


def check_trained_solve(model, B=64):
    """The trained model's fused solve vs the eager solver, same dW."""
    from snsde_torch.kernels.fused_em import fused_em_solve
    from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                                 make_grid, sdeint)

    rng = np.random.default_rng(1)
    L, C, H = MAIN["L"], MAIN["C"], MAIN["H"]
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times), x).to(DEV),
                     times)
    grid, _ = make_grid(times, 1.0)
    dW = torch.as_tensor(rng.normal(size=(len(grid) - 1, B, H))
                         .astype(np.float32)).to(DEV)
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    field = model.sde.func.bind(path)
    with torch.no_grad():
        ys_f = fused_em_solve(field, path, times, y0, dt=1.0, dW_override=dW)
        ys_e = sdeint(field.f, field.g, y0, times, bm=BrownianGrid(grid, dW))
    err = float((ys_f - ys_e).abs().max())
    print(f"trained model: fused vs eager solve, B={B}: shape "
          f"{tuple(ys_f.shape)}, max abs err {err:.3e} (tol {TOL_YS:g})")
    if not (torch.isfinite(ys_f).all() and err <= TOL_YS):
        raise AssertionError("trained model's fused solve disagrees")


def timed(fn) -> float:
    """Median ms of fn() over REPS runs after WARMUP, by CUDA events."""
    for _ in range(WARMUP):
        fn()
    out = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def times_and_bounds():
    from snsde_torch.kernels import fused_em as fe

    inp, gys = kernel_inputs(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"],
                             MAIN["H"], MAIN["layers"])
    fwd, flags = _split(inp)
    ys = fe.fused_em_forward(*fwd, **flags)
    bwd_args = [fwd[0], ys, gys] + fwd[1:]
    ms = {
        "fwd": timed(lambda: fe.fused_em_forward(*fwd, **flags)),
        "fwd_plain": timed(lambda: fe.fused_em_forward_reference(*fwd,
                                                                 **flags)),
        "bwd": timed(lambda: fe.fused_em_backward(*bwd_args, **flags)),
        "bwd_plain": timed(lambda: fe.fused_em_backward_reference(*bwd_args,
                                                                  **flags)),
    }
    M, B, H = ys.shape
    HH = fwd[7].shape[1]
    n_inner = fwd[8].shape[0]
    products = 2 * M * B * (H * HH + n_inner * HH * HH + HH * H)
    nbytes_in = 4 * sum(t.numel() for t in fwd)
    grads = fe.fused_em_backward(*bwd_args, **flags)
    b_fwd = bound(nbytes_in + 4 * ys.numel(), products)
    b_bwd = bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                   + sum(g.numel() for g in grads)),
                  3 * products)
    ms.update(train_step_times())
    return ms, {"fwd": b_fwd, "bwd": b_bwd}


def train_step_times():
    """One training step of the main-path model on one batch of 1024
    sepsis-shaped samples: through the kernels, and through the eager
    solver on the same card."""
    from snsde_torch.data import preprocess_classification, synthetic_sepsis
    from snsde_torch.harness.classification import build_sepsis_model
    from snsde_torch.train.loop import (TrainConfig, make_loss_fn,
                                        make_optimizer, readout_grad_hook,
                                        train_step)

    cfg = main_config()
    X, static, y, lengths, _ = synthetic_sepsis(n=MAIN["B"],
                                                length=MAIN["L"], seed=0)
    data = preprocess_classification(X, y, lengths, use_intensity=True,
                                     times=np.arange(MAIN["L"],
                                                     dtype=np.float32))
    times = data["times"]
    dev = torch.device(DEV)
    batch = {"coeffs": np.concatenate([data[s]["coeffs"] for s in
                                       ("train", "val", "test")]),
             "final_index": np.concatenate([data[s]["final_index"] for s in
                                            ("train", "val", "test")]),
             "y": np.concatenate([data[s]["y"] for s in
                                  ("train", "val", "test")])}
    batch = {"coeffs": torch.as_tensor(batch["coeffs"], device=dev),
             "final_index": torch.as_tensor(batch["final_index"], device=dev),
             "y": torch.as_tensor(batch["y"], dtype=torch.float32,
                                  device=dev),
             "static": torch.as_tensor(static, device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = build_sepsis_model(cfg, data["input_channels"],
                                   static.shape[-1], dev)
        tc = TrainConfig(pos_weight=10.0)
        hooks = readout_grad_hook("sde.readout.linear2")(model)

        def apply_fn(m, b, g, fused=fused):
            return m(times, b["coeffs"], b["static"], b["final_index"],
                     generator=g, use_fused=fused)[..., 0]

        loss_fn = make_loss_fn(apply_fn, lambda m: m.sde.func, tc)
        opt = make_optimizer(model, tc)
        gen = torch.Generator(device=dev).manual_seed(0)
        step = lambda: train_step(model, opt, loss_fn, batch, gen)
        out[label] = timed(step)
        if fused:
            profile_step(step)
        for h in hooks:
            h.remove()
    return out


def profile_step(step, n=5):
    """Where one training step's time goes: device time by kernel over n
    steps (torch.profiler), and the device's busy share of the window (the
    profiler's own host cost inflates the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(n):
            step()
        b.record()
        b.synchronize()
    wall = a.elapsed_time(b) / n
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3 / n)
    busy = sum(by_name.values())
    print(f"profile of one train step (mean of {n}): {wall:.3f} ms wall, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:8.4f} ms {100 * ms / wall:5.1f}%  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import snsde_torch  # noqa: F401  (fails outside the repository)

    smi = card()
    build()
    print("kernels vs plain versions:", flush=True)
    err = compare(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"],
                  MAIN["layers"])
    for name in ("neurallsde", "neuralgsde"):
        compare(name, 128, MAIN["L"], MAIN["C"], MAIN["H"], MAIN["layers"])
    launches = main_path()
    ms, bounds = times_and_bounds()
    for k, v in ms.items():
        print(f"time {k}: {v:.4f} ms  [{smi}]")
    kernels = []
    for key, name, line in (("fwd", "fused_em_forward", 688),
                            ("bwd", "fused_em_backward", 888)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "snsde_torch/csrc/fused_em.cu",
            "replaces": f"snsde/kernels/fused_em.py:{line}",
            "launches": launches[key],
            "max_abs_err": err[0] if key == "fwd" else err[1],
            "ms": ms[key], "plain_ms": ms[f"{key}_plain"],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
