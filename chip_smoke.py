#!/usr/bin/env python3
"""Smoke run of the PyTorch port (snsde_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Two main paths: the sepsis classification training path (Euler–Maruyama,
the fused EM kernels) and the MuJoCo forecasting training path (SRIW1, the
fused SRK kernels). Phases, each of which raises on failure:
  1. card: name, and name and power limit from nvidia-smi;
  2. build: nvcc builds every kernel of both paths from snsde_torch/csrc/
     (sm_90a, one nvcc per source, all started together), with the build
     seconds and ptxas report;
  3. kernels vs their plain PyTorch versions on the card, on the same
     inputs: the EM pair at the sepsis shape (B=1024, L=72, C=69, H=HH=49,
     two hidden layers, neurallnsde (4,17)), then (2,16) and (6,17) at
     B=128; the SRK pair at the MuJoCo shape (B=1024, L=50, C=14, H=HH=32,
     two hidden layers, (4,17)), at (2,16) and (6,17) with B=128, and at
     the sepsis width: the trajectory and every backward output, within
     stated tolerances of the float32 plain version, and no further from
     a float64 run of the plain version than a small multiple of the
     float32 plain version's own error;
  4. main paths, each with every launch count set to 0 just before it and
     read just after: the sepsis harness `run_sepsis` (neurallnsde, H=49,
     batch 1024, C=69) on synthetic_sepsis(n=4096) for 2 epochs, which
     must launch both EM kernels; the forecasting harness `run_mujoco`
     (neurallnsde, H=32, two hidden layers, batch 1024, srk) on 4000
     synthetic MuJoCo windows for 2 epochs, which must launch both SRK
     kernels; the losses must be finite, and each trained model's fused
     solve must match the eager solver on a small batch with the same
     Brownian increments;
  5. times: the natural cubic fit of the forecasting windows on the host
     by each of its two paths (host clock, median of 3); each kernel and
     its plain version, and one full training step (forward + backward +
     Adam) of each path through the kernels and through the eager solver
     (CUDA events, median of 30 after warm-up); a torch.profiler window of
     each kernel step gives device time by kernel and the device's busy
     share.
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
# the MuJoCo forecasting path (tools/run_real_mujoco.py:42-56, --method srk)
SRK = dict(B=1024, L=50, C=14, H=32, layers=2, model="neurallnsde", T=10)
# max abs error of the trajectory against the float32 plain version
# (measured: EM 2.4e-5; SRK 2.1e-5 at the MuJoCo shape, 4.2e-5 at the
# sepsis width). The float32 plain version's own largest error from
# float64 at those shapes is 2.7e-5, 2.3e-5 and 1.3e-4 (max|ys| 70, 36
# and 72): where this limit trips, read the float64 lines first.
TOL_YS = 5e-5
# max abs error of a cotangent over its max (measured: EM 4.1e-7, SRK 4.6e-6)
TOL_GRAD = 1e-5
# every output against a float64 run of the plain version: the kernel's
# root-mean-square error, over the largest entry, may be at most
# F64_FACTOR times the float32 plain version's own, plus F64_FLOOR
# (tests/test_torch_cuda.py's rule, and why the mean square)
F64_FACTOR = 4.0
F64_FLOOR = 1e-5
REPS, WARMUP = 30, 5
EAGER_REPS = 5      # the eager training steps launch ~10^4 kernels each
N_SEPSIS = 4096     # samples of synthetic_sepsis on the main path
N_MUJOCO = 4000     # windows: 100 trajectories x 40, as the bank gives
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
    _build.build(["fused_em", "fused_srk"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")


def kernel_inputs(model_name, B, L, C, H, layers, seed=0, srk=False):
    """Detached kernel inputs of a random field on a random control path,
    with Brownian increments (and, for srk, the Lévy area) from numpy, on
    the card."""
    from snsde_torch.harness.classification import make_sde_model
    from snsde_torch.kernels.fused_em import fused_em_inputs
    from snsde_torch.kernels.fused_srk import fused_srk_inputs
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
        if srk:
            I10 = torch.as_tensor(levy_area(rng, dW.numpy()))
            inp = fused_srk_inputs(field.bind(path), path, grid, y0,
                                   dW.to(DEV), I10.to(DEV))
        else:
            inp = fused_em_inputs(field.bind(path), path, grid, y0,
                                  dW.to(DEV))
    inp = {k: (v.detach().contiguous() if torch.is_tensor(v) else v)
           for k, v in inp.items()}
    # the cotangent of a batch-mean loss: O(1/B) per entry
    gys = torch.as_tensor(rng.normal(size=(M, B, H)).astype(np.float32) / B)
    return inp, gys.to(DEV)


def levy_area(rng, dW, dt=1.0):
    """I10 = dt/2 (dW + dZ sqrt(dt)/sqrt(3)) for unit steps, from numpy."""
    dZ = rng.normal(size=dW.shape) * np.sqrt(dt)
    return (0.5 * dt * (dW + dZ / np.sqrt(3.0))).astype(np.float32)


def solver(srk):
    """(module, names of the forward's tensor inputs) of one kernel pair."""
    from snsde_torch.kernels import fused_em as fe
    from snsde_torch.kernels import fused_srk as fs

    if srk:
        return fs, fs._ARG_ORDER
    return fe, ("y0", "xh", "dw", "a", "gk", "dts", "theta", "wy",
                "w_inner", "b_inner", "wout", "bo")


def _split(inp, srk=False):
    flags = dict(mult_y=inp["mult_y"], geometric=inp["geometric"])
    return [inp[k] for k in solver(srk)[1]], flags


def kernel_fns(srk):
    """(forward, plain forward, backward, plain backward) of one pair."""
    mod, _ = solver(srk)
    pre = "fused_srk" if srk else "fused_em"
    return tuple(getattr(mod, f"{pre}_{n}") for n in (
        "forward", "forward_reference", "backward", "backward_reference"))


def _errs64(a, ref):
    """(largest, root-mean-square) error of a float32 result from its
    float64 counterpart, each over the largest entry of the float64
    result."""
    d = a.double() - ref
    scale = max(float(ref.abs().max()), 1e-30)
    return (float(d.abs().max()) / scale,
            float(d.square().mean().sqrt()) / scale)


def compare(model_name, B, L, C, H, layers, srk=False):
    """Kernel vs plain version on the same inputs; returns max abs errors
    of the forward and the backward (over all its outputs). Each output is
    also held against a float64 run of the plain version: the kernel's
    root-mean-square error from it may be at most F64_FACTOR times the
    float32 plain version's own, plus F64_FLOOR (both over the largest
    entry)."""
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(srk)
    inp, gys = kernel_inputs(model_name, B, L, C, H, layers, srk=srk)
    fwd, flags = _split(inp, srk)
    ys_k = fwd_k(*fwd, **flags)
    ys_p = fwd_p(*fwd, **flags)
    bwd_args = [fwd[0], ys_p, gys] + fwd[1:]
    g_k = bwd_k(*bwd_args, **flags)
    g_p = bwd_p(*bwd_args, **flags)
    in64 = [t.double() for t in fwd]
    ys_64 = fwd_p(*in64, **flags)
    g_64 = bwd_p(in64[0], ys_64, gys.double(), *in64[1:], **flags)
    torch.cuda.synchronize()

    def check64(name, k, p, ref):
        (k_max, k_rms), (p_max, p_rms) = _errs64(k, ref), _errs64(p, ref)
        print(f"      from float64 (max {float(ref.abs().max()):.3e}), "
              f"largest/rms: kernel {k_max:.3e}/{k_rms:.3e}, float32 plain "
              f"{p_max:.3e}/{p_rms:.3e} (tol rms {F64_FACTOR:g}x plain + "
              f"{F64_FLOOR:g})")
        if not k_rms <= F64_FACTOR * p_rms + F64_FLOOR:
            raise AssertionError(f"{name}: kernel further from float64 than "
                                 f"the float32 plain version allows")

    err_f = float((ys_k - ys_p).abs().max())
    print(f"  {'SRK' if srk else 'EM'} {model_name} B={B} L={L} H={H}: ys "
          f"max abs err {err_f:.3e} (tol {TOL_YS:g})")
    if not err_f <= TOL_YS:
        raise AssertionError(f"forward kernel disagrees: {err_f}")
    check64("ys", ys_k, ys_p, ys_64)
    err_b = 0.0
    for name, a, b, ref in zip(g_k._fields, g_k, g_p, g_64):
        if b.numel() == 0:
            continue
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        err_b = max(err_b, err)
        print(f"    d{name[1:]:9s} max abs err {err:.3e} rel {rel:.3e} "
              f"(tol rel {TOL_GRAD:g})")
        if not rel <= TOL_GRAD:
            raise AssertionError(f"backward kernel disagrees on {name}")
        check64(name, a, b, ref)
    return err_f, err_b


def main_config():
    from snsde_torch.harness.classification import HarnessConfig

    return HarnessConfig(model_name=MAIN["model"], hidden_channels=MAIN["H"],
                         hidden_hidden_channels=MAIN["H"],
                         num_hidden_layers=MAIN["layers"],
                         batch_size=MAIN["B"])


def zero_counts():
    """Set the launch count of every kernel to 0."""
    for srk in (False, True):
        mod, _ = solver(srk)
        mod.FWD_LAUNCHES = mod.BWD_LAUNCHES = 0


def read_counts():
    fe, _ = solver(False)
    fs, _ = solver(True)
    return {"em_fwd": fe.FWD_LAUNCHES, "em_bwd": fe.BWD_LAUNCHES,
            "srk_fwd": fs.FWD_LAUNCHES, "srk_bwd": fs.BWD_LAUNCHES}


def main_path():
    """The sepsis path; returns the launch counts of its run."""
    from snsde_torch.harness.classification import run_sepsis

    cfg = main_config()
    zero_counts()
    t0 = time.perf_counter()
    res = run_sepsis(cfg, n=N_SEPSIS, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    losses = [h[s]["loss"] for h in res.history for s in ("train", "val")]
    losses += [res.train_metrics.loss, res.val_metrics.loss,
               res.test_metrics.loss]
    print(f"main path 1: run_sepsis 2 epochs in {wall:.1f} s, losses "
          f"{[round(v, 4) for v in losses]}, val AUROC "
          f"{res.val_metrics.auroc:.4f}, test AUROC "
          f"{res.test_metrics.auroc:.4f}, launches {launches}", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss on the sepsis path")
    if launches["em_fwd"] <= 0 or launches["em_bwd"] <= 0:
        raise AssertionError(f"sepsis path did not run the kernels: "
                             f"{launches}")
    check_trained_solve(res.model.sde.func, MAIN)
    return launches


def mujoco_config():
    from snsde_torch.harness.forecasting import ForecastConfig

    return ForecastConfig(model_name=SRK["model"], hidden_channels=SRK["H"],
                          hidden_hidden_channels=SRK["H"],
                          num_hidden_layers=SRK["layers"], lr=1e-3,
                          batch_size=SRK["B"], time_augment=False,
                          step_mode="valloss", loss="mse", reg="l2",
                          reg_scale=0.01, method="srk")


def mujoco_path():
    """The MuJoCo forecasting path; returns the launch counts of its run."""
    from snsde_torch.harness.forecasting import run_mujoco

    cfg = mujoco_config()
    zero_counts()
    t0 = time.perf_counter()
    res = run_mujoco(cfg, n=N_MUJOCO, max_epochs=2, device=DEV)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mses = [h[s] for h in res["history"] for s in ("train", "val", "test")]
    mses.append(res["test_mse"])
    print(f"main path 2: run_mujoco (srk) 2 epochs in {wall:.1f} s "
          f"({res['steps']} steps), MSEs {[round(v, 4) for v in mses]}, "
          f"launches {launches}", flush=True)
    if not all(np.isfinite(mses)):
        raise AssertionError("non-finite MSE on the forecasting path")
    if launches["srk_fwd"] <= 0 or launches["srk_bwd"] <= 0:
        raise AssertionError(f"forecasting path did not run the SRK "
                             f"kernels: {launches}")
    check_trained_solve(res["model"].func, SRK, srk=True)
    return launches


def check_trained_solve(func, shape, srk=False, B=64):
    """A trained field's fused solve vs the eager solver, on the same dW
    (and, for srk, the same Lévy area)."""
    from snsde_torch.kernels.fused_em import fused_em_solve
    from snsde_torch.kernels.fused_srk import fused_srk_solve
    from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                                 make_grid, sdeint)

    rng = np.random.default_rng(1)
    L, C, H = shape["L"], shape["C"], shape["H"]
    times = np.arange(L, dtype=np.float32)
    x = torch.as_tensor(rng.normal(size=(B, L, C)).astype(np.float32))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times), x).to(DEV),
                     times)
    grid, _ = make_grid(times, 1.0)
    dW = rng.normal(size=(len(grid) - 1, B, H)).astype(np.float32)
    I10 = torch.as_tensor(levy_area(rng, dW)).to(DEV)
    dW = torch.as_tensor(dW).to(DEV)
    y0 = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32)).to(DEV)
    field = func.bind(path)
    with torch.no_grad():
        if srk:
            ys_f = fused_srk_solve(field, path, times, y0, dt=1.0,
                                   brownian_override=(dW, I10))
            ys_e = sdeint(field.f, field.g, y0, times, method="srk",
                          bm=BrownianGrid(grid, dW, I10))
        else:
            ys_f = fused_em_solve(field, path, times, y0, dt=1.0,
                                  dW_override=dW)
            ys_e = sdeint(field.f, field.g, y0, times,
                          bm=BrownianGrid(grid, dW))
    err = float((ys_f - ys_e).abs().max())
    print(f"trained model: fused vs eager {'srk' if srk else 'euler'} "
          f"solve, B={B}: shape {tuple(ys_f.shape)}, max abs err {err:.3e} "
          f"(tol {TOL_YS:g})")
    if not (torch.isfinite(ys_f).all() and err <= TOL_YS):
        raise AssertionError("trained model's fused solve disagrees")


def spline_times(reps=3):
    """Host seconds (median of `reps`) of the natural cubic fit of the
    forecasting path's input windows, 4000 x 14 = 56,000 series of 50
    knots, by each of `natural_cubic_coeffs`'s two paths: the clean fit it
    takes when no value is missing and the batched NaN-aware fit it takes
    otherwise; and how far apart their coefficients are on this input."""
    from snsde_torch.data import synthetic_mujoco
    from snsde_torch.ops.interp import (_natural_coeffs_clean,
                                        _natural_coeffs_missing)

    L = SRK["L"]
    X, _ = synthetic_mujoco(n=N_MUJOCO, length=L + SRK["T"], seed=0)
    x = torch.as_tensor(X[:, :L]).transpose(-1, -2).contiguous()  # [N, C, L]
    times = torch.arange(L, dtype=x.dtype)
    fits = {"clean": lambda: _natural_coeffs_clean(times, x),
            "NaN-aware": lambda: tuple(
                v.reshape(x.shape[:-1] + (L - 1,))
                for v in _natural_coeffs_missing(times, x.reshape(-1, L)))}
    out, sec = {}, {}
    for name, fit in fits.items():
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out[name] = fit()
            runs.append(time.perf_counter() - t0)
        sec[name] = statistics.median(runs)
    diff = max(float((a - b).abs().max())
               for a, b in zip(out["clean"], out["NaN-aware"]))
    print(f"host: natural cubic fit of {x.shape[0] * x.shape[1]} series of "
          f"{L} knots: clean {sec['clean']:.4f} s, NaN-aware "
          f"{sec['NaN-aware']:.4f} s (median of {reps}); coefficients "
          f"differ by {diff:.3e} at most", flush=True)


def timed(fn, reps=REPS, warmup=WARMUP) -> float:
    """Median ms of fn() over `reps` runs after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
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


def kernel_times(shape, srk=False):
    """Times of one kernel pair and its plain versions at a path's shape,
    and the pair's bounds computed from the same inputs: the bytes of every
    input read once and every output written once, and the fp32 operations
    of the MLP products (one MLP evaluation per EM step, two per SRK step;
    the backward recomputes them and runs each evaluation's two products
    back: 3x)."""
    fwd_k, fwd_p, bwd_k, bwd_p = kernel_fns(srk)
    inp, gys = kernel_inputs(shape["model"], shape["B"], shape["L"],
                             shape["C"], shape["H"], shape["layers"], srk=srk)
    fwd, flags = _split(inp, srk)
    ys = fwd_k(*fwd, **flags)
    bwd_args = [fwd[0], ys, gys] + fwd[1:]
    ms = {"fwd": timed(lambda: fwd_k(*fwd, **flags)),
          "fwd_plain": timed(lambda: fwd_p(*fwd, **flags)),
          "bwd": timed(lambda: bwd_k(*bwd_args, **flags)),
          "bwd_plain": timed(lambda: bwd_p(*bwd_args, **flags))}
    M, B, H = ys.shape
    HH = inp["wy"].shape[1]
    n_inner = inp["w_inner"].shape[0]
    evals = 2 if srk else 1
    products = 2 * evals * M * B * (H * HH + n_inner * HH * HH + HH * H)
    nbytes_in = 4 * sum(t.numel() for t in fwd)
    grads = bwd_k(*bwd_args, **flags)
    bounds = {"fwd": bound(nbytes_in + 4 * ys.numel(), products),
              "bwd": bound(nbytes_in + 4 * (ys.numel() + gys.numel()
                                            + sum(g.numel() for g in grads)),
                           3 * products)}
    return ms, bounds


def sepsis_step_fns():
    """One training step of the sepsis model on one batch of 1024
    sepsis-shaped samples: {label: step()} through the kernels and through
    the eager solver."""
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
    splits = ("train", "val", "test")
    cat = lambda k: np.concatenate([data[s][k] for s in splits])
    batch = {"coeffs": torch.as_tensor(cat("coeffs"), device=dev),
             "final_index": torch.as_tensor(cat("final_index"), device=dev),
             "y": torch.as_tensor(cat("y"), dtype=torch.float32, device=dev),
             "static": torch.as_tensor(static, device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model = build_sepsis_model(cfg, data["input_channels"],
                                   static.shape[-1], dev)
        tc = TrainConfig(pos_weight=10.0)
        readout_grad_hook("sde.readout.linear2")(model)

        def apply_fn(m, b, g, fused=fused):
            return m(times, b["coeffs"], b["static"], b["final_index"],
                     generator=g, use_fused=fused)[..., 0]

        loss_fn = make_loss_fn(apply_fn, lambda m: m.sde.func, tc)
        opt = make_optimizer(model, tc)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[label] = (lambda model=model, opt=opt, loss_fn=loss_fn, gen=gen:
                      train_step(model, opt, loss_fn, batch, gen))
    return out


def mujoco_step_fns():
    """One training step of the forecasting model (mse + 0.01 L2, coupled-
    L2 Adam) on one batch of 1024 MuJoCo-shaped windows: {label: step()}
    through the SRK kernels and through the eager srk solver."""
    from snsde_torch.data import synthetic_mujoco
    from snsde_torch.harness.forecasting import (forecast_coeffs,
                                                 make_forecast_model)
    from snsde_torch.train.loop import train_step, weight_regularization

    cfg = mujoco_config()
    L, T = SRK["L"], SRK["T"]
    X, _ = synthetic_mujoco(n=SRK["B"], length=L + T, seed=0)
    times = np.arange(L, dtype=np.float32)
    dev = torch.device(DEV)
    batch = {"coeffs": torch.as_tensor(forecast_coeffs(cfg, X[:, :L], times),
                                       device=dev),
             "y": torch.as_tensor(X[:, L:], device=dev)}
    out = {}
    for label, fused in (("train_step", True), ("train_step_eager", False)):
        model, reg_fn = make_forecast_model(
            cfg.model_name, SRK["C"], SRK["H"], SRK["H"], SRK["layers"],
            SRK["C"], T, method="srk",
            generator=torch.Generator().manual_seed(0))
        model = model.to(dev)

        def loss_fn(m, b, g, fused=fused, reg_fn=reg_fn):
            pred = m(times, b["coeffs"], generator=g, use_fused=fused)
            return (torch.mean((pred - b["y"]) ** 2)
                    + weight_regularization(reg_fn(m), 0.01)), pred

        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                               weight_decay=cfg.weight_decay)
        gen = torch.Generator(device=dev).manual_seed(0)
        out[label] = (lambda model=model, opt=opt, loss_fn=loss_fn, gen=gen:
                      train_step(model, opt, loss_fn, batch, gen))
    return out


def step_times(label, steps):
    """Median step time through the kernels and through the eager solver,
    and a profiler window of the kernel step."""
    ms = {"train_step": timed(steps["train_step"]),
          "train_step_eager": timed(steps["train_step_eager"],
                                    reps=EAGER_REPS, warmup=1)}
    profile_step(label, steps["train_step"])
    return ms


def profile_step(label, step, n=5):
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
    print(f"profile of one {label} train step (mean of {n}): {wall:.3f} ms "
          f"wall, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.4f} ms {100 * ms / wall:5.1f}%  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import snsde_torch  # noqa: F401  (fails outside the repository)

    smi = card()
    build()
    print("kernels vs plain versions:", flush=True)
    err = {"em": compare(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"],
                         MAIN["H"], MAIN["layers"])}
    for name in ("neurallsde", "neuralgsde"):
        compare(name, 128, MAIN["L"], MAIN["C"], MAIN["H"], MAIN["layers"])
    err["srk"] = compare(SRK["model"], SRK["B"], SRK["L"], SRK["C"],
                         SRK["H"], SRK["layers"], srk=True)
    for name in ("neurallsde", "neuralgsde"):
        compare(name, 128, SRK["L"], SRK["C"], SRK["H"], SRK["layers"],
                srk=True)
    compare(MAIN["model"], MAIN["B"], MAIN["L"], MAIN["C"], MAIN["H"],
            MAIN["layers"], srk=True)
    launches = {"em": main_path(), "srk": mujoco_path()}
    spline_times()
    ms, bounds = {}, {}
    for key, shape, srk in (("em", MAIN, False), ("srk", SRK, True)):
        ms[key], bounds[key] = kernel_times(shape, srk=srk)
    ms["em"].update(step_times("sepsis (euler)", sepsis_step_fns()))
    ms["srk"].update(step_times("mujoco (srk)", mujoco_step_fns()))
    for key in ms:
        for k, v in ms[key].items():
            print(f"time {key} {k}: {v:.4f} ms  [{smi}]")
    kernels = []
    for key, pre, lines, src in (
            ("em", "fused_em", (688, 888), "fused_em"),
            ("srk", "fused_srk", (295, 527), "fused_srk")):
        for part, line in zip(("fwd", "bwd"), lines):
            kernels.append({
                "name": f"{pre}_{'forward' if part == 'fwd' else 'backward'}",
                "route": "cuda",
                "source": f"snsde_torch/csrc/{src}.cu",
                "replaces": f"snsde/kernels/{src}.py:{line}",
                "launches": launches[key][f"{key}_{part}"],
                "max_abs_err": err[key][0 if part == "fwd" else 1],
                "ms": ms[key][part], "plain_ms": ms[key][f"{part}_plain"],
                "bound_ms": bounds[key][part][0],
                "bound_by": bounds[key][part][1],
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
