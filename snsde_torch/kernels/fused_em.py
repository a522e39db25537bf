"""Fused Euler–Maruyama solve: two hand-written CUDA kernels for Hopper
(snsde_torch/csrc/fused_em.cu) behind a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_em.py —
`_fused_em_forward` (pallas_call at :688, body `_fwd_kernel` :590) and
`_fused_em_backward` (pallas_call at :888, body `_bwd_kernel` :736), the
custom VJP `_fused_em` (:961-1065) — for the configurations the sepsis
main path and its siblings use: drift mode 'embm' (the merged emb drift,
input_option 2, 4 or 6) with noise mode 'precomp' (a diffusion magnitude
that depends on t only: noise_option 0-6, 11-13, 16, 17), mult_y on or off,
geometric on or off. That covers neurallsde (2,16), neurallnsde (4,17) and
neuralgsde (6,17). Every other configuration takes the eager `sdeint`
(see `supports_fused`).

What bounds the kernels on the H100: at the main-path shape (B=1024, 71
steps, H=49) the forward moves ~43 MB and does ~1 GFLOP of fp32 work
(~13 us and ~16 us at 3.35 TB/s and 67 TFLOP/s), the backward ~71 MB and
~3 GFLOP (~21 us, ~47 us). Neither is the limit: the work is a chain of 71
dependent steps, each a few [rows x 49] x [49 x 49] products with barriers
between them, spread over only 1024 independent rows. The design keeps
everything a step needs in shared memory for the whole loop (one thread
block per 8-row tile; weights, state and, in the backward, the weight-
gradient accumulators), so only the per-step streams touch device memory,
and computes in exact fp32 on the CUDA cores.

As in the JAX package, the y-independent parts stay outside the kernels as
plain matrix products whose gradients come from torch autograd
(`fused_em.py:1225-1293`): the hoist xh' = (X(t) W_init + b_init) We2, the
merge Wy' = Wy We1 and a' = (tf Wt + b_in) We1 + be, and the diffusion
magnitude gk(t). Per-block partial gradients are summed outside the
backward kernel in a fixed order (`:905-941`), so runs are reproducible.

Each kernel has a plain PyTorch version beside it with the same inputs and
outputs. `fused_em_forward`/`fused_em_backward` take the plain versions
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.brownian import brownian_increments
from ..ops.solve import make_grid
from ._solver import (MULT_Y_NO, SolverLib, check_supported,
                      check_tensors, kernel_dims, merged_drift_rows,
                      merged_drift_weights, precomp_gk, stage_times,
                      supports_fused)

__all__ = ["fused_em_solve", "fused_em_inputs", "supports_fused", "FusedEM",
           "fused_em_forward", "fused_em_backward",
           "fused_em_forward_reference", "fused_em_backward_reference",
           "FusedEMGrads"]

# launches of each CUDA kernel since the count was last set to 0
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


class FusedEMGrads(NamedTuple):
    """Cotangents of the fused solve's inputs (per-block partials summed)."""
    dy0: torch.Tensor        # [B, H]
    dxh: torch.Tensor        # [M, B, HH]
    da: torch.Tensor         # [M, HH]
    dgk: torch.Tensor        # [M, H]
    dtheta: torch.Tensor     # [1]
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def fused_em_forward_reference(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                               b_inner, wout, bo, *, mult_y: bool,
                               geometric: bool,
                               relu=torch.relu) -> torch.Tensor:
    """Eager EM loop over the merged drift: ys [M, B, H] (y after each
    step). Weights in [in, out] layout; theta [1]. Every relu of the drift
    MLP is `relu` (a stand-in may probe the pre-activations)."""
    sth = torch.sigmoid(theta.reshape(()))
    y = y0
    ys = []
    for u in range(dts.shape[0]):
        h = relu(y @ wy + a[u] + xh[u])
        for l in range(w_inner.shape[0]):
            h = relu(h @ w_inner[l] + b_inner[l])
        z3 = h @ wout + bo
        if geometric:
            z3 = z3 * torch.tanh(y)
        f = torch.tanh(z3)
        graw = gk[u] * y if mult_y else gk[u].expand_as(y)
        g = torch.tanh(sth * graw)
        y = y + f * dts[u] + g * dw[u]
        ys.append(y)
    return torch.stack(ys)


def fused_em_backward_reference(y0, ys, gys, xh, dw, a, gk, dts, theta, wy,
                                w_inner, b_inner, wout, bo, *, mult_y: bool,
                                geometric: bool,
                                relu=torch.relu) -> FusedEMGrads:
    """Eager reverse loop mirroring the backward kernel (and the JAX
    `_bwd_kernel`): recompute each step from the state before it, then
    back through the diffusion bound, mult_y, the drift MLP and the merged
    drift input. `relu` as in the forward; its derivative is read from
    its output (> 0)."""
    sth = torch.sigmoid(theta.reshape(()))
    n_inner = w_inner.shape[0]
    gbar = torch.zeros_like(y0)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    dwy, dwo, dbo = (torch.zeros_like(wy), torch.zeros_like(wout),
                     torch.zeros_like(bo))
    dwi, dbi = torch.zeros_like(w_inner), torch.zeros_like(b_inner)
    da, dgk, dxh = (torch.empty_like(a), torch.empty_like(gk),
                    torch.empty_like(xh))
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        hs = [relu(y @ wy + a[u] + xh[u])]
        for l in range(n_inner):
            hs.append(relu(hs[-1] @ w_inner[l] + b_inner[l]))
        z3l = hs[-1] @ wout + bo
        ty = torch.tanh(y)
        f = torch.tanh(z3l * ty if geometric else z3l)
        graw = gk[u] * y if mult_y else gk[u].expand_as(y)
        g = torch.tanh(sth * graw)

        df = gbar * dts[u]
        dg = gbar * dw[u]
        dsg = dg * (1.0 - g * g)
        dth = dth + (dsg * graw).sum()
        dgraw = dsg * sth
        if mult_y:
            dbase, dy = dgraw * y, dgraw * gk[u]
        else:
            dbase, dy = dgraw, torch.zeros_like(y)
        dgk[u] = dbase.sum(0)
        dz3 = df * (1.0 - f * f)
        if geometric:
            dz3l = dz3 * ty
            dy = dy + dz3 * z3l * (1.0 - ty * ty)
        else:
            dz3l = dz3
        dwo += hs[-1].T @ dz3l
        dbo += dz3l.sum(0)
        dz = (dz3l @ wout.T) * (hs[-1] > 0)
        for l in range(n_inner - 1, -1, -1):
            dwi[l] += hs[l].T @ dz
            dbi[l] += dz.sum(0)
            dz = (dz @ w_inner[l].T) * (hs[l] > 0)
        dwy += y.T @ dz
        da[u] = dz.sum(0)
        dxh[u] = dz
        gbar = gbar + dy + dz @ wy.T
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return FusedEMGrads(gbar, dxh, da, dgk, dtheta, dwy, dwi, dbi, dwo, dbo)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_em", "fused EM", 13, 24,
                 int_fns={"plan": 5, "force_placement": 1})


def check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                        wout, bo, ys=None, gys=None):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor,
    or a shape that disagrees with y0/wy/w_inner/dts. Every width is
    taken (csrc/sde_common.cuh places what does not fit shared memory in
    device memory). Returns (M, B, H, HH, n_inner)."""
    M, B, H, HH, n_inner = dims = kernel_dims("fused EM", y0, wy, w_inner,
                                              dts)
    want = {"y0": (B, H), "xh": (M, B, HH), "dw": (M, B, H), "a": (M, HH),
            "gk": (M, H), "dts": (M,), "theta": (1,), "wy": (H, HH),
            "w_inner": (n_inner, HH, HH), "b_inner": (n_inner, HH),
            "wout": (HH, H), "bo": (H,), "ys": (M, B, H), "gys": (M, B, H)}
    got = {"y0": y0, "xh": xh, "dw": dw, "a": a, "gk": gk, "dts": dts,
           "theta": theta, "wy": wy, "w_inner": w_inner, "b_inner": b_inner,
           "wout": wout, "bo": bo, "ys": ys, "gys": gys}
    check_tensors("fused EM", want, got, y0.device)
    return dims


def fused_em_forward(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                     wout, bo, *, mult_y: bool,
                     geometric: bool) -> torch.Tensor:
    """ys [M, B, H]: the CUDA forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global FWD_LAUNCHES
    if y0.device.type == "cpu":
        return fused_em_forward_reference(
            y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout, bo,
            mult_y=mult_y, geometric=geometric)
    dims = check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                               b_inner, wout, bo)
    stream = _LIB.stream(y0, dims[2:], backward=False)
    M, B, H, _, _ = dims
    ys = torch.empty((M, B, H), dtype=torch.float32, device=y0.device)
    _LIB.launch("fwd", (y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                        wout, bo, ys), dims + (mult_y, geometric), stream)
    FWD_LAUNCHES += 1
    return ys


def fused_em_backward(y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner,
                      b_inner, wout, bo, *, mult_y: bool,
                      geometric: bool) -> FusedEMGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: the CUDA
    backward kernel for CUDA tensors (per-block partials summed here), the
    plain version for CPU tensors."""
    global BWD_LAUNCHES
    if y0.device.type == "cpu":
        return fused_em_backward_reference(
            y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
            wout, bo, mult_y=mult_y, geometric=geometric)
    dims = check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                               b_inner, wout, bo, ys=ys, gys=gys)
    stream = _LIB.stream(y0, dims[2:], backward=True)
    M, B, H, HH, n_inner = dims
    nb = -(-B // _LIB.rows(dims[2:], backward=True))
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=y0.device)
    dxh, dy0 = empty(M, B, HH), empty(B, H)
    p_wy, p_wi, p_bi = (empty(nb, H, HH), empty(nb, n_inner, HH, HH),
                        empty(nb, n_inner, HH))
    p_wo, p_bo = empty(nb, HH, H), empty(nb, H)
    p_a, p_gk, p_th = empty(nb, M, HH), empty(nb, M, H), empty(nb)
    _LIB.launch("bwd", (y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner,
                        b_inner, wout, bo, dxh, dy0, p_wy, p_wi, p_bi, p_wo,
                        p_bo, p_a, p_gk, p_th), dims + (mult_y, geometric),
                stream)
    BWD_LAUNCHES += 1
    return FusedEMGrads(dy0, dxh, p_a.sum(0), p_gk.sum(0),
                        p_th.sum(0, keepdim=True), p_wy.sum(0), p_wi.sum(0),
                        p_bi.sum(0), p_wo.sum(0), p_bo.sum(0))


class FusedEM(torch.autograd.Function):
    """ys = EM solve over the merged drift; backward by the backward
    kernel. Inputs: y0 [B,H], xh [M,B,HH], dw [M,B,H] (not differentiated),
    a [M,HH], gk [M,H], dts [M] (not differentiated), theta [1], wy [H,HH],
    w_inner [n_inner,HH,HH], b_inner [n_inner,HH], wout [HH,H], bo [H]."""

    @staticmethod
    def forward(ctx, y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                wout, bo, mult_y, geometric):
        ys = fused_em_forward(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                              b_inner, wout, bo, mult_y=mult_y,
                              geometric=geometric)
        ctx.save_for_backward(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                              b_inner, wout, bo, ys)
        ctx.flags = (bool(mult_y), bool(geometric))
        return ys

    @staticmethod
    def backward(ctx, gys):
        (y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout, bo,
         ys) = ctx.saved_tensors
        mult_y, geometric = ctx.flags
        gr = fused_em_backward(y0, ys, gys.contiguous(), xh, dw, a, gk, dts,
                               theta, wy, w_inner, b_inner, wout, bo,
                               mult_y=mult_y, geometric=geometric)
        return (gr.dy0, gr.dxh, None, gr.da, gr.dgk, None, gr.dtheta, gr.dwy,
                gr.dw_inner, gr.db_inner, gr.dwout, gr.dbo, None, None)


# ---------------------------------------------------------------------------
# Public entry: solve a DiffusionField SDE with the fused kernels
# ---------------------------------------------------------------------------

def fused_em_inputs(field, path, grid: np.ndarray, y0: torch.Tensor,
                    dW: torch.Tensor) -> dict:
    """The kernels' inputs for a supported field on a host step grid: the
    hoisted and merged precomputes (differentiable through autograd), the
    stacked weights in [in, out] layout, and the mult_y/geometric flags."""
    check_supported(field, "fused EM")
    io, no = field.input_option, field.noise_option
    dev, f32 = y0.device, torch.float32
    t_lo, dts = stage_times(dev, grid[:-1], np.diff(grid))
    xh, a = merged_drift_rows(field, path, grid[:-1], t_lo)
    return {"y0": y0.contiguous(), "xh": xh,
            "dw": dW.to(device=dev, dtype=f32).contiguous(), "a": a,
            "gk": precomp_gk(field, t_lo).contiguous(), "dts": dts,
            "theta": field.theta.reshape(1),
            **merged_drift_weights(field, dev),
            "mult_y": no in MULT_Y_NO, "geometric": io in (5, 6)}


_ARG_ORDER = ("y0", "xh", "dw", "a", "gk", "dts", "theta", "wy", "w_inner",
              "b_inner", "wout", "bo", "mult_y", "geometric")


def fused_em_solve(field, path, times, y0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   dt: Optional[float] = None,
                   dW_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EM solve of a supported DiffusionField through the fused kernels.
    Returns ys [T, B, H] on the output times (time-major). Brownian
    increments come from `dW_override` [M, B, H] when given, else from
    `generator`. Matches DiffusionField.f/g except for float32
    reassociation of the merged drift input (~1e-7 per step)."""
    from ..models.neuralsde import resolve_dt

    dt = resolve_dt(times) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    if dW_override is None:
        dW = brownian_increments(generator, grid,
                                 (y0.shape[0], field.hidden_channels),
                                 torch.float32, y0.device)
    else:
        dW = dW_override
    inputs = fused_em_inputs(field, path, grid, y0, dW)
    ys = FusedEM.apply(*(inputs[k] for k in _ARG_ORDER))
    full = torch.cat([y0[None], ys], dim=0)
    return full[torch.as_tensor(out_idx, device=y0.device)]
