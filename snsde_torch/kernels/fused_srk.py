"""Fused SRIW1 (stochastic Runge–Kutta, strong order 1.5) solve: two
hand-written CUDA kernels for Hopper (snsde_torch/csrc/fused_srk.cu) behind
a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_srk.py —
`_fused_srk_forward` (pallas_call at :295, body `_fwd_kernel` :215, step
`_srk_step` :158) and `_fused_srk_backward` (pallas_call at :527, body
`_bwd_kernel` :317), the custom VJP `_fused_srk` (:599-636) — for the modes
of the EM kernels: drift mode 'embm' (the merged emb drift, input_option 2,
4 or 6) with noise mode 'precomp' (noise_option 0-6, 11-13, 16, 17),
mult_y on or off, geometric on or off. That covers neurallsde (2,16),
neurallnsde (4,17) and neuralgsde (6,17). Every other configuration takes
the eager `sdeint(method="srk")` (see `supports_fused_srk`).

Per step the tableau needs two drift MLP evaluations (at t and at
t + 3/4 dt) and four elementwise diffusion evaluations at three stage times
(t, t + dt/4 twice, t + dt); the y-update weighs them with coefficients
built from dW and the space-time Lévy area I10. As for the EM kernels, the
y-independent parts stay outside the kernels as plain matrix products
whose gradients come from torch autograd, once per stage time: the hoist
xh' (xh0 at t, xh1 at t + 3/4 dt), the merged a' rows (a0, a1) and the
diffusion magnitudes gk (gk0 at t, gk1 at t + dt/4, gk2 at t + dt).

What bounds the kernels on the H100: at the MuJoCo shape (B=1024, 49 steps,
H=HH=32, one inner layer) the forward does ~0.6 GFLOP and moves ~32 MB
(~10 us at 67 TFLOP/s fp32 or 3.35 TB/s), the backward ~3x the products
and ~51 MB. Neither is the limit: the work is a chain of 49 dependent steps,
each two MLP evaluations of [rows x 32] x [32 x 32] products with barriers
between them, over only 1024 independent rows. The design is the EM
kernels' (one thread block per 8-row tile runs the whole loop with the
weights, state, stage states and both evaluations' activations in shared
memory; exact fp32 FMA; per-block partial gradients summed here in a fixed
order, so runs are reproducible).

Each kernel has a plain PyTorch version beside it with the same inputs and
outputs. `fused_srk_forward`/`fused_srk_backward` take the plain versions
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.brownian import brownian_increments, space_time_levy_area
from ..ops.solve import make_grid
from ._solver import (MULT_Y_NO, SolverLib, check_supported, check_tensors,
                      kernel_dims, merged_drift_rows, merged_drift_weights,
                      precomp_gk, stage_times, supports_fused)

__all__ = ["fused_srk_solve", "fused_srk_inputs", "supports_fused_srk",
           "FusedSRK", "fused_srk_forward", "fused_srk_backward",
           "fused_srk_forward_reference", "fused_srk_backward_reference",
           "FusedSRKGrads", "check_kernel_inputs"]

# launches of each CUDA kernel since the count was last set to 0
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

# the SRIW1 y-update weights (snsde/kernels/fused_srk.py:63-67)
_ALPHA0, _ALPHA1 = 1.0 / 3.0, 2.0 / 3.0
_BETA1 = (-1.0, 4.0 / 3.0, 2.0 / 3.0, 0.0)
_BETA2 = (-1.0, 4.0 / 3.0, -1.0 / 3.0, 0.0)
_BETA3 = (2.0, -4.0 / 3.0, -2.0 / 3.0, 0.0)
_BETA4 = (-2.0, 5.0 / 3.0, -2.0 / 3.0, 1.0)


# the SRK kernels take the EM kernels' modes
supports_fused_srk = supports_fused


class FusedSRKGrads(NamedTuple):
    """Cotangents of the fused SRK solve's inputs (per-block partials
    summed)."""
    dy0: torch.Tensor        # [B, H]
    dxh0: torch.Tensor       # [M, B, HH]
    dxh1: torch.Tensor       # [M, B, HH]
    da0: torch.Tensor        # [M, HH]
    da1: torch.Tensor        # [M, HH]
    dgk0: torch.Tensor       # [M, H]
    dgk1: torch.Tensor       # [M, H]
    dgk2: torch.Tensor       # [M, H]
    dtheta: torch.Tensor     # [1]
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _step_consts(dt):
    """sqrt(dt) and the guarded 1/dt, 1/sqrt(dt): a dt = 0 step is an
    identity (snsde/kernels/fused_srk.py:164-168)."""
    sq = torch.sqrt(dt)
    zero = torch.zeros_like(dt)
    rdt = torch.where(dt > 0, 1.0 / torch.clamp(dt, min=1e-30), zero)
    rsq = torch.where(dt > 0, 1.0 / torch.clamp(sq, min=1e-30), zero)
    return sq, rdt, rsq


def _coeffs(dw, i10, dt, rdt, rsq):
    """coeff_i of the y-update, i = 0..3."""
    I11s = 0.5 * (dw * dw - dt) * rsq
    I111r = (dw * dw * dw - 3.0 * dt * dw) * (rdt / 6.0)
    I10r = i10 * rdt
    return [_BETA1[i] * dw + _BETA2[i] * I11s + _BETA3[i] * I10r
            + _BETA4[i] * I111r for i in range(4)]


def _drift(y, xh, a, wy, w_inner, b_inner, wout, bo, geometric):
    """The merged drift MLP: (f, hidden activations, z3 before the
    geometric factor)."""
    hs = [torch.relu(y @ wy + a + xh)]
    for l in range(w_inner.shape[0]):
        hs.append(torch.relu(hs[-1] @ w_inner[l] + b_inner[l]))
    z3l = hs[-1] @ wout + bo
    return torch.tanh(z3l * torch.tanh(y) if geometric else z3l), hs, z3l


def _stages(y, f0, gks, i10, sth, dt, sq, rdt, mult_y):
    """The four diffusion stages (snsde/kernels/fused_srk.py:173-190):
    (states, raw diffusions, bounded g's, H0_1). gks = (gk0, gk1, gk2);
    stages 0-3 evaluate at stage times (0, 1, 2, 1)."""
    states, graws, gs = [], [], []

    def ev(state, gk):
        graw = gk * state if mult_y else gk.expand_as(state)
        states.append(state)
        graws.append(graw)
        gs.append(torch.tanh(sth * graw))

    ev(y, gks[0])
    ev(y + 0.25 * dt * f0 + 0.5 * sq * gs[0], gks[1])
    ev(y + dt * f0 - sq * gs[0], gks[2])
    ev(y + 0.25 * dt * f0 + sq * (-5.0 * gs[0] + 3.0 * gs[1] + 0.5 * gs[2]),
       gks[1])
    h01 = y + 0.75 * dt * f0 + 1.5 * (i10 * rdt) * gs[0]
    return states, graws, gs, h01


def fused_srk_forward_reference(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                                dts, theta, wy, w_inner, b_inner, wout, bo, *,
                                mult_y: bool,
                                geometric: bool) -> torch.Tensor:
    """Eager SRIW1 loop over the merged drift: ys [M, B, H] (y after each
    step). Weights in [in, out] layout; theta [1]."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric)
    y = y0
    ys = []
    for u in range(dts.shape[0]):
        dt = dts[u]
        sq, rdt, rsq = _step_consts(dt)
        f0 = _drift(y, xh0[u], a0[u], *w)[0]
        _, _, gs, h01 = _stages(y, f0, (gk0[u], gk1[u], gk2[u]), i10[u], sth,
                                dt, sq, rdt, mult_y)
        f1 = _drift(h01, xh1[u], a1[u], *w)[0]
        y1 = y + dt * (_ALPHA0 * f0 + _ALPHA1 * f1)
        for c, g in zip(_coeffs(dw[u], i10[u], dt, rdt, rsq), gs):
            y1 = y1 + c * g
        y = y1
        ys.append(y)
    return torch.stack(ys)


def _drift_bwd(df, state, hs, z3l, wy, w_inner, wout, geometric, acc):
    """Back through one drift evaluation given df = dL/df: adds the weight
    gradients into acc and returns (d state, dz1)."""
    f_ty = torch.tanh(state)
    z3 = z3l * f_ty if geometric else z3l
    f = torch.tanh(z3)
    dz3 = df * (1.0 - f * f)
    dstate = torch.zeros_like(state)
    if geometric:
        dstate = dz3 * z3l * (1.0 - f_ty * f_ty)
        dz3 = dz3 * f_ty
    acc["wout"] += hs[-1].T @ dz3
    acc["bo"] += dz3.sum(0)
    dz = (dz3 @ wout.T) * (hs[-1] > 0)
    for l in range(w_inner.shape[0] - 1, -1, -1):
        acc["w_inner"][l] += hs[l].T @ dz
        acc["b_inner"][l] += dz.sum(0)
        dz = (dz @ w_inner[l].T) * (hs[l] > 0)
    acc["wy"] += state.T @ dz
    return dstate + dz @ wy.T, dz


def fused_srk_backward_reference(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0,
                                 gk1, gk2, dts, theta, wy, w_inner, b_inner,
                                 wout, bo, *, mult_y: bool,
                                 geometric: bool) -> FusedSRKGrads:
    """Eager reverse loop mirroring the backward kernel (and the JAX
    `_bwd_kernel`): recompute every stage from the state before the step,
    then reverse the tableau in the order f1, g3, g2, g1, g0, f0."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric)
    acc = {"wy": torch.zeros_like(wy), "w_inner": torch.zeros_like(w_inner),
           "b_inner": torch.zeros_like(b_inner),
           "wout": torch.zeros_like(wout), "bo": torch.zeros_like(bo)}
    dxh0, dxh1 = torch.empty_like(xh0), torch.empty_like(xh1)
    da0, da1 = torch.empty_like(a0), torch.empty_like(a1)
    dgk = [torch.empty_like(g) for g in (gk0, gk1, gk2)]
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    gbar = torch.zeros_like(y0)
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        dt = dts[u]
        sq, rdt, rsq = _step_consts(dt)
        gks = (gk0[u], gk1[u], gk2[u])
        f0, hs0, z3l0 = _drift(y, xh0[u], a0[u], *w)
        states, graws, gs, h01 = _stages(y, f0, gks, i10[u], sth, dt, sq, rdt,
                                         mult_y)
        _, hs1, z3l1 = _drift(h01, xh1[u], a1[u], *w)
        coeffs = _coeffs(dw[u], i10[u], dt, rdt, rsq)

        df0 = gbar * (_ALPHA0 * dt)
        df1 = gbar * (_ALPHA1 * dt)
        dgs = [gbar * c for c in coeffs]
        dy = gbar
        dq = [torch.zeros_like(g) for g in gks]

        def g_bwd(i, dg):
            nonlocal dth
            dsg = dg * (1.0 - gs[i] * gs[i])
            dth = dth + (dsg * graws[i]).sum()
            dgraw = dsg * sth
            t_idx = (0, 1, 2, 1)[i]
            if mult_y:
                dq[t_idx] = dq[t_idx] + (dgraw * states[i]).sum(0)
                return dgraw * gks[t_idx]
            dq[t_idx] = dq[t_idx] + dgraw.sum(0)
            return torch.zeros_like(dg)

        # stage f1 (state H0_1 = y + 3/4 dt f0 + 3/2 (I10/dt) g0)
        dh01, dz1 = _drift_bwd(df1, h01, hs1, z3l1, wy, w_inner, wout,
                               geometric, acc)
        da1[u], dxh1[u] = dz1.sum(0), dz1
        dy = dy + dh01
        df0 = df0 + 0.75 * dt * dh01
        dgs[0] = dgs[0] + 1.5 * (i10[u] * rdt) * dh01
        # stage g3 (state H1_3 = y + dt/4 f0 + sqrt(dt)(-5 g0 + 3 g1 + g2/2))
        ds = g_bwd(3, dgs[3])
        dy = dy + ds
        df0 = df0 + 0.25 * dt * ds
        dgs[0] = dgs[0] - 5.0 * sq * ds
        dgs[1] = dgs[1] + 3.0 * sq * ds
        dgs[2] = dgs[2] + 0.5 * sq * ds
        # stage g2 (state H1_2 = y + dt f0 - sqrt(dt) g0)
        ds = g_bwd(2, dgs[2])
        dy = dy + ds
        df0 = df0 + dt * ds
        dgs[0] = dgs[0] - sq * ds
        # stage g1 (state H1_1 = y + dt/4 f0 + sqrt(dt)/2 g0)
        ds = g_bwd(1, dgs[1])
        dy = dy + ds
        df0 = df0 + 0.25 * dt * ds
        dgs[0] = dgs[0] + 0.5 * sq * ds
        # stage g0 (state y), then stage f0 (state y)
        dy = dy + g_bwd(0, dgs[0])
        dyf0, dz0 = _drift_bwd(df0, y, hs0, z3l0, wy, w_inner, wout,
                               geometric, acc)
        da0[u], dxh0[u] = dz0.sum(0), dz0
        for k in range(3):
            dgk[k][u] = dq[k]
        gbar = dy + dyf0
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return FusedSRKGrads(gbar, dxh0, dxh1, da0, da1, *dgk, dtheta, acc["wy"],
                         acc["w_inner"], acc["b_inner"], acc["wout"],
                         acc["bo"])


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_srk", "fused SRK", 18, 33)


def check_kernel_inputs(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
                        theta, wy, w_inner, b_inner, wout, bo, ys=None,
                        gys=None):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor,
    a shape that disagrees with y0/wy/w_inner/dts, or H, HH above
    MAX_WIDTH. Returns (M, B, H, HH, n_inner)."""
    M, B, H, HH, n_inner = dims = kernel_dims("fused SRK", y0, wy, w_inner,
                                              dts)
    s3, s3h, row, rowh = (M, B, H), (M, B, HH), (M, H), (M, HH)
    want = {"y0": (B, H), "xh0": s3h, "xh1": s3h, "dw": s3, "i10": s3,
            "a0": rowh, "a1": rowh, "gk0": row, "gk1": row, "gk2": row,
            "dts": (M,), "theta": (1,), "wy": (H, HH),
            "w_inner": (n_inner, HH, HH), "b_inner": (n_inner, HH),
            "wout": (HH, H), "bo": (H,), "ys": s3, "gys": s3}
    got = {"y0": y0, "xh0": xh0, "xh1": xh1, "dw": dw, "i10": i10, "a0": a0,
           "a1": a1, "gk0": gk0, "gk1": gk1, "gk2": gk2, "dts": dts,
           "theta": theta, "wy": wy, "w_inner": w_inner, "b_inner": b_inner,
           "wout": wout, "bo": bo, "ys": ys, "gys": gys}
    check_tensors("fused SRK", want, got, y0.device)
    return dims


def fused_srk_forward(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
                      theta, wy, w_inner, b_inner, wout, bo, *, mult_y: bool,
                      geometric: bool) -> torch.Tensor:
    """ys [M, B, H]: the CUDA forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global FWD_LAUNCHES
    args = (y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta, wy,
            w_inner, b_inner, wout, bo)
    if y0.device.type == "cpu":
        return fused_srk_forward_reference(*args, mult_y=mult_y,
                                           geometric=geometric)
    dims = check_kernel_inputs(*args)
    stream = _LIB.stream(y0, dims, backward=False)
    M, B, H, _, _ = dims
    ys = torch.empty((M, B, H), dtype=torch.float32, device=y0.device)
    _LIB.launch("fwd", args + (ys,), dims, mult_y, geometric, stream)
    FWD_LAUNCHES += 1
    return ys


def fused_srk_backward(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                       dts, theta, wy, w_inner, b_inner, wout, bo, *,
                       mult_y: bool, geometric: bool) -> FusedSRKGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: the CUDA
    backward kernel for CUDA tensors (per-block partials summed here), the
    plain version for CPU tensors."""
    global BWD_LAUNCHES
    args = (xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta, wy,
            w_inner, b_inner, wout, bo)
    if y0.device.type == "cpu":
        return fused_srk_backward_reference(y0, ys, gys, *args,
                                            mult_y=mult_y,
                                            geometric=geometric)
    dims = check_kernel_inputs(y0, *args, ys=ys, gys=gys)
    stream = _LIB.stream(y0, dims, backward=True)
    M, B, H, HH, n_inner = dims
    nb = -(-B // _LIB.rows_per_block())
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=y0.device)
    dxh0, dxh1, dy0 = empty(M, B, HH), empty(M, B, HH), empty(B, H)
    p_wy, p_wi, p_bi = (empty(nb, H, HH), empty(nb, n_inner, HH, HH),
                        empty(nb, n_inner, HH))
    p_wo, p_bo = empty(nb, HH, H), empty(nb, H)
    p_a0, p_a1 = empty(nb, M, HH), empty(nb, M, HH)
    p_gk = [empty(nb, M, H) for _ in range(3)]
    p_th = empty(nb)
    _LIB.launch("bwd", (y0, ys, gys) + args + (
        dxh0, dxh1, dy0, p_wy, p_wi, p_bi, p_wo, p_bo, p_a0, p_a1, *p_gk,
        p_th), dims, mult_y, geometric, stream)
    BWD_LAUNCHES += 1
    return FusedSRKGrads(dy0, dxh0, dxh1, p_a0.sum(0), p_a1.sum(0),
                         *(p.sum(0) for p in p_gk), p_th.sum(0, keepdim=True),
                         p_wy.sum(0), p_wi.sum(0), p_bi.sum(0), p_wo.sum(0),
                         p_bo.sum(0))


_ARG_ORDER = ("y0", "xh0", "xh1", "dw", "i10", "a0", "a1", "gk0", "gk1",
              "gk2", "dts", "theta", "wy", "w_inner", "b_inner", "wout", "bo")


class FusedSRK(torch.autograd.Function):
    """ys = SRIW1 solve over the merged drift; backward by the backward
    kernel. Inputs in _ARG_ORDER, then mult_y and geometric: y0 [B,H],
    xh0/xh1 [M,B,HH], dw/i10 [M,B,H] (not differentiated), a0/a1 [M,HH],
    gk0/gk1/gk2 [M,H], dts [M] (not differentiated), theta [1], wy [H,HH],
    w_inner [n_inner,HH,HH], b_inner [n_inner,HH], wout [HH,H], bo [H]."""

    @staticmethod
    def forward(ctx, *args):
        *tensors, mult_y, geometric = args
        ys = fused_srk_forward(*tensors, mult_y=mult_y, geometric=geometric)
        ctx.save_for_backward(*tensors, ys)
        ctx.flags = (bool(mult_y), bool(geometric))
        return ys

    @staticmethod
    def backward(ctx, gys):
        y0, *rest, ys = ctx.saved_tensors
        mult_y, geometric = ctx.flags
        gr = fused_srk_backward(y0, ys, gys.contiguous(), *rest,
                                mult_y=mult_y, geometric=geometric)
        return (gr.dy0, gr.dxh0, gr.dxh1, None, None, gr.da0, gr.da1,
                gr.dgk0, gr.dgk1, gr.dgk2, None, gr.dtheta, gr.dwy,
                gr.dw_inner, gr.db_inner, gr.dwout, gr.dbo, None, None)


# ---------------------------------------------------------------------------
# Public entry: solve a DiffusionField SDE with the fused SRK kernels
# ---------------------------------------------------------------------------

def fused_srk_inputs(field, path, grid: np.ndarray, y0: torch.Tensor,
                     dW: torch.Tensor, I10: torch.Tensor) -> dict:
    """The kernels' inputs for a supported field on a host step grid: the
    hoisted and merged precomputes at each stage time (drift at t and
    t + 3/4 dt, diffusion at t, t + dt/4 and t + dt; differentiable through
    autograd), the stacked weights in [in, out] layout, and the
    mult_y/geometric flags (snsde/kernels/fused_srk.py:724-818)."""
    check_supported(field, "fused SRK")
    io, no = field.input_option, field.noise_option
    dev, f32 = y0.device, torch.float32
    t0, dts = grid[:-1], np.diff(grid)
    td1, tn1 = t0 + 0.75 * dts, t0 + 0.25 * dts
    t = stage_times(dev, t0, td1, tn1, grid[1:], dts)
    xh0, a0 = merged_drift_rows(field, path, t0, t[0])
    xh1, a1 = merged_drift_rows(field, path, td1, t[1])
    gk = lambda tt: precomp_gk(field, tt).contiguous()
    return {"y0": y0.contiguous(), "xh0": xh0, "xh1": xh1,
            "dw": dW.to(device=dev, dtype=f32).contiguous(),
            "i10": I10.to(device=dev, dtype=f32).contiguous(),
            "a0": a0, "a1": a1, "gk0": gk(t[0]), "gk1": gk(t[2]),
            "gk2": gk(t[3]), "dts": t[4],
            "theta": field.theta.reshape(1),
            **merged_drift_weights(field, dev),
            "mult_y": no in MULT_Y_NO, "geometric": io in (5, 6)}


def fused_srk_solve(field, path, times, y0: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    dt: Optional[float] = None,
                    brownian_override=None) -> torch.Tensor:
    """SRIW1 solve of a supported DiffusionField through the fused kernels.
    Returns ys [T, B, H] on the output times (time-major). (dW, I10), each
    [M, B, H], come from `brownian_override` when given, else from
    `generator`, dW first and then the Lévy area, as `sdeint(method="srk")`
    draws them. Matches DiffusionField.f/g except for float32
    reassociation of the merged drift input."""
    from ..models.neuralsde import resolve_dt

    dt = resolve_dt(times) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    if brownian_override is None:
        shape = (y0.shape[0], field.hidden_channels)
        dW = brownian_increments(generator, grid, shape, torch.float32,
                                 y0.device)
        I10 = space_time_levy_area(generator, grid, shape, dW)
    else:
        dW, I10 = brownian_override
    inputs = fused_srk_inputs(field, path, grid, y0, dW, I10)
    ys = FusedSRK.apply(*(inputs[k] for k in _ARG_ORDER),
                        inputs["mult_y"], inputs["geometric"])
    full = torch.cat([y0[None], ys], dim=0)
    return full[torch.as_tensor(out_idx, device=y0.device)]
