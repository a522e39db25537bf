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
(~10 us at 67 TFLOP/s fp32 or 3.35 TB/s). Neither is the limit: the work is
a chain of 49 dependent steps, each two MLP evaluations of
[rows x 32] x [32 x 32] products with barriers between them, over only 1024
independent rows. The design is the EM kernels' (csrc/fused_srk.cu on
csrc/sde_hopper.cuh): a cluster keeps its weight slices, state, stage
states and activations in shared memory for the whole loop, with
register-tiled products on 512 threads and the step's streams copied a step
ahead; the backward runs only the dependent chain in its loop (f1, the
diffusion stages in reverse, f0), rebuilding each step beside the previous
step's chain, and writes the streams from which one weight-gradient kernel
forms the weight, bias and per-step gradients after the loop. Exact fp32 on
the CUDA cores; every partial summed here in a fixed order, so runs are
reproducible.

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
                      precomp_gk, stage_times, sum_wgrad_partials,
                      supports_fused, wgrad_partial_sizes)

__all__ = ["fused_srk_solve", "fused_srk_inputs", "supports_fused_srk",
           "FusedSRK", "fused_srk_forward", "fused_srk_backward",
           "fused_srk_backward_recurrence", "fused_srk_weight_grads",
           "fused_srk_forward_reference", "fused_srk_backward_reference",
           "fused_srk_backward_recurrence_reference",
           "fused_srk_weight_grads_reference", "fused_srk_plan",
           "force_srk_plan", "FusedSRKGrads", "SRKStreams",
           "SRKWeightGrads", "check_kernel_inputs"]

# launches of each CUDA kernel since the count was last set to 0: the
# forward, the backward recurrence and the weight gradient
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
WGRAD_LAUNCHES = 0

# the SRIW1 y-update weights (snsde/kernels/fused_srk.py:63-67)
_ALPHA0, _ALPHA1 = 1.0 / 3.0, 2.0 / 3.0
_BETA1 = (-1.0, 4.0 / 3.0, 2.0 / 3.0, 0.0)
_BETA2 = (-1.0, 4.0 / 3.0, -1.0 / 3.0, 0.0)
_BETA3 = (2.0, -4.0 / 3.0, -2.0 / 3.0, 0.0)
_BETA4 = (-2.0, 5.0 / 3.0, -2.0 / 3.0, 1.0)


# the SRK kernels take the EM kernels' modes
supports_fused_srk = supports_fused


class FusedSRKGrads(NamedTuple):
    """Cotangents of the fused SRK solve's inputs (every partial
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


class SRKStreams(NamedTuple):
    """What the backward recurrence leaves: the state's and theta's
    cotangents, and the streams of the weight gradient, evaluation 0 (f0,
    at t on y) before evaluation 1 (f1, at t + 3/4 dt on H0_1)."""
    dy0: torch.Tensor        # [B, H]
    dtheta: torch.Tensor     # [1]
    dxh: torch.Tensor        # [2, M, B, HH]: dz1 of f0 and f1 (dxh0, dxh1)
    hs: torch.Tensor         # [n_inner+1, 2, M, B, HH]: h_0..h_NI
    es: torch.Tensor         # [n_inner, 2, M, B, HH]: of h_1..h_NI's inputs
    dz3: torch.Tensor        # [2, M, B, H]: of z3 before the geometric factor
    h01: torch.Tensor        # [M, B, H]: H0_1, the state of f1
    q: torch.Tensor          # [3, M, B, H]: of the gk0, gk1, gk2 rows, by row


class SRKWeightGrads(NamedTuple):
    """The weight gradient's products over the recurrence's streams."""
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]
    da: torch.Tensor         # [2, M, HH]: da0, da1
    dgk: torch.Tensor        # [3, M, H]: dgk0, dgk1, dgk2


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


def _drift(y, xh, a, wy, w_inner, b_inner, wout, bo, geometric, relu):
    """The merged drift MLP: (f, hidden activations, z3 before the
    geometric factor)."""
    hs = [relu(y @ wy + a + xh)]
    for l in range(w_inner.shape[0]):
        hs.append(relu(hs[-1] @ w_inner[l] + b_inner[l]))
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
                                mult_y: bool, geometric: bool,
                                relu=torch.relu) -> torch.Tensor:
    """Eager SRIW1 loop over the merged drift: ys [M, B, H] (y after each
    step). Weights in [in, out] layout; theta [1]. Every relu of the drift
    MLP is `relu` (a stand-in may probe the pre-activations)."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu)
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


def _dz3(df, state, z3l, geometric):
    """Back through f = tanh(z3l (* tanh(state))) given df: (the state's
    cotangent, dz3 before the geometric factor)."""
    f_ty = torch.tanh(state)
    f = torch.tanh(z3l * f_ty if geometric else z3l)
    dz3 = df * (1.0 - f * f)
    if geometric:
        return dz3 * z3l * (1.0 - f_ty * f_ty), dz3 * f_ty
    return torch.zeros_like(state), dz3


def _mlp_back(dz3l, hs, w_inner, wout):
    """Back through one evaluation's MLP from dz3: (dz1, the cotangents of
    h_1..h_NI's inputs)."""
    dz = (dz3l @ wout.T) * (hs[-1] > 0)
    es = [None] * w_inner.shape[0]
    for l in range(w_inner.shape[0] - 1, -1, -1):
        es[l] = dz
        dz = (dz @ w_inner[l].T) * (hs[l] > 0)
    return dz, es


def _drift_bwd(df, state, hs, z3l, wy, w_inner, wout, geometric, acc):
    """Back through one drift evaluation given df = dL/df: adds the weight
    gradients into acc and returns (d state, dz1)."""
    dstate, dz3 = _dz3(df, state, z3l, geometric)
    dz, es = _mlp_back(dz3, hs, w_inner, wout)
    acc["wout"] += hs[-1].T @ dz3
    acc["bo"] += dz3.sum(0)
    for l in range(w_inner.shape[0] - 1, -1, -1):
        acc["w_inner"][l] += hs[l].T @ es[l]
        acc["b_inner"][l] += es[l].sum(0)
    acc["wy"] += state.T @ dz
    return dstate + dz @ wy.T, dz


def fused_srk_backward_reference(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0,
                                 gk1, gk2, dts, theta, wy, w_inner, b_inner,
                                 wout, bo, *, mult_y: bool, geometric: bool,
                                 relu=torch.relu) -> FusedSRKGrads:
    """Eager reverse loop mirroring the backward kernel (and the JAX
    `_bwd_kernel`): recompute every stage from the state before the step,
    then reverse the tableau in the order f1, g3, g2, g1, g0, f0. `relu`
    as in the forward; its derivative is read from its output (> 0)."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu)
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


def fused_srk_backward_recurrence_reference(y0, ys, gys, xh0, xh1, dw, i10,
                                            a0, a1, gk0, gk1, gk2, dts, theta,
                                            wy, w_inner, b_inner, wout, bo, *,
                                            mult_y: bool, geometric: bool,
                                            relu=torch.relu) -> SRKStreams:
    """The backward recurrence kernel's plain version: the reverse loop of
    fused_srk_backward_reference (the same tableau order f1, g3, g2, g1,
    g0, f0) without the weight gradients, recording instead the streams
    they are formed from (SRKStreams)."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu)
    M, n_inner = dts.shape[0], w_inner.shape[0]
    ev2 = (2,) + tuple(xh0.shape)
    hs_out = xh0.new_empty((n_inner + 1,) + ev2)
    es_out = xh0.new_empty((n_inner,) + ev2)
    dxh = xh0.new_empty(ev2)
    dz3s = gys.new_empty((2,) + tuple(gys.shape))
    qs = gys.new_empty((3,) + tuple(gys.shape))
    h01s = torch.empty_like(gys)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    gbar = torch.zeros_like(y0)
    for u in range(M - 1, -1, -1):
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
        dgs = [gbar * c for c in coeffs]
        dy = gbar
        dq = [None] * 4

        def g_bwd(i, dg):
            nonlocal dth
            dsg = dg * (1.0 - gs[i] * gs[i])
            dth = dth + (dsg * graws[i]).sum()
            dgraw = dsg * sth
            if mult_y:
                dq[i] = dgraw * states[i]
                return dgraw * gks[(0, 1, 2, 1)[i]]
            dq[i] = dgraw
            return torch.zeros_like(dg)

        # stage f1 (state H0_1)
        dh01, dz3_1 = _dz3(gbar * (_ALPHA1 * dt), h01, z3l1, geometric)
        dz1_1, es1 = _mlp_back(dz3_1, hs1, w_inner, wout)
        dh01 = dh01 + dz1_1 @ wy.T
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
        dyf0, dz3_0 = _dz3(df0, y, z3l0, geometric)
        dz1_0, es0 = _mlp_back(dz3_0, hs0, w_inner, wout)
        for ev, (hs_e, es_e, dz1, dz3) in enumerate(
                ((hs0, es0, dz1_0, dz3_0), (hs1, es1, dz1_1, dz3_1))):
            for l in range(n_inner + 1):
                hs_out[l, ev, u] = hs_e[l]
            for l in range(n_inner):
                es_out[l, ev, u] = es_e[l]
            dxh[ev, u], dz3s[ev, u] = dz1, dz3
        h01s[u] = h01
        qs[0, u], qs[1, u], qs[2, u] = dq[0], dq[3] + dq[1], dq[2]
        gbar = dy + dyf0 + dz1_0 @ wy.T
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return SRKStreams(gbar, dtheta, dxh, hs_out, es_out, dz3s, h01s, qs)


def fused_srk_weight_grads_reference(y0, ys, h01, dxh, hs, es, dz3,
                                     q) -> SRKWeightGrads:
    """The weight-gradient kernel's plain version: over K = 2 M B rows of
    the recurrence's streams (both evaluations), dWy' = sum x^T dz1 with x
    the state each first layer read (y_{u-1}, then H0_1), dW_l = sum h_l^T
    e_{l+1}, dWout = sum h_NI^T dz3 and the bias sums; da[e, u] and
    dgk[j, u] the step's column sums of dz1 and q."""
    _, M, B, H = dz3.shape
    HH, n_inner = dxh.shape[3], es.shape[0]
    x = torch.cat([y0[None], ys[:M - 1], h01]).reshape(-1, H)
    dwi = torch.stack([hs[l].reshape(-1, HH).T @ es[l].reshape(-1, HH)
                       for l in range(n_inner)]) if n_inner else \
        dxh.new_zeros((0, HH, HH))
    return SRKWeightGrads(
        x.T @ dxh.reshape(-1, HH), dwi, es.sum((1, 2, 3)),
        hs[n_inner].reshape(-1, HH).T @ dz3.reshape(-1, H),
        dz3.sum((0, 1, 2)), dxh.sum(2), q.sum(2))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_srk", "fused SRK", 18, 27,
                 shape_names=("B", "H", "HH", "n_inner"),
                 launches={"wgrad": 11},
                 int_fns={"plan": 6, "force_placement": 1, "force_plan": 2,
                          "wgrad_splits": 5})
_PLAN_FIELDS = ("level", "rows", "cluster", "active_clusters", "smem_bytes")


def fused_srk_plan(B: int, H: int, HH: int, n_inner: int,
                   backward: bool) -> dict:
    """The CUDA library's plan of an SRK launch: its level (0 the weight
    slices in shared memory, 1 the weights read from device memory,
    csrc/sde_hopper.cuh), batch rows and CTAs a cluster,
    cudaOccupancyMaxActiveClusters (a negative CUDA error when the plan
    cannot be scheduled) and the shared bytes a CTA. Needs the card."""
    shape = (B, H, HH, n_inner, int(backward))
    return {name: _LIB.call("plan", *shape, i)
            for i, name in enumerate(_PLAN_FIELDS)}


def force_srk_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make later launches take clusters of `cluster` CTAs and `rows`
    batch rows a cluster (0: the plan's own choice of each); for tests of
    each plan. Raises ValueError on a size the kernels do not take."""
    if _LIB.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no SRK plan with {cluster} CTAs and {rows} rows "
                         f"a cluster")
    _LIB._kept.clear()


def check_kernel_inputs(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
                        theta, wy, w_inner, b_inner, wout, bo, ys=None,
                        gys=None):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor,
    or a shape that disagrees with y0/wy/w_inner/dts. Every width is
    taken (the plan splits the weights over a cluster or reads them from
    device memory). Returns (M, B, H, HH, n_inner)."""
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


def _empty(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _launch_forward(dims, flags, tensors, stream) -> torch.Tensor:
    M, B, H, _, _ = dims
    ys = _empty(M, B, H, device=tensors[0].device)
    _LIB.launch("fwd", tensors + (ys,), dims + flags, stream)
    return ys


def _launch_recurrence(dims, flags, tensors, stream) -> SRKStreams:
    M, B, H, HH, n_inner = dims
    dev = tensors[0].device
    ctas = (-(-B // _LIB.rows(dims[1:], backward=True))
            * _LIB.kept("plan", B, H, HH, n_inner, 1, 2))
    dxh, dy0 = _empty(2, M, B, HH, device=dev), _empty(B, H, device=dev)
    hs, es = (_empty(n_inner + 1, 2, M, B, HH, device=dev),
              _empty(n_inner, 2, M, B, HH, device=dev))
    dz3, q = _empty(2, M, B, H, device=dev), _empty(3, M, B, H, device=dev)
    h01, p_th = _empty(M, B, H, device=dev), _empty(ctas, device=dev)
    _LIB.launch("bwd", tensors + (dxh, dy0, hs, es, dz3, q, h01, p_th),
                dims + flags, stream)
    return SRKStreams(dy0, p_th.sum(0, keepdim=True), dxh, hs, es, dz3, h01,
                      q)


def _launch_weight_grads(y0, ys, st: SRKStreams, stream) -> SRKWeightGrads:
    _, M, B, HH = st.dxh.shape
    H, n_inner = y0.shape[1], st.es.shape[0]
    S = _LIB.kept("wgrad_splits", M, B, H, HH, n_inner)
    p = _empty(sum(wgrad_partial_sizes(S, H, HH, n_inner)), device=y0.device)
    da = _empty(2, M, HH, device=y0.device)
    dgk = _empty(3, M, H, device=y0.device)
    _LIB.launch("wgrad", (y0, ys, st.h01, st.dxh, st.hs, st.es, st.dz3, st.q,
                          p, da, dgk), (M, B, H, HH, n_inner, 0, 0), stream)
    return SRKWeightGrads(*sum_wgrad_partials(p, S, H, HH, n_inner), da, dgk)


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
    stream = _LIB.stream(y0, dims[1:], backward=False)
    ys = _launch_forward(dims, (mult_y, geometric), args, stream)
    FWD_LAUNCHES += 1
    return ys


def fused_srk_backward_recurrence(y0, ys, gys, xh0, xh1, dw, i10, a0, a1,
                                  gk0, gk1, gk2, dts, theta, wy, w_inner,
                                  b_inner, wout, bo, *, mult_y: bool,
                                  geometric: bool) -> SRKStreams:
    """The reverse loop given gys = dL/dys (SRKStreams): the CUDA backward
    recurrence kernel for CUDA tensors (d theta's per-CTA partials summed
    here), the plain version for CPU tensors."""
    global BWD_LAUNCHES
    args = (y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
            theta, wy, w_inner, b_inner, wout, bo)
    if y0.device.type == "cpu":
        return fused_srk_backward_recurrence_reference(
            *args, mult_y=mult_y, geometric=geometric)
    dims = check_kernel_inputs(y0, *args[3:], ys=ys, gys=gys)
    stream = _LIB.stream(y0, dims[1:], backward=True)
    st = _launch_recurrence(dims, (mult_y, geometric), args, stream)
    BWD_LAUNCHES += 1
    return st


def fused_srk_weight_grads(y0, ys, st: SRKStreams) -> SRKWeightGrads:
    """The weight, bias and per-step gradients from the recurrence's
    streams (SRKWeightGrads): the CUDA weight-gradient kernel for CUDA
    tensors (its split partials summed here, in a fixed order), the plain
    version for CPU tensors."""
    global WGRAD_LAUNCHES
    if y0.device.type == "cpu":
        return fused_srk_weight_grads_reference(y0, ys, st.h01, st.dxh,
                                                st.hs, st.es, st.dz3, st.q)
    _, M, B, H = st.dz3.shape
    HH, n_inner = st.dxh.shape[3], st.es.shape[0]
    want = {"y0": (B, H), "ys": (M, B, H), "h01": (M, B, H),
            "dxh": (2, M, B, HH), "hs": (n_inner + 1, 2, M, B, HH),
            "es": (n_inner, 2, M, B, HH), "dz3": (2, M, B, H),
            "q": (3, M, B, H)}
    check_tensors("fused SRK", want, {"y0": y0, "ys": ys, "h01": st.h01,
                                      "dxh": st.dxh, "hs": st.hs,
                                      "es": st.es, "dz3": st.dz3,
                                      "q": st.q}, y0.device)
    stream = _LIB.stream(y0, (B, H, HH, n_inner), backward=True)
    out = _launch_weight_grads(y0, ys, st, stream)
    WGRAD_LAUNCHES += 1
    return out


def fused_srk_backward(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                       dts, theta, wy, w_inner, b_inner, wout, bo, *,
                       mult_y: bool, geometric: bool) -> FusedSRKGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: for CUDA
    tensors the backward recurrence kernel, then the weight-gradient
    kernel; for CPU tensors the plain reverse loop."""
    args = (y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
            theta, wy, w_inner, b_inner, wout, bo)
    if y0.device.type == "cpu":
        return fused_srk_backward_reference(*args, mult_y=mult_y,
                                            geometric=geometric)
    st = fused_srk_backward_recurrence(*args, mult_y=mult_y,
                                       geometric=geometric)
    w = fused_srk_weight_grads(y0, ys, st)
    return FusedSRKGrads(st.dy0, st.dxh[0], st.dxh[1], w.da[0], w.da[1],
                         w.dgk[0], w.dgk[1], w.dgk[2], st.dtheta, w.dwy,
                         w.dw_inner, w.db_inner, w.dwout, w.dbo)


_ARG_ORDER = ("y0", "xh0", "xh1", "dw", "i10", "a0", "a1", "gk0", "gk1",
              "gk2", "dts", "theta", "wy", "w_inner", "b_inner", "wout", "bo")


class FusedSRK(torch.autograd.Function):
    """ys = SRIW1 solve over the merged drift; backward by the backward
    recurrence and weight-gradient kernels. Inputs in _ARG_ORDER, then
    mult_y and geometric: y0 [B,H], xh0/xh1 [M,B,HH], dw/i10 [M,B,H] (not
    differentiated), a0/a1 [M,HH], gk0/gk1/gk2 [M,H], dts [M] (not
    differentiated), theta [1], wy [H,HH], w_inner [n_inner,HH,HH],
    b_inner [n_inner,HH], wout [HH,H], bo [H]."""

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
