"""Fused SRIW1 (stochastic Runge–Kutta, strong order 1.5) solve: two
hand-written CUDA kernels for Hopper (snsde_torch/csrc/fused_srk.cu) behind
a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_srk.py —
`_fused_srk_forward` (pallas_call at :295, body `_fwd_kernel` :215, step
`_srk_step` :158) and `_fused_srk_backward` (pallas_call at :527, body
`_bwd_kernel` :317), the custom VJP `_fused_srk` (:599-636) — for the modes
of the EM kernels, every DiffusionField configuration: drift mode 'embm'
(the merged emb drift, input_option 2, 4 or 6), 'yy' (1, 3, 5) or 'xt'
(0); noise mode 'precomp' (noise_option 0-6, 11-13, 16, 17), 'elem'
(7-10), 'net1' (14/15) or 'net2' (18/19); mult_y on or off, geometric on
or off. Each drift and noise mode is an instance of the kernels.

Per step the tableau needs two drift MLP evaluations (at t and at
t + 3/4 dt) and four elementwise diffusion evaluations at three stage times
(t, t + dt/4 twice, t + dt); the y-update weighs them with coefficients
built from dW and the space-time Lévy area I10. As for the EM kernels, the
y-independent parts stay outside the kernels as plain matrix products
whose gradients come from torch autograd, once per stage time: the hoist
xh' (xh0 at t, xh1 at t + 3/4 dt), the merged a' rows (a0, a1) and the
diffusion magnitudes gk (gk0 at t, gk1 at t + dt/4, gk2 at t + dt), or the
noise net's an1 rows at the same times. A noise net makes each diffusion
evaluation one or two products on its stage's state; the forward then also
returns the stage states and the nets' outputs and hidden activations
(SRKNoise), which the backward reads back.

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
the CUDA cores by default; every partial summed here in a fixed order, so
runs are reproducible.

The JAX kernels' reduced precisions (K4) are kernels of their own
(csrc/fused_srk_red.cu), so the fp32 instances above compile as they did:
bf16 streams (xh0, xh1, dw, i10, ys, gys, and dxh0/dxh1 handed back, in
bf16; the forward's carry and stage states fp32 and only the trajectory
rounded, `fused_srk.py:230`; the backward recomputing each step, the noise
nets too, from the rounded state, y0 rounded too, `:473`) and bf16x3 or
bf16 operands of every in-kernel product (`fused_em.py:_dot`, the weight
gradient's too), accumulating in fp32. The entries take `stream_dtype=` and
`matmul=`, None resolving from SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL as
the JAX entry does (`_solver.resolve_precision`).

Each kernel has a plain PyTorch version beside it with the same inputs and
outputs. `fused_srk_forward`/`fused_srk_backward` take the plain versions
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.brownian import brownian_increments, space_time_levy_area
from ..ops.solve import make_grid
from ._solver import (SDE_INT_NAMES, SDE_SHAPE_NAMES, SdeModes, SolverLib,
                      bf16_round, check_mode, check_supported, check_tensors,
                      count_precision, drift_input, drift_rows,
                      drift_weights, is_net, kernel_dims, member_count,
                      member_shapes, mm_op, mode_codes, noise_back,
                      noise_base, noise_rows, noise_weights, per_member,
                      precision_counts, precision_ints, resolve_precision,
                      sde_mode, sde_modes, select_member, split_weight_grads,
                      stack_members, stage_times, supports_fused,
                      wgrad_partial_sizes, widen, widen_output)

__all__ = ["fused_srk_solve", "fused_srk_inputs", "supports_fused_srk",
           "FusedSRK", "fused_srk_forward", "fused_srk_backward",
           "fused_srk_backward_recurrence", "fused_srk_weight_grads",
           "fused_srk_forward_reference", "fused_srk_backward_reference",
           "fused_srk_backward_recurrence_reference",
           "fused_srk_weight_grads_reference", "fused_srk_plan",
           "force_srk_plan", "FusedSRKGrads", "FusedSRKNetGrads",
           "SRKNoise", "SRKStreams", "SRKWeightGrads", "check_kernel_inputs"]

# launches of each CUDA kernel since the count was last set to 0: the
# forward, the backward recurrence and the weight gradient, solo and (the
# PACKED_ counts) with a member axis
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
WGRAD_LAUNCHES = 0
PACKED_FWD_LAUNCHES = 0
PACKED_BWD_LAUNCHES = 0
PACKED_WGRAD_LAUNCHES = 0

# the SRIW1 y-update weights (snsde/kernels/fused_srk.py:63-67)
_ALPHA0, _ALPHA1 = 1.0 / 3.0, 2.0 / 3.0
_BETA1 = (-1.0, 4.0 / 3.0, 2.0 / 3.0, 0.0)
_BETA2 = (-1.0, 4.0 / 3.0, -1.0 / 3.0, 0.0)
_BETA3 = (2.0, -4.0 / 3.0, -2.0 / 3.0, 0.0)
_BETA4 = (-2.0, 5.0 / 3.0, -2.0 / 3.0, 1.0)
# the stage time (row) of each diffusion stage: t, t + dt/4, t + dt, t + dt/4
_STAGE_ROW = (0, 1, 2, 1)

supports_fused_srk = supports_fused


class FusedSRKGrads(NamedTuple):
    """Cotangents of the fused SRK solve's inputs (every partial summed);
    None for an input the mode does not take."""
    dy0: torch.Tensor        # [B, H]
    dxh0: torch.Tensor       # [M, B, HH] (None in drift mode 'yy')
    dxh1: torch.Tensor       # [M, B, HH]
    da0: torch.Tensor        # [M, HH] (None in 'xt')
    da1: torch.Tensor        # [M, HH]
    dgk0: torch.Tensor       # [M, H]: of gk0, or of the nets' an1 rows
    dgk1: torch.Tensor       # [M, H]
    dgk2: torch.Tensor       # [M, H]
    dtheta: torch.Tensor     # [1]
    dwy: torch.Tensor        # [H, HH] (None in 'xt')
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]


class FusedSRKNetGrads(NamedTuple):
    """FusedSRKGrads and the noise net's weights' cotangents (the nets'
    modes; dwn2 and dbn2 None for net1)."""
    dy0: torch.Tensor
    dxh0: torch.Tensor
    dxh1: torch.Tensor
    da0: torch.Tensor
    da1: torch.Tensor
    dgk0: torch.Tensor
    dgk1: torch.Tensor
    dgk2: torch.Tensor
    dtheta: torch.Tensor
    dwy: torch.Tensor
    dw_inner: torch.Tensor
    db_inner: torch.Tensor
    dwout: torch.Tensor
    dbo: torch.Tensor
    dwn1: torch.Tensor       # [H, H]
    dwn2: torch.Tensor       # [H, H]
    dbn2: torch.Tensor       # [H]


class SRKNoise(NamedTuple):
    """What the forward leaves of a noise net, read back by the backward."""
    nst: torch.Tensor        # [3, M, B, H]: the states of stages 1-3
    nb: torch.Tensor         # [4, M, B, H]: the net's output by stage
    nh: torch.Tensor         # [4, M, B, H]: net2's hidden activations


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
    dn: Optional[torch.Tensor] = None   # [4, M, B, H]: of a net's 1st layer
    dz2: Optional[torch.Tensor] = None  # [4, M, B, H]: of net2's 2nd layer
    # a reduced precision's recomputed noise nets (else the forward's
    # SRKNoise holds them): the states of stages 1-3 and net2's hidden
    # activations
    nst: Optional[torch.Tensor] = None  # [3, M, B, H]
    nh: Optional[torch.Tensor] = None   # [4, M, B, H]


class SRKWeightGrads(NamedTuple):
    """The weight gradient's products over the recurrence's streams."""
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]
    da: torch.Tensor         # [2, M, HH]: da0, da1
    dgk: torch.Tensor        # [3, M, H]: dgk0, dgk1, dgk2
    dwn1: Optional[torch.Tensor] = None
    dwn2: Optional[torch.Tensor] = None
    dbn2: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _reduced(stream: str, matmul: str) -> bool:
    """A reduced precision: bf16 streams or bf16 / bf16x3 operands."""
    return stream == "bf16" or matmul != "f32"


def _backward_states(y0, ys, gys, xh0, xh1, dw, i10, stream):
    """What a reverse loop reads, in y0's dtype: the initial state (with
    bf16 streams rounded as the trajectory is, fused_srk.py:473), ys,
    gys and the streams widened."""
    y0r = bf16_round(y0) if stream == "bf16" else y0
    return (y0r,) + tuple(widen(t, y0) for t in (ys, gys, xh0, xh1, dw,
                                                  i10))


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


def _drift(y, u, xh, a, wy, w_inner, b_inner, wout, bo, geometric, relu,
           drift, matmul="f32"):
    """One drift MLP evaluation at step u, its products in operand mode
    `matmul`: (f, hidden activations, z3 before the geometric factor)."""
    hs = [relu(drift_input(y, u, xh, a, wy, drift, matmul))]
    for l in range(w_inner.shape[0]):
        hs.append(relu(mm_op(hs[-1], w_inner[l], matmul) + b_inner[l]))
    z3l = mm_op(hs[-1], wout, matmul) + bo
    return torch.tanh(z3l * torch.tanh(y) if geometric else z3l), hs, z3l


class _Stages(NamedTuple):
    states: list
    bases: list
    hns: list
    graws: list
    gs: list
    h01: torch.Tensor


def _stages(y, f0, rows, i10, sth, dt, sq, rdt, mult_y, noise, elem, nw,
            relu, saved=None, matmul="f32"):
    """The four diffusion stages (snsde/kernels/fused_srk.py:173-190):
    states, bases, net2's hidden activations, raw diffusions, bounded g's
    and H0_1. rows = the step's three rows (gk or an1; None for 'elem');
    stages 0-3 evaluate at rows (0, 1, 2, 1). `saved` (the nets: (stage
    states 1-3, bases, hidden activations) of the step from the forward)
    replaces the recompute of the nets, whose products take operand mode
    `matmul`."""
    st, bs, hn, graws, gs = [], [], [], [], []

    def ev(i, state):
        if saved is None:
            row = None if rows is None else rows[_STAGE_ROW[i]]
            base, h = noise_base(state, row, noise, elem, *nw, relu, matmul)
        else:
            state = y if i == 0 else saved[0][i - 1]
            base, h = saved[1][i], None if saved[2] is None else saved[2][i]
        graw = base * state if mult_y else base
        st.append(state)
        bs.append(base)
        hn.append(h)
        graws.append(graw)
        gs.append(torch.tanh(sth * graw))

    ev(0, y)
    ev(1, y + 0.25 * dt * f0 + 0.5 * sq * gs[0])
    ev(2, y + dt * f0 - sq * gs[0])
    ev(3, y + 0.25 * dt * f0 + sq * (-5.0 * gs[0] + 3.0 * gs[1]
                                     + 0.5 * gs[2]))
    h01 = y + 0.75 * dt * f0 + 1.5 * (i10 * rdt) * gs[0]
    return _Stages(st, bs, hn, graws, gs, h01)


def _rows(gk0, gk1, gk2, u):
    return None if gk0 is None else (gk0[u], gk1[u], gk2[u])


def fused_srk_forward_reference(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                                dts, theta, wy, w_inner, b_inner, wout, bo,
                                wn1=None, wn2=None, bn2=None, *,
                                mult_y: bool, geometric: bool,
                                drift: str = "embm", noise: str = "precomp",
                                elem: int = 0, stream: str = "f32",
                                matmul: str = "f32", relu=torch.relu):
    """Eager SRIW1 loop over the field's drift and diffusion: ys [M, B, H]
    (y after each step), and in the nets' modes (ys, SRKNoise). Weights in
    [in, out] layout; theta [1]; the gk rows hold the an1 rows in the nets'
    modes. Every relu of the drift MLP and the noise net is `relu` (a
    stand-in may probe the pre-activations). Every product takes operand
    mode `matmul` (mm_op). With `stream` 'bf16' (the JAX kernel's
    traj_bf16), xh0, xh1, dw and i10 arrive in bf16, the carry and the
    stage states stay in y0's dtype and only the written trajectory is
    rounded (snsde/kernels/fused_srk.py:230). In a reduced precision the
    backward recomputes the noise nets from the rounded state, as the JAX
    kernel does, so no SRKNoise is kept (None)."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu, drift, matmul)
    nw = (wn1, wn2, bn2)
    xh0, xh1, dw, i10 = (widen(t, y0) for t in (xh0, xh1, dw, i10))
    y = y0
    ys, nst, nb, nh = [], [], [], []
    for u in range(dts.shape[0]):
        dt = dts[u]
        sq, rdt, rsq = _step_consts(dt)
        f0 = _drift(y, u, xh0, a0, *w)[0]
        s = _stages(y, f0, _rows(gk0, gk1, gk2, u), i10[u], sth, dt, sq, rdt,
                    mult_y, noise, elem, nw, relu, matmul=matmul)
        f1 = _drift(s.h01, u, xh1, a1, *w)[0]
        y1 = y + dt * (_ALPHA0 * f0 + _ALPHA1 * f1)
        for c, g in zip(_coeffs(dw[u], i10[u], dt, rdt, rsq), s.gs):
            y1 = y1 + c * g
        nst.append(torch.stack(s.states[1:]))
        nb.append(torch.stack(s.bases))
        if noise == "net2":
            nh.append(torch.stack(s.hns))
        y = y1
        ys.append(y)
    ys = torch.stack(ys)
    if stream == "bf16":
        ys = ys.to(torch.bfloat16)
    if not is_net(noise) or _reduced(stream, matmul):
        return ys, None
    return ys, SRKNoise(torch.stack(nst, 1), torch.stack(nb, 1),
                        torch.stack(nh, 1) if nh else None)


def _dz3(df, state, z3l, geometric):
    """Back through f = tanh(z3l (* tanh(state))) given df: (the state's
    cotangent, dz3 before the geometric factor)."""
    f_ty = torch.tanh(state)
    f = torch.tanh(z3l * f_ty if geometric else z3l)
    dz3 = df * (1.0 - f * f)
    if geometric:
        return dz3 * z3l * (1.0 - f_ty * f_ty), dz3 * f_ty
    return torch.zeros_like(state), dz3


def _mlp_back(dz3l, hs, w_inner, wout, matmul="f32"):
    """Back through one evaluation's MLP from dz3, its products in operand
    mode `matmul`: (dz1, the cotangents of h_1..h_NI's inputs)."""
    dz = mm_op(dz3l, wout.T, matmul) * (hs[-1] > 0)
    es = [None] * w_inner.shape[0]
    for l in range(w_inner.shape[0] - 1, -1, -1):
        es[l] = dz
        dz = mm_op(dz, w_inner[l].T, matmul) * (hs[l] > 0)
    return dz, es


def _drift_bwd(df, state, hs, z3l, wy, w_inner, wout, geometric, acc,
               drift, matmul="f32"):
    """Back through one drift evaluation given df = dL/df: adds the weight
    gradients into acc and returns (d state, dz1); every product in
    operand mode `matmul`."""
    mm = lambda p, q: mm_op(p, q, matmul)
    dstate, dz3 = _dz3(df, state, z3l, geometric)
    dz, es = _mlp_back(dz3, hs, w_inner, wout, matmul)
    acc["wout"] += mm(hs[-1].T, dz3)
    acc["bo"] += dz3.sum(0)
    for l in range(w_inner.shape[0] - 1, -1, -1):
        acc["w_inner"][l] += mm(hs[l].T, es[l])
        acc["b_inner"][l] += es[l].sum(0)
    if drift == "xt":
        return dstate, dz
    acc["wy"] += mm(state.T, dz)
    return dstate + mm(dz, wy.T), dz


def _saved(ns, u, noise):
    """The forward's stage values of step u for the nets' backward."""
    if not is_net(noise):
        return None
    if ns is None:
        raise ValueError("the noise nets' backward takes the forward's "
                         "SRKNoise (ns=)")
    return (ns.nst[:, u], ns.nb[:, u], None if ns.nh is None else ns.nh[:, u])


def _reverse_stages(s, gbar, dh01, dt, sq, rdt, i10, coeffs, sth, mult_y,
                    noise, elem, nw, on_stage, matmul="f32"):
    """Reverse the diffusion stages of a step, g3, g2, g1, g0, given the
    state's cotangent gbar and H0_1's dh01: (y's cotangent, f0's, theta's
    sum). on_stage(i, dbase, dn, dz2) sees each stage's cotangents."""
    df0 = gbar * (_ALPHA0 * dt) + 0.75 * dt * dh01
    dgs = [gbar * c for c in coeffs]
    dgs[0] = dgs[0] + 1.5 * (i10 * rdt) * dh01
    dy = gbar + dh01
    dth = torch.zeros((), dtype=gbar.dtype, device=gbar.device)

    def g_bwd(i, dg):
        nonlocal dth
        dsg = dg * (1.0 - s.gs[i] * s.gs[i])
        dth = dth + (dsg * s.graws[i]).sum()
        dgraw = dsg * sth
        if mult_y:
            dbase, ds = dgraw * s.states[i], dgraw * s.bases[i]
        else:
            dbase, ds = dgraw, torch.zeros_like(dg)
        dyn, dn, dz2 = noise_back(dbase, s.states[i], s.bases[i], s.hns[i],
                                   noise, elem, nw[0], nw[1], matmul)
        on_stage(i, dbase, dn, dz2)
        return ds + dyn

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
    # stage g0 (state y)
    dy = dy + g_bwd(0, dgs[0])
    return dy, df0, dth


def fused_srk_backward_reference(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0,
                                 gk1, gk2, dts, theta, wy, w_inner, b_inner,
                                 wout, bo, wn1=None, wn2=None, bn2=None, *,
                                 mult_y: bool, geometric: bool,
                                 drift: str = "embm", noise: str = "precomp",
                                 elem: int = 0,
                                 ns: Optional[SRKNoise] = None,
                                 stream: str = "f32", matmul: str = "f32",
                                 relu=torch.relu):
    """Eager reverse loop mirroring the JAX `_bwd_kernel`: recompute every
    stage from the state before the step (the nets' stage values read from
    the forward's `ns` in exact fp32; recomputed in a reduced precision),
    then reverse the tableau in the order f1, g3, g2, g1, g0, f0. `relu`
    as in the forward; its derivative is read from its output (> 0). Every
    product, the weight gradients' too, takes operand mode `matmul`; with
    `stream` 'bf16' the states are the rounded trajectory's (y0 rounded
    too), xh0, xh1, dw, i10 and gys arrive in bf16 and dxh0 and dxh1 leave
    in bf16 (fused_srk.py:480-481), every other cotangent in y0's dtype.
    FusedSRKGrads, FusedSRKNetGrads in the nets' modes."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu, drift, matmul)
    nw = (wn1, wn2, bn2)
    red = _reduced(stream, matmul)
    dxh_dtype = None if xh0 is None else xh0.dtype
    y0, ys, gys, xh0, xh1, dw, i10 = _backward_states(y0, ys, gys, xh0, xh1,
                                                      dw, i10, stream)
    mm = lambda p, q: mm_op(p, q, matmul)
    z = lambda t: None if t is None else torch.zeros_like(t)
    e = lambda t: None if t is None else torch.empty_like(t)
    acc = {"wy": z(wy), "w_inner": torch.zeros_like(w_inner),
           "b_inner": torch.zeros_like(b_inner),
           "wout": torch.zeros_like(wout), "bo": torch.zeros_like(bo),
           "wn1": z(wn1), "wn2": z(wn2), "bn2": z(bn2)}
    dxh0, dxh1, da0, da1 = e(xh0), e(xh1), e(a0), e(a1)
    dgk = [e(g) for g in (gk0, gk1, gk2)]
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    gbar = torch.zeros_like(y0)
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        dt = dts[u]
        sq, rdt, rsq = _step_consts(dt)
        f0, hs0, z3l0 = _drift(y, u, xh0, a0, *w)
        s = _stages(y, f0, _rows(gk0, gk1, gk2, u), i10[u], sth, dt, sq, rdt,
                    mult_y, noise, elem, nw, relu,
                    None if red else _saved(ns, u, noise), matmul)
        _, hs1, z3l1 = _drift(s.h01, u, xh1, a1, *w)
        coeffs = _coeffs(dw[u], i10[u], dt, rdt, rsq)
        dq = [0.0, 0.0, 0.0]

        def on_stage(i, dbase, dn, dz2):
            r = _STAGE_ROW[i]
            if noise == "precomp":
                dq[r] = dq[r] + dbase.sum(0)
            elif is_net(noise):
                dq[r] = dq[r] + dn.sum(0)
                acc["wn1"] += mm(s.states[i].T, dn)
                if noise == "net2":
                    acc["wn2"] += mm(s.hns[i].T, dz2)
                    acc["bn2"] += dz2.sum(0)

        # stage f1 (state H0_1 = y + 3/4 dt f0 + 3/2 (I10/dt) g0)
        dh01, dz1 = _drift_bwd(gbar * (_ALPHA1 * dt), s.h01, hs1, z3l1, wy,
                               w_inner, wout, geometric, acc, drift, matmul)
        if da1 is not None:
            da1[u] = dz1.sum(0)
        if dxh1 is not None:
            dxh1[u] = dz1
        dy, df0, dth_u = _reverse_stages(s, gbar, dh01, dt, sq, rdt, i10[u],
                                         coeffs, sth, mult_y, noise, elem,
                                         nw, on_stage, matmul)
        dth = dth + dth_u
        # stage f0 (state y)
        dyf0, dz0 = _drift_bwd(df0, y, hs0, z3l0, wy, w_inner, wout,
                               geometric, acc, drift, matmul)
        if da0 is not None:
            da0[u] = dz0.sum(0)
        if dxh0 is not None:
            dxh0[u] = dz0
        if dgk[0] is not None:
            for k in range(3):
                dgk[k][u] = dq[k]
        gbar = dy + dyf0
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    if dxh0 is not None:
        dxh0, dxh1 = dxh0.to(dxh_dtype), dxh1.to(dxh_dtype)
    out = (gbar, dxh0, dxh1, da0, da1, *dgk, dtheta, acc["wy"],
           acc["w_inner"], acc["b_inner"], acc["wout"], acc["bo"])
    if is_net(noise):
        return FusedSRKNetGrads(*out, acc["wn1"], acc["wn2"], acc["bn2"])
    return FusedSRKGrads(*out)


def fused_srk_backward_recurrence_reference(y0, ys, gys, xh0, xh1, dw, i10,
                                            a0, a1, gk0, gk1, gk2, dts, theta,
                                            wy, w_inner, b_inner, wout, bo,
                                            wn1=None, wn2=None, bn2=None, *,
                                            mult_y: bool, geometric: bool,
                                            drift: str = "embm",
                                            noise: str = "precomp",
                                            elem: int = 0,
                                            ns: Optional[SRKNoise] = None,
                                            stream: str = "f32",
                                            matmul: str = "f32",
                                            relu=torch.relu) -> SRKStreams:
    """The backward recurrence kernel's plain version: the reverse loop of
    fused_srk_backward_reference (the same tableau order f1, g3, g2, g1,
    g0, f0) without the weight gradients, recording instead the streams
    they are formed from (SRKStreams: q in mode 'precomp', dn in the nets'
    modes, dz2 in net2's; None otherwise), each in y0's dtype whatever the
    stream dtype (dxh too: the weight gradient reads dz1 unrounded). In a
    reduced precision the nets are recomputed, and their stage states and
    hidden activations recorded as nst and nh."""
    sth = torch.sigmoid(theta.reshape(()))
    w = (wy, w_inner, b_inner, wout, bo, geometric, relu, drift, matmul)
    nw = (wn1, wn2, bn2)
    red = _reduced(stream, matmul)
    y0, ys, gys, xh0, xh1, dw, i10 = _backward_states(y0, ys, gys, xh0, xh1,
                                                      dw, i10, stream)
    mm = lambda p, q: mm_op(p, q, matmul)
    M, n_inner = dts.shape[0], w_inner.shape[0]
    B, HH = y0.shape[0], wout.shape[0]
    ev2 = (2, M, B, HH)
    hs_out = y0.new_empty((n_inner + 1,) + ev2)
    es_out = y0.new_empty((n_inner,) + ev2)
    dxh = y0.new_empty(ev2)
    dz3s = gys.new_empty((2,) + tuple(gys.shape))
    qs = gys.new_empty((3,) + tuple(gys.shape)) if noise == "precomp" else None
    dns = gys.new_empty((4,) + tuple(gys.shape)) if is_net(noise) else None
    dz2s = gys.new_empty((4,) + tuple(gys.shape)) if noise == "net2" else None
    nsts = (gys.new_empty((3,) + tuple(gys.shape))
            if red and is_net(noise) else None)
    nhs = dz2s.new_empty(dz2s.shape) if red and dz2s is not None else None
    h01s = torch.empty_like(gys)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    gbar = torch.zeros_like(y0)
    for u in range(M - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        dt = dts[u]
        sq, rdt, rsq = _step_consts(dt)
        f0, hs0, z3l0 = _drift(y, u, xh0, a0, *w)
        s = _stages(y, f0, _rows(gk0, gk1, gk2, u), i10[u], sth, dt, sq, rdt,
                    mult_y, noise, elem, nw, relu,
                    None if red else _saved(ns, u, noise), matmul)
        _, hs1, z3l1 = _drift(s.h01, u, xh1, a1, *w)
        coeffs = _coeffs(dw[u], i10[u], dt, rdt, rsq)
        dq = [None] * 4
        if nsts is not None:
            nsts[:, u] = torch.stack(s.states[1:])
        if nhs is not None:
            nhs[:, u] = torch.stack(s.hns)

        def on_stage(i, dbase, dn, dz2):
            dq[i] = dbase
            if dns is not None:
                dns[i, u] = dn
            if dz2s is not None:
                dz2s[i, u] = dz2

        # stage f1 (state H0_1)
        dh01, dz3_1 = _dz3(gbar * (_ALPHA1 * dt), s.h01, z3l1, geometric)
        dz1_1, es1 = _mlp_back(dz3_1, hs1, w_inner, wout, matmul)
        if drift != "xt":
            dh01 = dh01 + mm(dz1_1, wy.T)
        dy, df0, dth_u = _reverse_stages(s, gbar, dh01, dt, sq, rdt, i10[u],
                                         coeffs, sth, mult_y, noise, elem,
                                         nw, on_stage, matmul)
        dth = dth + dth_u
        dyf0, dz3_0 = _dz3(df0, y, z3l0, geometric)
        dz1_0, es0 = _mlp_back(dz3_0, hs0, w_inner, wout, matmul)
        for ev, (hs_e, es_e, dz1, dz3) in enumerate(
                ((hs0, es0, dz1_0, dz3_0), (hs1, es1, dz1_1, dz3_1))):
            for l in range(n_inner + 1):
                hs_out[l, ev, u] = hs_e[l]
            for l in range(n_inner):
                es_out[l, ev, u] = es_e[l]
            dxh[ev, u], dz3s[ev, u] = dz1, dz3
        h01s[u] = s.h01
        if qs is not None:
            qs[0, u], qs[1, u], qs[2, u] = dq[0], dq[3] + dq[1], dq[2]
        gbar = dy + dyf0
        if drift != "xt":
            gbar = gbar + mm(dz1_0, wy.T)
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return SRKStreams(gbar, dtheta, dxh, hs_out, es_out, dz3s, h01s, qs, dns,
                      dz2s, nsts, nhs)


def fused_srk_weight_grads_reference(y0, ys, h01, dxh, hs, es, dz3, q,
                                     nst=None, dn=None, dz2=None, nh=None, *,
                                     drift: str = "embm",
                                     noise: str = "precomp",
                                     matmul: str = "f32") -> SRKWeightGrads:
    """The weight-gradient kernel's plain version: over K = 2 M B rows of
    the recurrence's streams (both evaluations), dWy' = sum x^T dz1 with x
    the state each first layer read (y_{u-1}, then H0_1; not in drift mode
    'xt'), dW_l = sum h_l^T e_{l+1}, dWout = sum h_NI^T dz3 and the bias
    sums; da[e, u] the step's column sums of dz1 (not in 'xt'); dgk[j, u]
    those of q ('precomp') or of dn (the nets, by stage time: stages 1 and
    3 summed). A net's over K = 4 M B rows (the stages): dWn1 = sum st^T dn
    over the stage states st (y_{u-1}, then nst), and net2's dWn2 = sum
    nh^T dz2 and dbn2. The products take operand mode `matmul`, the sums
    stay exact; y0 and ys are the states the recurrence read (bf16 ones
    widened to dxh's dtype)."""
    _, M, B, H = dz3.shape
    HH, n_inner = dxh.shape[3], es.shape[0]
    xt = drift == "xt"
    mm = lambda p, q_: mm_op(p, q_, matmul)
    y_prev = torch.cat([y0[None], ys[:M - 1]]).to(dxh.dtype)
    x = torch.cat([y_prev, h01]).reshape(-1, H)
    dwi = torch.stack([mm(hs[l].reshape(-1, HH).T, es[l].reshape(-1, HH))
                       for l in range(n_inner)]) if n_inner else \
        dxh.new_zeros((0, HH, HH))
    if noise == "precomp":
        dgk = q.sum(2)
    elif is_net(noise):
        d4 = dn.sum(2)
        dgk = torch.stack([d4[0], d4[1] + d4[3], d4[2]])
    else:
        dgk = None
    out = (None if xt else mm(x.T, dxh.reshape(-1, HH)), dwi,
           es.sum((1, 2, 3)),
           mm(hs[n_inner].reshape(-1, HH).T, dz3.reshape(-1, H)),
           dz3.sum((0, 1, 2)), None if xt else dxh.sum(2), dgk)
    if not is_net(noise):
        return SRKWeightGrads(*out)
    st = torch.cat([y_prev[None], nst]).reshape(-1, H)
    dwn1 = mm(st.T, dn.reshape(-1, H))
    if noise == "net1":
        return SRKWeightGrads(*out, dwn1)
    return SRKWeightGrads(*out, dwn1,
                          mm(nh.reshape(-1, H).T, dz2.reshape(-1, H)),
                          dz2.sum((0, 1, 2)))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# the library, built and loaded at first launch
_LIB = SolverLib("fused_srk", "fused SRK", 24, 35, int_names=SDE_INT_NAMES,
                 shape_names=SDE_SHAPE_NAMES, launches={"wgrad": 16},
                 int_fns={"plan": 9, "force_placement": 1, "force_plan": 2,
                          "wgrad_splits": 7})
# the reduced precisions' library (csrc/fused_srk_red.cu): kernels of
# their own, so that the fp32 instances above compile as they did; its
# launches take the operand mode (MATMUL_CODE) and the stream flag (1: bf16
# streams) after the members
_RED = SolverLib("fused_srk_red", "fused SRK (reduced precision)", 21, 35,
                 int_names=SDE_INT_NAMES + ("matmul", "stream"),
                 shape_names=SDE_SHAPE_NAMES, launches={"wgrad": 16},
                 int_fns={"plan": 9, "wgrad_splits": 7})
_PLAN_FIELDS = ("level", "rows", "cluster", "active_clusters", "smem_bytes")
# the member axis of a packed launch's streams (SRKStreams, SRKNoise; 0
# where not named): an evaluation's or stage's stream holds every member's
# steps ([E, K, M, B, ...])
_STREAM_AXES = {"dxh": 1, "hs": 2, "es": 2, "dz3": 1, "q": 1, "dn": 1,
                "dz2": 1, "nst": 1, "nb": 1, "nh": 1}
# the streams held in the stream dtype (bf16 with bf16 streams)
_BF16_STREAMS = ("xh0", "xh1", "dw", "i10", "ys", "gys")
# launches of the reduced precisions' kernels (their own kernels, solo or
# packed), keyed "<kernel> <operand mode> <stream dtype>"
PRECISION_LAUNCHES = precision_counts(("fwd", "bwd", "wgrad"))


def fused_srk_plan(B: int, H: int, HH: int, n_inner: int, backward: bool,
                   drift: str = "embm", noise: str = "precomp",
                   members: int = 1) -> dict:
    """The CUDA library's plan of an SRK launch of `members` members: its
    level (0 the weight slices in shared memory, 1 the weights read from
    device memory, csrc/sde_hopper.cuh), batch rows and CTAs a cluster,
    cudaOccupancyMaxActiveClusters (a negative CUDA error when the plan
    cannot be scheduled) and the shared bytes a CTA. Needs the card."""
    shape = (B, H, HH, n_inner, *mode_codes(drift, noise), members,
             int(backward))
    return {name: _LIB.call("plan", *shape, i)
            for i, name in enumerate(_PLAN_FIELDS)}


def force_srk_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make later launches take clusters of `cluster` CTAs and `rows` batch
    rows a cluster (0: the plan's own choice of each); for tests of each
    plan. Raises ValueError on a size the kernels do not take."""
    if _LIB.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no SRK plan with {cluster} CTAs and {rows} rows "
                         f"a cluster")
    _LIB._kept.clear()


@functools.lru_cache(maxsize=None)
def _want(M, B, H, HH, n_inner) -> dict:
    """A member's tensors' shapes (read-only)."""
    s3, s3h, row, rowh = (M, B, H), (M, B, HH), (M, H), (M, HH)
    return {"y0": (B, H), "xh0": s3h, "xh1": s3h, "dw": s3, "i10": s3,
            "a0": rowh, "a1": rowh, "gk0": row, "gk1": row, "gk2": row,
            "dts": (M,), "theta": (1,), "wy": (H, HH),
            "w_inner": (n_inner, HH, HH), "b_inner": (n_inner, HH),
            "wout": (HH, H), "bo": (H,), "wn1": (H, H), "wn2": (H, H),
            "bn2": (H,), "ys": s3, "gys": s3}


def _checked(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta, wy,
             w_inner, b_inner, wout, bo, wn1, wn2, bn2, ys, gys, modes,
             stream="f32"):
    """check_kernel_inputs's checks; (dims, K: 0 for a solo launch)."""
    dims = kernel_dims("fused SRK", y0, wout, w_inner, dts)
    got = {"y0": y0, "xh0": xh0, "xh1": xh1, "dw": dw, "i10": i10, "a0": a0,
           "a1": a1, "gk0": gk0, "gk1": gk1, "gk2": gk2, "dts": dts,
           "theta": theta, "wy": wy, "w_inner": w_inner, "b_inner": b_inner,
           "wout": wout, "bo": bo, "wn1": wn1, "wn2": wn2, "bn2": bn2,
           "ys": ys, "gys": gys}
    want = _want(*dims)
    K = member_count(y0)
    if K:
        want = member_shapes(want, K)
    check_tensors("fused SRK", want, got, y0.device, modes,
                  bf16=_BF16_STREAMS if stream == "bf16" else ())
    return dims, K


def check_kernel_inputs(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
                        theta, wy, w_inner, b_inner, wout, bo, wn1=None,
                        wn2=None, bn2=None, ys=None, gys=None,
                        modes: Optional[SdeModes] = None,
                        stream: str = "f32"):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32 (bfloat16 for xh0, xh1, dw, i10, ys and gys with `stream`
    'bf16'), tensors on different devices, a non-contiguous tensor,
    or a shape that disagrees with y0/w_inner/wout/dts (each but dts with a
    leading member axis in a packed launch); with `modes`, a tensor given
    that they do not take or missing where they need it (a tensor the modes do not
    take is None). Every width is taken (the plan splits the weights over a
    cluster or reads them from device memory). Returns (M, B, H, HH,
    n_inner)."""
    return _checked(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta,
                    wy, w_inner, b_inner, wout, bo, wn1, wn2, bn2, ys, gys,
                    modes, stream)[0]


def _check_srk_mode(modes, xh0, xh1, a0, a1, gks, wy, wn1, wn2, bn2):
    check_mode("fused SRK", modes, xh0=xh0, xh1=xh1, a0=a0, a1=a1,
               gk0=gks[0], gk1=gks[1], gk2=gks[2], wy=wy, wn1=wn1, wn2=wn2,
               bn2=bn2)


def _empty(*shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def _launch_forward(dims, modes: SdeModes, tensors, stream, K: int,
                    prec=(0, 0)):
    """K members (0: a solo launch, its outputs without the member axis);
    prec: the (operand mode, stream flag) of a reduced precision, launched
    on its own kernels (no SRKNoise: its backward recomputes the nets)."""
    M, B, H, _, _ = dims
    noise, m = modes.flags["noise"], (K,) if K else ()
    dev = tensors[0].device
    ys = _empty(*m, M, B, H, device=dev,
                dtype=torch.bfloat16 if prec[1] else torch.float32)
    if prec != (0, 0):
        _RED.launch("fwd", tuple(tensors) + (ys,),
                    dims + modes.ints + (max(K, 1),) + tuple(prec), stream)
        return ys, None
    ns = None
    if is_net(noise):
        ns = SRKNoise(_empty(3, *m, M, B, H, device=dev),
                      _empty(4, *m, M, B, H, device=dev),
                      _empty(4, *m, M, B, H, device=dev) if noise == "net2"
                      else None)
    _LIB.launch("fwd", tuple(tensors) + (ys,) + (
        tuple(ns) if ns is not None else (None, None, None)),
        dims + modes.ints + (max(K, 1),), stream)
    return ys, ns


def _launch_recurrence(dims, modes: SdeModes, tensors, ns, stream,
                       K: int, prec=(0, 0)) -> SRKStreams:
    """With a reduced precision (prec) the reduced kernel, which recomputes
    the nets (their stage states and hidden activations its streams nst
    and nh); with bf16 streams tensors' y0 is the rounded state, in bf16 as
    ys."""
    M, B, H, HH, n_inner = dims
    noise, m, Kn = modes.flags["noise"], (K,) if K else (), max(K, 1)
    dev = tensors[0].device
    red = prec != (0, 0)
    shape = (B, H, HH, n_inner, *modes.codes, Kn)
    lib = _RED if red else _LIB
    ctas = -(-B // lib.rows(shape, backward=True)) * (
        1 if red else _LIB.kept("plan", *shape, 1, 2))
    dxh, dy0 = (_empty(2, *m, M, B, HH, device=dev),
                _empty(*m, B, H, device=dev))
    hs, es = (_empty(n_inner + 1, 2, *m, M, B, HH, device=dev),
              _empty(n_inner, 2, *m, M, B, HH, device=dev))
    dz3 = _empty(2, *m, M, B, H, device=dev)
    q = _empty(3, *m, M, B, H, device=dev) if noise == "precomp" else None
    dn = _empty(4, *m, M, B, H, device=dev) if is_net(noise) else None
    dz2 = _empty(4, *m, M, B, H, device=dev) if noise == "net2" else None
    h01 = _empty(*m, M, B, H, device=dev)
    p_th, dth = _empty(Kn * ctas, device=dev), _empty(*m, 1, device=dev)
    outs = (dxh, dy0, hs, es, dz3, q, h01, dn, dz2)
    if red:
        nst = _empty(3, *m, M, B, H, device=dev) if dn is not None else None
        nh = _empty(4, *m, M, B, H, device=dev) if dz2 is not None else None
        _RED.launch("bwd", tuple(tensors) + outs + (nst, nh, p_th, dth),
                    dims + modes.ints + (Kn,) + tuple(prec), stream)
        return SRKStreams(dy0, dth, dxh, hs, es, dz3, h01, q, dn, dz2, nst,
                          nh)
    saved = tuple(ns) if ns is not None else (None, None, None)
    _LIB.launch("bwd", tuple(tensors) + saved + outs + (p_th, dth),
                dims + modes.ints + (Kn,), stream)
    return SRKStreams(dy0, dth, dxh, hs, es, dz3, h01, q, dn, dz2)


def _launch_weight_grads(y0, ys, st: SRKStreams, nst, nh, modes: SdeModes,
                         stream, K: int, matmul: int = 0) -> SRKWeightGrads:
    """From a packed launch's streams (K members), or a solo one's (K 0);
    y0 and ys float32 (the states the recurrence read); matmul the operand
    mode's code (a reduced one on the reduced library's kernel)."""
    M, B, HH = st.dxh.shape[-3:]
    H, n_inner, m = y0.shape[-1], st.es.shape[0], (K,) if K else ()
    drift, noise = modes.flags["drift"], modes.flags["noise"]
    lib = _RED if matmul else _LIB
    S = lib.kept("wgrad_splits", M, B, H, HH, n_inner, *modes.codes)
    size = lambda s: sum(wgrad_partial_sizes(s, H, HH, n_inner, drift, noise))
    p = _empty(max(K, 1), size(S), device=y0.device)
    w = _empty(*m, size(1), device=y0.device)
    da = _empty(*m, 2, M, HH, device=y0.device) if drift != "xt" else None
    dgk = (_empty(*m, 3, M, H, device=y0.device) if noise == "precomp" else
           _empty(*m, 4, M, H, device=y0.device) if is_net(noise) else None)
    tensors = (y0, ys, st.h01, st.dxh, st.hs, st.es, st.dz3, st.q, nst,
               st.dn, nh, st.dz2, p, w, da, dgk)
    ints = (M, B, H, HH, n_inner) + modes.ints + (max(K, 1),)
    lib.launch("wgrad", tensors, ints + ((matmul, 0) if matmul else ()),
               stream)
    if is_net(noise):     # the an1 rows' cotangents: stages 1 and 3 summed
        e = len(m)
        dgk = torch.stack([dgk.select(e, 0),
                           dgk.select(e, 1) + dgk.select(e, 3),
                           dgk.select(e, 2)], e)
    g = split_weight_grads(w, H, HH, n_inner, drift, noise)
    return SRKWeightGrads(*g[:5], da, dgk, *g[5:])


_FWD_NAMES = ("y0", "xh0", "xh1", "dw", "i10", "a0", "a1", "gk0", "gk1",
              "gk2", "dts", "theta", "wy", "w_inner", "b_inner", "wout", "bo",
              "wn1", "wn2", "bn2")
_BWD_NAMES = ("y0", "ys", "gys") + _FWD_NAMES[1:]


def fused_srk_forward(y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
                      theta, wy, w_inner, b_inner, wout, bo, wn1=None,
                      wn2=None, bn2=None, *, mult_y: bool, geometric: bool,
                      drift: str = "embm", noise: str = "precomp",
                      elem: int = 0, stream: str = "f32",
                      matmul: str = "f32"):
    """(ys [M, B, H], SRKNoise in the nets' modes in exact fp32 else None),
    with a member axis in a packed launch (y0 [K, B, H]; ys [K, M, B, H],
    SRKNoise's second axis): the CUDA forward kernel for CUDA tensors, the
    plain version for CPU tensors (member by member in a packed launch).
    `matmul` is the products' operand mode ('f32', 'bf16x3', 'bf16'); with
    `stream` 'bf16', xh0, xh1, dw and i10 come and ys goes in bf16. A
    reduced precision runs on kernels of its own."""
    global FWD_LAUNCHES, PACKED_FWD_LAUNCHES
    modes = sde_mode(mult_y, geometric, drift, noise, elem)
    prec = precision_ints("fused SRK", stream, matmul)
    args = (y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta, wy,
            w_inner, b_inner, wout, bo, wn1, wn2, bn2)
    if y0.device.type == "cpu":
        _check_srk_mode(modes, xh0, xh1, a0, a1, (gk0, gk1, gk2), wy, wn1,
                        wn2, bn2)
        kw = dict(**modes.flags, stream=stream, matmul=matmul)
        K = member_count(y0)
        if K:
            return per_member(fused_srk_forward_reference, _FWD_NAMES, args,
                              K, _STREAM_AXES, **kw)
        return fused_srk_forward_reference(*args, **kw)
    dims, K = _checked(*args, None, None, modes, stream)
    lib = _RED if prec != (0, 0) else _LIB
    stream_h = lib.stream(y0, dims[1:] + modes.codes + (max(K, 1),),
                          backward=False)
    out = _launch_forward(dims, modes, args, stream_h, K, prec)
    if prec != (0, 0):
        count_precision(PRECISION_LAUNCHES, "fwd", stream, matmul)
    elif K:
        PACKED_FWD_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    return out


def _check_ns(ns, ys, noise, device):
    if not is_net(noise):
        return
    if ns is None:
        raise ValueError("the noise nets' backward takes the forward's "
                         "SRKNoise (ns=)")
    *k, M, B, H = ys.shape
    check_tensors("fused SRK", {"nst": (3, *k, M, B, H),
                                "nb": (4, *k, M, B, H),
                                "nh": (4, *k, M, B, H)}, ns._asdict(), device)


def fused_srk_backward_recurrence(y0, ys, gys, xh0, xh1, dw, i10, a0, a1,
                                  gk0, gk1, gk2, dts, theta, wy, w_inner,
                                  b_inner, wout, bo, wn1=None, wn2=None,
                                  bn2=None, *, mult_y: bool, geometric: bool,
                                  drift: str = "embm",
                                  noise: str = "precomp", elem: int = 0,
                                  ns: Optional[SRKNoise] = None,
                                  stream: str = "f32", matmul: str = "f32"
                                  ) -> SRKStreams:
    """The reverse loop given gys = dL/dys (SRKStreams, float32 whatever
    the stream dtype; in a packed launch with a member axis, _STREAM_AXES):
    the CUDA backward recurrence kernel for CUDA tensors (d theta's per-CTA
    partials summed in the library), the plain version for CPU tensors. In
    a reduced precision the reduced kernel, which recomputes the noise nets
    (ns unused); y0 is the float32 initial state (with bf16 streams the
    kernel reads it rounded, as it reads ys)."""
    global BWD_LAUNCHES, PACKED_BWD_LAUNCHES
    modes = sde_mode(mult_y, geometric, drift, noise, elem)
    prec = precision_ints("fused SRK", stream, matmul)
    args = (y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
            theta, wy, w_inner, b_inner, wout, bo, wn1, wn2, bn2)
    if y0.device.type == "cpu":
        _check_srk_mode(modes, xh0, xh1, a0, a1, (gk0, gk1, gk2), wy, wn1,
                        wn2, bn2)
        kw = dict(**modes.flags, ns=ns, stream=stream, matmul=matmul)
        K = member_count(y0)
        if K:
            return per_member(fused_srk_backward_recurrence_reference,
                              _BWD_NAMES, args, K, _STREAM_AXES, **kw)
        return fused_srk_backward_recurrence_reference(*args, **kw)
    dims, K = _checked(y0, *args[3:], ys, gys, modes, stream)
    red = prec != (0, 0)
    if not red:
        _check_ns(ns, ys, noise, y0.device)
    stream_h = (_RED if red else _LIB).stream(
        y0, dims[1:] + modes.codes + (max(K, 1),), backward=True)
    y0k = y0.to(torch.bfloat16) if prec[1] else y0
    # the reduced kernel recomputes net2, so it takes bn2 too
    st = _launch_recurrence(dims, modes, (y0k,) + args[1:22 if red else 21],
                            ns, stream_h, K, prec)
    if red:
        count_precision(PRECISION_LAUNCHES, "bwd", stream, matmul)
    elif K:
        PACKED_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return st


def fused_srk_weight_grads(y0, ys, st: SRKStreams,
                           ns: Optional[SRKNoise] = None, *,
                           drift: str = "embm",
                           noise: str = "precomp",
                           matmul: str = "f32") -> SRKWeightGrads:
    """The weight, bias and per-step gradients from the recurrence's
    streams (SRKWeightGrads, each with a leading member axis in a packed
    launch; the nets' stage states and hidden activations from the
    forward's `ns`, or in a reduced precision from the recurrence's nst
    and nh), the products in operand mode `matmul`: the CUDA
    weight-gradient kernel for CUDA tensors (its split partials summed in
    the library, in a fixed order), the plain version for CPU tensors. y0
    and ys are the states the recurrence read (with bf16 streams the
    rounded y0 and ys; a bf16 ys is widened here)."""
    global WGRAD_LAUNCHES, PACKED_WGRAD_LAUNCHES
    # the weight gradient reads no flag but the modes (any elem option)
    modes = sde_mode(False, False, drift, noise, 7)
    prec = precision_ints("fused SRK", "f32", matmul)
    stream_of = "bf16" if ys.dtype == torch.bfloat16 else "f32"
    ys = ys.float()
    nst, nh = ((ns.nst, ns.nh) if ns is not None else (st.nst, st.nh))
    K = member_count(y0)
    if y0.device.type == "cpu":
        if K:
            nsk = SRKNoise(nst, None, nh) if nst is not None else None
            return stack_members([fused_srk_weight_grads(
                y0[k], ys[k], select_member(st, k, _STREAM_AXES),
                select_member(nsk, k, _STREAM_AXES), drift=drift,
                noise=noise, matmul=matmul) for k in range(K)])
        return fused_srk_weight_grads_reference(
            y0, ys, st.h01, st.dxh, st.hs, st.es, st.dz3, st.q, nst, st.dn,
            st.dz2, nh, drift=drift, noise=noise, matmul=matmul)
    M, B, H = st.dz3.shape[-3:]
    HH, n_inner = st.dxh.shape[-1], st.es.shape[0]
    m = (K,) if K else ()
    s4 = (4,) + m + (M, B, H)
    want = {"y0": m + (B, H), "ys": m + (M, B, H), "h01": m + (M, B, H),
            "dxh": (2,) + m + (M, B, HH),
            "hs": (n_inner + 1, 2) + m + (M, B, HH),
            "es": (n_inner, 2) + m + (M, B, HH), "dz3": (2,) + m + (M, B, H),
            "q": (3,) + m + (M, B, H), "nst": (3,) + m + (M, B, H),
            "dn": s4, "dz2": s4, "nh": s4}
    check_tensors("fused SRK", want, {"y0": y0, "ys": ys, "h01": st.h01,
                                      "dxh": st.dxh, "hs": st.hs,
                                      "es": st.es, "dz3": st.dz3,
                                      "q": st.q, "nst": nst, "dn": st.dn,
                                      "dz2": st.dz2, "nh": nh}, y0.device)
    if ((noise == "precomp") != (st.q is not None)
            or is_net(noise) != (st.dn is not None and nst is not None)
            or (noise == "net2") != (st.dz2 is not None and nh is not None)):
        raise ValueError(f"fused SRK weight gradient ({noise}): the streams "
                         f"are not the mode's")
    lib = _RED if prec[0] else _LIB
    stream = lib.stream(y0, (B, H, HH, n_inner) + modes.codes + (max(K, 1),),
                        backward=True)
    out = _launch_weight_grads(y0, ys, st, nst, nh, modes, stream, K,
                               prec[0])
    if prec[0]:
        count_precision(PRECISION_LAUNCHES, "wgrad", stream_of, matmul)
    elif K:
        PACKED_WGRAD_LAUNCHES += 1
    else:
        WGRAD_LAUNCHES += 1
    return out


def fused_srk_backward(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                       dts, theta, wy, w_inner, b_inner, wout, bo, wn1=None,
                       wn2=None, bn2=None, *, mult_y: bool, geometric: bool,
                       drift: str = "embm", noise: str = "precomp",
                       elem: int = 0, ns: Optional[SRKNoise] = None,
                       stream: str = "f32", matmul: str = "f32"):
    """Cotangents of the solve's inputs given gys = dL/dys (FusedSRKGrads,
    FusedSRKNetGrads in the nets' modes; in a packed launch each member's
    along a leading axis): for CUDA tensors the backward recurrence kernel, then the
    weight-gradient kernel; for CPU tensors the plain reverse loop. With
    bf16 streams dxh0 and dxh1 leave in bf16."""
    modes = dict(mult_y=mult_y, geometric=geometric, drift=drift,
                 noise=noise, elem=elem)
    prec = dict(stream=stream, matmul=matmul)
    args = (y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts,
            theta, wy, w_inner, b_inner, wout, bo, wn1, wn2, bn2)
    K = member_count(y0)
    if y0.device.type == "cpu":
        _check_srk_mode(sde_mode(**modes), xh0, xh1, a0, a1, (gk0, gk1, gk2),
                        wy, wn1, wn2, bn2)
        if not K:
            return fused_srk_backward_reference(*args, **modes, ns=ns,
                                                **prec)
        return per_member(fused_srk_backward_reference, _BWD_NAMES, args, K,
                          _STREAM_AXES, ns=ns, **modes, **prec)
    st = fused_srk_backward_recurrence(*args, **modes, ns=ns, **prec)
    y0r = bf16_round(y0) if stream == "bf16" else y0
    w = fused_srk_weight_grads(y0r, ys, st, None if _reduced(**prec) else ns,
                               drift=drift, noise=noise, matmul=matmul)
    yy, e = drift == "yy", int(K > 0)   # the evaluations' axis
    da = (None, None) if w.da is None else w.da.unbind(e)
    dgk = (None,) * 3 if w.dgk is None else w.dgk.unbind(e)
    dxh = (None, None) if yy else st.dxh.to(xh0.dtype).unbind(0)
    out = (st.dy0, *dxh, *da, *dgk, st.dtheta, w.dwy, w.dw_inner,
           w.db_inner, w.dwout, w.dbo)
    return (FusedSRKNetGrads(*out, w.dwn1, w.dwn2, w.dbn2) if is_net(noise)
            else FusedSRKGrads(*out))


_ARG_ORDER = _FWD_NAMES
# the modes FusedSRK takes (and the precision `stream` and `matmul`, 'f32'
# when not given)
_MODE_KEYS = ("mult_y", "geometric", "drift", "noise", "elem")
_PRECISION_KEYS = ("stream", "matmul")


class FusedSRK(torch.autograd.Function):
    """ys = SRIW1 solve of a DiffusionField; backward by the backward
    recurrence and weight-gradient kernels. Inputs: the modes (a dict of
    _MODE_KEYS and optionally `stream` and `matmul`), then _ARG_ORDER (None
    where the mode takes none): y0 [B,H], xh0/xh1 [M,B,HH], dw/i10 [M,B,H]
    (not differentiated), a0/a1 [M,HH], gk0/gk1/gk2 [M,H] (the an1 rows in
    the nets' modes), dts [M] (not differentiated), theta [1], wy [H,HH],
    w_inner [n_inner,HH,HH], b_inner [n_inner,HH], wout [HH,H], bo [H],
    wn1, wn2 [H,H], bn2 [H]; in a packed solve of K members each but dts
    with a leading K axis, and ys [K, M, B, H]. With `stream` 'bf16', xh0,
    xh1, dw and i10 are bf16 and so is ys (and the cotangent autograd hands
    back)."""

    @staticmethod
    def forward(ctx, modes, *tensors):
        ys, ns = fused_srk_forward(*tensors, **modes)
        ctx.save_for_backward(*tensors, ys,
                              *(ns if ns is not None else (None,) * 3))
        ctx.modes = modes
        return ys

    @staticmethod
    def backward(ctx, gys):
        *tensors, ys, nst, nb, nh = ctx.saved_tensors
        modes = ctx.modes
        net = is_net(modes["noise"])
        ns = SRKNoise(nst, nb, nh) if nb is not None else None
        gr = fused_srk_backward(tensors[0], ys, gys.contiguous(),
                                *tensors[1:], **modes, ns=ns)
        return (None, gr.dy0, gr.dxh0, gr.dxh1, None, None, gr.da0, gr.da1,
                gr.dgk0, gr.dgk1, gr.dgk2, None, gr.dtheta, gr.dwy,
                gr.dw_inner, gr.db_inner, gr.dwout, gr.dbo,
                gr.dwn1 if net else None, gr.dwn2 if net else None,
                gr.dbn2 if net else None)


# ---------------------------------------------------------------------------
# Public entry: solve a DiffusionField SDE with the fused SRK kernels
# ---------------------------------------------------------------------------

def fused_srk_inputs(field, path, grid: np.ndarray, y0: torch.Tensor,
                     dW: torch.Tensor, I10: torch.Tensor) -> dict:
    """The kernels' inputs for a field on a host step grid: the drift's and
    diffusion's precomputes at each stage time (drift at t and t + 3/4 dt,
    diffusion at t, t + dt/4 and t + dt; differentiable through autograd;
    None where the mode has none), the stacked weights in [in, out] layout,
    and the modes (snsde/kernels/fused_srk.py:724-818)."""
    check_supported(field, "fused SRK")
    dev, f32 = y0.device, torch.float32
    t0, dts = grid[:-1], np.diff(grid)
    td1, tn1 = t0 + 0.75 * dts, t0 + 0.25 * dts
    t = stage_times(dev, t0, td1, tn1, grid[1:], dts)
    xh0, a0 = drift_rows(field, path, t0, t[0])
    xh1, a1 = drift_rows(field, path, td1, t[1])
    return {"y0": y0.contiguous(), "xh0": xh0, "xh1": xh1,
            "dw": dW.to(device=dev, dtype=f32).contiguous(),
            "i10": I10.to(device=dev, dtype=f32).contiguous(),
            "a0": a0, "a1": a1, "gk0": noise_rows(field, t[0]),
            "gk1": noise_rows(field, t[2]), "gk2": noise_rows(field, t[3]),
            "dts": t[4], "theta": field.theta.reshape(1),
            **drift_weights(field, dev), **noise_weights(field),
            **sde_modes(field)}


def precision_inputs(inputs: dict, stream_dtype=None, matmul=None) -> dict:
    """The kernels' inputs in a precision (resolve_precision: None from
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL, as fused_srk.py:661-666 and
    :703-704 resolve them): the control and noise streams xh0, xh1, dw and
    i10 in the stream dtype (:776-787), and the modes `stream` ('f32' or
    'bf16') and `matmul` ('f32', 'bf16x3', 'bf16')."""
    sd, mm = resolve_precision(stream_dtype, matmul)
    out = dict(inputs, stream="bf16" if sd == torch.bfloat16 else "f32",
               matmul=mm)
    for k in ("xh0", "xh1", "dw", "i10"):
        if out[k] is not None:
            out[k] = out[k].to(sd)
    return out


def solve_modes(inputs: dict) -> dict:
    """FusedSRK's modes from a solve's inputs (precision_inputs')."""
    return {k: inputs[k] for k in _MODE_KEYS + _PRECISION_KEYS}


def fused_srk_solve(field, path, times, y0: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    dt: Optional[float] = None,
                    brownian_override=None,
                    stream_dtype: Optional[torch.dtype] = None,
                    matmul: Optional[str] = None) -> torch.Tensor:
    """SRIW1 solve of a DiffusionField through the fused kernels. Returns
    ys [T, B, H] on the output times (time-major). (dW, I10), each
    [M, B, H], come from `brownian_override` when given, else from
    `generator`, dW first and then the Lévy area, as `sdeint(method="srk")`
    draws them. Matches DiffusionField.f/g except for float32
    reassociation of the merged drift input and sqrt's nan_to_num taken
    as 0 where y <= 0. `stream_dtype` (torch.float32 or torch.bfloat16)
    holds the control, noise, trajectory and cotangent streams, `matmul`
    ('f32', 'bf16x3' or 'bf16') the in-kernel products' operands, as in
    the JAX entry (snsde/kernels/fused_srk.py:655-842); None takes
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL, exact fp32 when unset. The
    result is float32 (a bf16 trajectory widened, its first row the
    rounded y0)."""
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
    inputs = precision_inputs(fused_srk_inputs(field, path, grid, y0, dW,
                                               I10), stream_dtype, matmul)
    ys = FusedSRK.apply(solve_modes(inputs),
                        *(inputs[k] for k in _ARG_ORDER))
    return widen_output(y0, ys)[torch.as_tensor(out_idx, device=y0.device)]
