"""Fused Euler–Maruyama solve: two hand-written CUDA kernels for Hopper
(snsde_torch/csrc/fused_em.cu) behind a `torch.autograd.Function`.

Replaces the Pallas TPU kernel pair of snsde/kernels/fused_em.py —
`_fused_em_forward` (pallas_call at :688, body `_fwd_kernel` :590) and
`_fused_em_backward` (pallas_call at :888, body `_bwd_kernel` :736), the
custom VJP `_fused_em` (:961-1065) — for every DiffusionField
configuration, as the JAX kernels take them (`_config`, :184-240): drift
mode 'embm' (the merged emb drift, input_option 2, 4 or 6), 'yy' (1, 3, 5:
z1 = y Wy + a) or 'xt' (0: z1 = xh); noise mode 'precomp' (a diffusion
magnitude that depends on t only: noise_option 0-6, 11-13, 16, 17), 'elem'
(7-10: sqrt, cube, sigmoid, relu of y), 'net1' (14/15: y Wn1 + an1) or
'net2' (18/19: relu(relu(y Wn1 + an1) Wn2 + bn2)); mult_y and geometric
on or off. Each drift and noise mode is an instance of the kernels. The
latent mode (`_config`'s `latent`, :234-245; forward :346-352, `_latent_u`
:362-372, backward :467-475) solves a LatentSDE's augmented system: drift
'yy' and noise 'precomp' with the drift output linear, the diffusion (the
gk row, sigma on the latent lanes) applied raw, and on the last lane the
Girsanov KL rate 0.5 sum_q u_q^2, u_q = (z3_q - theta (mu - y_q)) / sigma,
from the rows `lat` = (theta, mu, mask / sigma); its own instances of the
forward and the recurrence (`fused_latent_em_solve`).

What bounds the kernels on the H100: at the main-path shape (B=1024, 71
steps, H=49) the forward moves ~43 MB and does ~1 GFLOP of fp32 work
(~13 us and ~16 us at 3.35 TB/s and 67 TFLOP/s). Neither is the limit:
the work is a chain of 71 dependent steps, each a few [rows x 49] x
[49 x 49] products with barriers between them, over only 1024 independent
rows. The design (csrc/fused_em.cu) keeps a cluster's weight slices, state
and activations in shared memory for the whole loop, with register-tiled
products on 512 threads and the step's streams copied a step ahead; the
backward runs only the dependent chain in its loop, recomputing each
step's activations beside the previous step's chain, and writes the
streams from which one weight-gradient kernel forms the weight, bias and
per-step gradients after the loop. Exact fp32 on the CUDA cores by
default.

The JAX kernels' reduced precisions (K1, and K3 in the latent mode) are
the modes `stream` and `matmul` of every kernel (runtime arguments of the
same instances): bf16 streams (xh, dw, ys, gys, and dxh handed back, in
bf16; the forward's carry fp32 and only the trajectory rounded,
`fused_em.py:617`; the backward recomputing each step from the rounded
state, y0 rounded too, `:830-836`) and bf16x3 or bf16 operands of every
in-kernel product (`_dot`, `:67-107`; the weight gradient's and the latent
KL rate's too), accumulating in fp32. The entries take `stream_dtype=`
and `matmul=`, None resolving from SNSDE_FUSED_STREAM and
SNSDE_FUSED_MATMUL as the JAX entries do (`_solver.resolve_precision`).

As in the JAX package, the y-independent parts stay outside the kernels as
plain matrix products whose gradients come from torch autograd
(`fused_em.py:1225-1293`): the hoist xh' = (X(t) W_init + b_init) We2, the
merge Wy' = Wy We1 and a' = (tf Wt + b_in) We1 + be (the yy drift's a =
tf Wt + b_in, the xt drift's xh = X(t) W_init + b_init), the diffusion
magnitude gk(t) and the noise net's an1 = tf Wn1_t + bn1. In the noise
nets' modes the forward also returns the net's outputs and hidden
activations (EMNoise; None in the other modes), which the backward reads
back. The weight
gradient's split partials and d theta's
per-CTA partials are summed here in a fixed order (as the JAX package sums
its per-block partials, `:905-941`), so runs are reproducible.

Each kernel has a plain PyTorch version beside it with the same inputs and
outputs. `fused_em_forward`/`fused_em_backward` take the plain versions
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.brownian import brownian_increments
from ..ops.solve import make_grid
from ._solver import (SDE_INT_NAMES, SDE_SHAPE_NAMES, SdeModes, SolverLib,
                      bf16_round, check_mode, check_supported, check_tensors,
                      count_precision, drift_input, drift_rows, drift_weights,
                      is_net, kernel_dims, member_count, member_shapes,
                      mm_op, mode_codes, noise_back, noise_base, noise_rows,
                      noise_weights, one_hot_op, per_member, precision_counts,
                      precision_ints, resolve_precision, sde_mode, sde_modes,
                      select_member, split_weight_grads, stack_members,
                      stage_times, supports_fused, wgrad_partial_sizes,
                      widen, widen_output)

__all__ = ["fused_em_solve", "fused_em_inputs", "supports_fused", "FusedEM",
           "fused_em_forward", "fused_em_backward",
           "fused_em_backward_recurrence", "fused_em_weight_grads",
           "fused_em_forward_reference", "fused_em_backward_reference",
           "fused_em_backward_recurrence_reference",
           "fused_em_weight_grads_reference", "fused_em_plan",
           "force_em_plan", "FusedEMGrads", "FusedEMNetGrads", "EMNoise",
           "EMStreams", "EMWeightGrads", "fused_latent_em_solve",
           "latent_inputs", "precision_inputs", "PRECISION_LAUNCHES"]

# launches of each CUDA kernel since the count was last set to 0: the
# forward, the backward recurrence and the weight gradient, solo, (the
# PACKED_ counts) with a member axis and (the LATENT_ counts: the latent
# instances; their weight gradient is that of 'precomp') solo in the
# latent mode
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
WGRAD_LAUNCHES = 0
PACKED_FWD_LAUNCHES = 0
PACKED_BWD_LAUNCHES = 0
PACKED_WGRAD_LAUNCHES = 0
LATENT_FWD_LAUNCHES = 0
LATENT_BWD_LAUNCHES = 0


class FusedEMGrads(NamedTuple):
    """Cotangents of the fused solve's inputs (per-block partials summed);
    None for an input the mode does not take."""
    dy0: torch.Tensor        # [B, H]
    dxh: torch.Tensor        # [M, B, HH] (None in drift mode 'yy')
    da: torch.Tensor         # [M, HH] (None in 'xt')
    dgk: torch.Tensor        # [M, H]: of gk, or of the nets' an1 rows
    dtheta: torch.Tensor     # [1]
    dwy: torch.Tensor        # [H, HH] (None in 'xt')
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]


class FusedEMNetGrads(NamedTuple):
    """FusedEMGrads and the noise net's weights' cotangents (the nets'
    modes; dwn2 and dbn2 None for net1)."""
    dy0: torch.Tensor
    dxh: torch.Tensor
    da: torch.Tensor
    dgk: torch.Tensor
    dtheta: torch.Tensor
    dwy: torch.Tensor
    dw_inner: torch.Tensor
    db_inner: torch.Tensor
    dwout: torch.Tensor
    dbo: torch.Tensor
    dwn1: torch.Tensor       # [H, H]
    dwn2: torch.Tensor       # [H, H]
    dbn2: torch.Tensor       # [H]


class EMNoise(NamedTuple):
    """What the forward leaves of a noise net, read back by the backward."""
    nb: torch.Tensor         # [M, B, H]: the net's output (the base)
    nh: torch.Tensor         # [M, B, H]: net2's hidden activations


class EMStreams(NamedTuple):
    """What the backward recurrence leaves: the state's and theta's
    cotangents, and the streams of the weight gradient."""
    dy0: torch.Tensor        # [B, H]
    dtheta: torch.Tensor     # [1]
    dxh: torch.Tensor        # [M, B, HH]: dz1, the cotangent of h_0's input
    hs: torch.Tensor         # [n_inner+1, M, B, HH]: h_0..h_NI
    es: torch.Tensor         # [n_inner, M, B, HH]: of h_1..h_NI's inputs
    dz3: torch.Tensor        # [M, B, H]: of z3 before the geometric factor
    q: torch.Tensor          # [M, B, H]: of the gk row, by batch row
    dn: Optional[torch.Tensor] = None   # [M, B, H]: of a net's first layer
    dz2: Optional[torch.Tensor] = None  # [M, B, H]: of net2's second layer


class EMWeightGrads(NamedTuple):
    """The weight gradient's products over the recurrence's streams."""
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]
    da: torch.Tensor         # [M, HH]
    dgk: torch.Tensor        # [M, H]
    dwn1: Optional[torch.Tensor] = None
    dwn2: Optional[torch.Tensor] = None
    dbn2: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------

def _row(gk, u):
    return None if gk is None else gk[u]


def latent_mask(H: int, device=None) -> torch.Tensor:
    """[H]: 1 on the latent lanes, 0 on the KL lane (the last)."""
    m = torch.ones(H, dtype=torch.float32, device=device)
    m[-1] = 0.0
    return m


def _latent_drift(z3, y, lat, matmul="f32"):
    """The latent mode's drift: z3 (linear) on the latent lanes and the KL
    rate 0.5 sum_q u_q^2 on the last, u = (z3 - theta (mu - y)) mask /
    sigma from lat = (theta, mu, mask / sigma) [3, H] (the KL lane's u is 0:
    its row of mask / sigma is). In the reduced operand modes the rate is
    JAX's product (0.5 u^2) klm (:352): each 0.5 u_q^2 rounded (bf16) or
    split (bf16x3), the hi parts summed, then the lo parts."""
    th, mu, isg = lat
    u = (z3 - th * (mu - y)) * isg
    if matmul == "f32":
        rate = 0.5 * (u * u).sum(-1, keepdim=True)
    else:
        v = 0.5 * u * u
        h = bf16_round(v)
        rate = h.sum(-1, keepdim=True)
        if matmul == "bf16x3":
            rate = rate + bf16_round(v - h).sum(-1, keepdim=True)
    kl = torch.zeros_like(isg)
    kl[-1] = 1.0
    return z3 + rate * kl


def _latent_back(gbar, y, z3, dt, dw, lat, matmul="f32"):
    """Back through a latent step y' = y + f dt + gk dW given gbar = the
    cotangent of y' (the JAX kernel's :467-475): (dz3, y's cotangent
    through the KL rate, q = the gk row's cotangent by batch row). The KL
    lane's cotangent dt gbar_KL (through klm^T in the operand mode) fans out
    through each u_q to z3_q (/ sigma) and y_q (theta / sigma)."""
    th, mu, isg = lat
    u = (z3 - th * (mu - y)) * isg
    df = gbar * dt
    du = one_hot_op(df[:, -1:], matmul) * u
    return (df * latent_mask(y.shape[-1], y.device) + du * isg,
            du * (th * isg), gbar * dw)



def fused_em_forward_reference(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                               b_inner, wout, bo, wn1=None, wn2=None,
                               bn2=None, lat=None, *, mult_y: bool,
                               geometric: bool, drift: str = "embm",
                               noise: str = "precomp", elem: int = 0,
                               latent: bool = False, stream: str = "f32",
                               matmul: str = "f32", relu=torch.relu):
    """Eager EM loop over the field's drift and diffusion: (ys [M, B, H], y
    after each step; EMNoise in the nets' modes, else None). Weights in
    [in, out] layout; theta [1]; gk holds the an1 rows in the nets' modes.
    In the latent mode (lat: the rows theta, mu, mask / sigma [3, H]) the
    drift is z3 with the KL rate on the last lane and the diffusion gk
    raw. Every relu of the drift MLP and the noise net is `relu` (a
    stand-in may probe the pre-activations). Every product takes operand
    mode `matmul` (mm_op). With `stream` 'bf16' (the JAX kernel's
    traj_bf16), xh and dw arrive in bf16, the carry stays in y0's dtype and
    only the written trajectory is rounded (:617), and the nets' streams are
    those of the rounded state before each step, which the backward
    differentiates (:772-777)."""
    sth = torch.sigmoid(theta.reshape(()))
    xh, dw = widen(xh, y0), widen(dw, y0)
    rounded = stream == "bf16"
    y = y0
    ys, nbs, nhs = [], [], []
    for u in range(dts.shape[0]):
        h = relu(drift_input(y, u, xh, a, wy, drift, matmul))
        for l in range(w_inner.shape[0]):
            h = relu(mm_op(h, w_inner[l], matmul) + b_inner[l])
        z3 = mm_op(h, wout, matmul) + bo
        if latent:
            y = (y + _latent_drift(z3, y, lat, matmul) * dts[u]
                 + gk[u] * dw[u])
            ys.append(y)
            continue
        if geometric:
            z3 = z3 * torch.tanh(y)
        f = torch.tanh(z3)
        base, hn = noise_base(y, _row(gk, u), noise, elem, wn1, wn2, bn2,
                              relu, matmul)
        graw = base * y if mult_y else base
        g = torch.tanh(sth * graw)
        if rounded and is_net(noise):
            nb, nh = noise_base(bf16_round(y), _row(gk, u), noise, elem, wn1,
                                wn2, bn2, relu, matmul)
        else:
            nb, nh = base, hn
        nbs.append(nb)
        nhs.append(nh)
        y = y + f * dts[u] + g * dw[u]
        ys.append(y)
    ys = torch.stack(ys)
    if rounded:
        ys = ys.to(torch.bfloat16)
    if not is_net(noise):
        return ys, None
    return ys, EMNoise(torch.stack(nbs),
                       torch.stack(nhs) if noise == "net2" else None)


def _noise_state(ns, u, y, gk, noise, elem, wn1, wn2, bn2, relu):
    """(base, hn) of step u: the forward's streams for the nets, else
    recomputed."""
    if is_net(noise):
        if ns is None:
            raise ValueError("the noise nets' backward takes the forward's "
                             "EMNoise (ns=)")
        return ns.nb[u], None if ns.nh is None else ns.nh[u]
    return noise_base(y, _row(gk, u), noise, elem, wn1, wn2, bn2, relu)


def _backward_states(y0, ys, gys, xh, dw, stream):
    """What a reverse loop reads, in y0's dtype: the states before each
    step (y0 then ys; with bf16 streams y0 rounded as the trajectory is,
    :830-836), gys, xh and dw widened."""
    y0r = bf16_round(y0) if stream == "bf16" else y0
    return (y0r, widen(ys, y0), widen(gys, y0), widen(xh, y0),
            widen(dw, y0))


def fused_em_backward_reference(y0, ys, gys, xh, dw, a, gk, dts, theta, wy,
                                w_inner, b_inner, wout, bo, wn1=None,
                                wn2=None, bn2=None, lat=None, *,
                                mult_y: bool, geometric: bool,
                                drift: str = "embm", noise: str = "precomp",
                                elem: int = 0, latent: bool = False,
                                ns: Optional[EMNoise] = None,
                                stream: str = "f32", matmul: str = "f32",
                                relu=torch.relu):
    """Eager reverse loop mirroring the JAX `_bwd_kernel`: recompute each
    step from the state before it (the nets' outputs and hidden
    activations read from the forward's `ns`), then back through the
    diffusion bound, mult_y, the noise base (in the latent mode: the KL
    rate and the raw diffusion), the drift MLP and the drift input. `relu`
    as in the forward; its derivative is read from its output (> 0). Every
    product, the weight gradients' too, takes operand mode `matmul`; with
    `stream` 'bf16' the states are the rounded trajectory's (y0 rounded
    too), gys arrives in bf16 and dxh leaves in bf16, every other cotangent
    in y0's dtype. FusedEMGrads, FusedEMNetGrads in the nets' modes."""
    sth = torch.sigmoid(theta.reshape(()))
    n_inner = w_inner.shape[0]
    dxh_dtype = None if xh is None else xh.dtype
    y0, ys, gys, xh, dw = _backward_states(y0, ys, gys, xh, dw, stream)
    mm = lambda p, q: mm_op(p, q, matmul)
    gbar = torch.zeros_like(y0)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    dwo, dbo = torch.zeros_like(wout), torch.zeros_like(bo)
    dwy = None if wy is None else torch.zeros_like(wy)
    dwi, dbi = torch.zeros_like(w_inner), torch.zeros_like(b_inner)
    da = None if a is None else torch.empty_like(a)
    dgk = None if gk is None else torch.empty_like(gk)
    dxh = None if xh is None else torch.empty_like(xh)
    dwn1 = None if wn1 is None else torch.zeros_like(wn1)
    dwn2 = None if wn2 is None else torch.zeros_like(wn2)
    dbn2 = None if bn2 is None else torch.zeros_like(bn2)
    for u in range(dts.shape[0] - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        hs = [relu(drift_input(y, u, xh, a, wy, drift, matmul))]
        for l in range(n_inner):
            hs.append(relu(mm(hs[-1], w_inner[l]) + b_inner[l]))
        z3l = mm(hs[-1], wout) + bo
        if latent:
            dz3l, dy, q = _latent_back(gbar, y, z3l, dts[u], dw[u], lat,
                                       matmul)
            dgk[u] = q.sum(0)
        else:
            ty = torch.tanh(y)
            f = torch.tanh(z3l * ty if geometric else z3l)
            base, hn = _noise_state(ns, u, y, gk, noise, elem, wn1, wn2, bn2,
                                    relu)
            graw = base * y if mult_y else base
            g = torch.tanh(sth * graw)

            df = gbar * dts[u]
            dg = gbar * dw[u]
            dsg = dg * (1.0 - g * g)
            dth = dth + (dsg * graw).sum()
            dgraw = dsg * sth
            if mult_y:
                dbase, dy = dgraw * y, dgraw * base
            else:
                dbase, dy = dgraw, torch.zeros_like(y)
            dyn, dn, dz2 = noise_back(dbase, y, base, hn, noise, elem, wn1,
                                       wn2, matmul)
            dy = dy + dyn
            if noise == "precomp":
                dgk[u] = dbase.sum(0)
            elif is_net(noise):
                dgk[u] = dn.sum(0)
                dwn1 += mm(y.T, dn)
                if noise == "net2":
                    dwn2 += mm(hn.T, dz2)
                    dbn2 += dz2.sum(0)
            dz3 = df * (1.0 - f * f)
            if geometric:
                dz3l = dz3 * ty
                dy = dy + dz3 * z3l * (1.0 - ty * ty)
            else:
                dz3l = dz3
        dwo += mm(hs[-1].T, dz3l)
        dbo += dz3l.sum(0)
        dz = mm(dz3l, wout.T) * (hs[-1] > 0)
        for l in range(n_inner - 1, -1, -1):
            dwi[l] += mm(hs[l].T, dz)
            dbi[l] += dz.sum(0)
            dz = mm(dz, w_inner[l].T) * (hs[l] > 0)
        if drift != "xt":
            dwy += mm(y.T, dz)
            da[u] = dz.sum(0)
            dy = dy + mm(dz, wy.T)
        if drift != "yy":
            dxh[u] = dz
        gbar = gbar + dy
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    if dxh is not None and stream == "bf16":
        dxh = dxh.to(dxh_dtype)
    out = (gbar, dxh, da, dgk, dtheta, dwy, dwi, dbi, dwo, dbo)
    if is_net(noise):
        return FusedEMNetGrads(*out, dwn1, dwn2, dbn2)
    return FusedEMGrads(*out)


def fused_em_backward_recurrence_reference(y0, ys, gys, xh, dw, a, gk, dts,
                                           theta, wy, w_inner, b_inner, wout,
                                           bo, wn1=None, wn2=None, bn2=None,
                                           lat=None, *, mult_y: bool,
                                           geometric: bool,
                                           drift: str = "embm",
                                           noise: str = "precomp",
                                           elem: int = 0,
                                           latent: bool = False,
                                           ns: Optional[EMNoise] = None,
                                           stream: str = "f32",
                                           matmul: str = "f32",
                                           relu=torch.relu) -> EMStreams:
    """The backward recurrence kernel's plain version: the reverse loop of
    fused_em_backward_reference without the weight gradients, recording
    instead the streams they are formed from (EMStreams: q in mode
    'precomp', dn in the nets' modes, dz2 in net2's; None otherwise), each
    in y0's dtype whatever the stream dtype (dxh too: the weight gradient
    reads dz1 unrounded)."""
    sth = torch.sigmoid(theta.reshape(()))
    M, n_inner = dts.shape[0], w_inner.shape[0]
    B, HH = y0.shape[0], w_inner.shape[1] if n_inner else wout.shape[0]
    y0, ys, gys, xh, dw = _backward_states(y0, ys, gys, xh, dw, stream)
    mm = lambda p, q: mm_op(p, q, matmul)
    gbar = torch.zeros_like(y0)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    hs_out = y0.new_empty((n_inner + 1, M, B, HH))
    es = y0.new_empty((n_inner, M, B, HH))
    dxh = y0.new_empty((M, B, HH))
    dz3s = torch.empty_like(gys)
    qs = torch.empty_like(gys) if noise == "precomp" else None
    dns = torch.empty_like(gys) if is_net(noise) else None
    dz2s = torch.empty_like(gys) if noise == "net2" else None
    for u in range(M - 1, -1, -1):
        gbar = gbar + gys[u]
        y = y0 if u == 0 else ys[u - 1]
        hs = [relu(drift_input(y, u, xh, a, wy, drift, matmul))]
        for l in range(n_inner):
            hs.append(relu(mm(hs[-1], w_inner[l]) + b_inner[l]))
        z3l = mm(hs[-1], wout) + bo
        if latent:
            dz3l, dy, qs[u] = _latent_back(gbar, y, z3l, dts[u], dw[u], lat,
                                           matmul)
        else:
            ty = torch.tanh(y)
            f = torch.tanh(z3l * ty if geometric else z3l)
            base, hn = _noise_state(ns, u, y, gk, noise, elem, wn1, wn2, bn2,
                                    relu)
            graw = base * y if mult_y else base
            g = torch.tanh(sth * graw)
            dsg = gbar * dw[u] * (1.0 - g * g)
            dth = dth + (dsg * graw).sum()
            dgraw = dsg * sth
            if mult_y:
                dbase, dy = dgraw * y, dgraw * base
            else:
                dbase, dy = dgraw, torch.zeros_like(y)
            dyn, dn, dz2 = noise_back(dbase, y, base, hn, noise, elem, wn1,
                                       wn2, matmul)
            dy = dy + dyn
            if qs is not None:
                qs[u] = dbase
            if dns is not None:
                dns[u] = dn
            if dz2s is not None:
                dz2s[u] = dz2
            dz3 = gbar * dts[u] * (1.0 - f * f)
            if geometric:
                dz3l = dz3 * ty
                dy = dy + dz3 * z3l * (1.0 - ty * ty)
            else:
                dz3l = dz3
        dz3s[u] = dz3l
        for l in range(n_inner + 1):
            hs_out[l, u] = hs[l]
        dz = mm(dz3l, wout.T) * (hs[-1] > 0)
        for l in range(n_inner - 1, -1, -1):
            es[l, u] = dz
            dz = mm(dz, w_inner[l].T) * (hs[l] > 0)
        dxh[u] = dz
        if drift != "xt":
            dy = dy + mm(dz, wy.T)
        gbar = gbar + dy
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return EMStreams(gbar, dtheta, dxh, hs_out, es, dz3s, qs, dns, dz2s)


def fused_em_weight_grads_reference(y0, ys, dxh, hs, es, dz3, q, dn=None,
                                    dz2=None, nh=None, *,
                                    drift: str = "embm",
                                    noise: str = "precomp",
                                    matmul: str = "f32") -> EMWeightGrads:
    """The weight-gradient kernel's plain version: over K = M B rows of the
    recurrence's streams, dWy' = sum y_{u-1}^T dz1_u (not in drift mode
    'xt'), dW_l = sum h_l^T e_{l+1}, dWout = sum h_NI^T dz3 and the bias
    sums; da[u] the step's column sums of dz1 (not in 'xt'); dgk[u] those
    of q ('precomp') or of dn (the nets: the an1 rows' cotangent); the
    nets' dWn1 = sum y_{u-1}^T dn and net2's dWn2 = sum nh^T dz2 and dbn2.
    The products take operand mode `matmul`, the sums stay exact; y0 and ys
    are the states the recurrence read (bf16 ones widened to dxh's
    dtype)."""
    M, B, H = dz3.shape
    HH, n_inner = dxh.shape[2], es.shape[0]
    mm = lambda p, q_: mm_op(p, q_, matmul)
    x = torch.cat([y0[None], ys]).to(dxh.dtype)[:M].reshape(-1, H)
    dwi = torch.stack([mm(hs[l].reshape(-1, HH).T, es[l].reshape(-1, HH))
                       for l in range(n_inner)]) if n_inner else \
        dxh.new_zeros((0, HH, HH))
    xt = drift == "xt"
    dgk = (q.sum(1) if noise == "precomp"
           else dn.sum(1) if is_net(noise) else None)
    out = (None if xt else mm(x.T, dxh.reshape(-1, HH)), dwi, es.sum((1, 2)),
           mm(hs[n_inner].reshape(-1, HH).T, dz3.reshape(-1, H)),
           dz3.sum((0, 1)), None if xt else dxh.sum(1), dgk)
    if not is_net(noise):
        return EMWeightGrads(*out)
    dwn1 = mm(x.T, dn.reshape(-1, H))
    if noise == "net1":
        return EMWeightGrads(*out, dwn1)
    return EMWeightGrads(*out, dwn1, mm(nh.reshape(-1, H).T,
                                        dz2.reshape(-1, H)),
                         dz2.sum((0, 1)))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# the library, built and loaded at first launch; its launches take the
# operand mode (MATMUL_CODE) and the stream flag (1: bf16 streams) after
# the members, its plans and shared memory the stream flag
_LIB = SolverLib("fused_em", "fused EM", 19, 29,
                 int_names=SDE_INT_NAMES + ("matmul", "stream"),
                 shape_names=SDE_SHAPE_NAMES + ("stream",),
                 launches={"wgrad": 14},
                 int_fns={"plan": 10, "force_placement": 1, "force_plan": 2,
                          "wgrad_splits": 7})
_PLAN_FIELDS = ("level", "rows", "cluster", "active_clusters", "smem_bytes")
# the member axis of a packed launch's streams (EMStreams; 0 where not named)
_STREAM_AXES = {"hs": 1, "es": 1}
# the streams held in the stream dtype (bf16 with stream 'bf16'); every
# other tensor, and every internal stream, is float32
_BF16_STREAMS = ("xh", "dw", "ys", "gys")




def fused_em_plan(B: int, H: int, HH: int, n_inner: int, backward: bool,
                  drift: str = "embm", noise: str = "precomp",
                  members: int = 1, latent: bool = False,
                  stream: str = "f32") -> dict:
    """The CUDA library's plan of an EM launch of `members` members (in the
    latent mode with `latent`; with bf16 streams with `stream` 'bf16'): its
    level (0 the weight slices in shared memory, 1 the weights read from
    device memory, csrc/fused_em.cu), batch rows and CTAs a cluster,
    cudaOccupancyMaxActiveClusters (a negative CUDA error when the plan
    cannot be scheduled) and the shared bytes a CTA. Needs the card."""
    codes = mode_codes(drift, noise)
    if latent:
        codes = sde_mode(False, False, drift, noise, 0, True).codes
    shape = (B, H, HH, n_inner, *codes, members,
             precision_ints("fused EM", stream, "f32")[1], int(backward))
    return {name: _LIB.call("plan", *shape, i)
            for i, name in enumerate(_PLAN_FIELDS)}


def force_em_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make later launches take clusters of `cluster` CTAs and `rows` batch
    rows a cluster (0: the plan's own choice of each); for tests of each
    plan. Raises ValueError on a size the kernels do not take."""
    if _LIB.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no EM plan with {cluster} CTAs and {rows} rows "
                         f"a cluster")
    _LIB._kept.clear()


@functools.lru_cache(maxsize=None)
def _want(M, B, H, HH, n_inner) -> dict:
    """A member's tensors' shapes (read-only)."""
    return {"y0": (B, H), "xh": (M, B, HH), "dw": (M, B, H), "a": (M, HH),
            "gk": (M, H), "dts": (M,), "theta": (1,), "wy": (H, HH),
            "w_inner": (n_inner, HH, HH), "b_inner": (n_inner, HH),
            "wout": (HH, H), "bo": (H,), "wn1": (H, H), "wn2": (H, H),
            "bn2": (H,), "lat": (3, H), "ys": (M, B, H), "gys": (M, B, H)}


def _checked(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout, bo,
             wn1, wn2, bn2, lat, ys, gys, modes, stream="f32"):
    """check_kernel_inputs's checks; (dims, K: 0 for a solo launch)."""
    dims = kernel_dims("fused EM", y0, wout, w_inner, dts)
    got = {"y0": y0, "xh": xh, "dw": dw, "a": a, "gk": gk, "dts": dts,
           "theta": theta, "wy": wy, "w_inner": w_inner, "b_inner": b_inner,
           "wout": wout, "bo": bo, "wn1": wn1, "wn2": wn2, "bn2": bn2,
           "lat": lat, "ys": ys, "gys": gys}
    want = _want(*dims)
    K = member_count(y0)
    if K:
        want = member_shapes(want, K)
    check_tensors("fused EM", want, got, y0.device, modes,
                  bf16=_BF16_STREAMS if stream == "bf16" else ())
    return dims, K


def check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                        wout, bo, wn1=None, wn2=None, bn2=None, lat=None,
                        ys=None, gys=None, modes: Optional[SdeModes] = None,
                        stream: str = "f32"):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32 (bfloat16 for xh, dw, ys and gys with `stream` 'bf16'),
    tensors on different devices, a non-contiguous tensor,
    or a shape that disagrees with y0/w_inner/wout/dts (each but dts with a
    leading member axis in a packed launch); with `modes`, a tensor given that they do not
    take or missing where they need it (a tensor the modes do not take is
    None). Every width is taken (the plan splits the weights over a
    cluster or reads them from device memory). Returns (M, B, H, HH,
    n_inner)."""
    return _checked(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                    wout, bo, wn1, wn2, bn2, lat, ys, gys, modes, stream)[0]


def _empty(*shape, device, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=device)


def _launch_forward(dims, modes: SdeModes, tensors, stream, K: int,
                    prec=(0, 0)):
    """K members (0: a solo launch, its outputs without the member axis);
    prec: the library's (operand mode, stream flag)."""
    M, B, H, _, _ = dims
    noise, m = modes.flags["noise"], (K,) if K else ()
    dev = tensors[0].device
    ys = _empty(*m, M, B, H, device=dev,
                dtype=torch.bfloat16 if prec[1] else torch.float32)
    nb = _empty(*m, M, B, H, device=dev) if is_net(noise) else None
    nh = _empty(*m, M, B, H, device=dev) if noise == "net2" else None
    _LIB.launch("fwd", tuple(tensors) + (ys, nb, nh),
                dims + modes.ints + (max(K, 1),) + tuple(prec), stream)
    return ys, None if nb is None else EMNoise(nb, nh)


def _launch_recurrence(dims, modes: SdeModes, tensors, ns, stream,
                       K: int, prec=(0, 0)) -> EMStreams:
    """With bf16 streams (prec[1]) tensors' y0 is the rounded state, in
    bf16 as ys."""
    M, B, H, HH, n_inner = dims
    noise, m, Kn = modes.flags["noise"], (K,) if K else (), max(K, 1)
    dev = tensors[0].device
    shape = (B, H, HH, n_inner, *modes.codes, Kn, prec[1])
    ctas = -(-B // _LIB.rows(shape, backward=True)) * _LIB.kept(
        "plan", *shape, 1, 2)
    dxh, dy0 = _empty(*m, M, B, HH, device=dev), _empty(*m, B, H, device=dev)
    hs, es = (_empty(n_inner + 1, *m, M, B, HH, device=dev),
              _empty(n_inner, *m, M, B, HH, device=dev))
    per = lambda on: _empty(*m, M, B, H, device=dev) if on else None
    dz3, q = per(True), per(noise == "precomp")
    dn, dz2 = per(is_net(noise)), per(noise == "net2")
    p_th, dth = _empty(Kn * ctas, device=dev), _empty(*m, 1, device=dev)
    nb, nh = ns if ns is not None else (None, None)
    _LIB.launch("bwd", tuple(tensors) + (nb, nh, dxh, dy0, hs, es, dz3, q,
                                         dn, dz2, p_th, dth),
                dims + modes.ints + (Kn,) + tuple(prec), stream)
    return EMStreams(dy0, dth, dxh, hs, es, dz3, q, dn, dz2)


def _launch_weight_grads(y0, ys, st: EMStreams, nh, modes: SdeModes,
                         stream, K: int, prec=(0, 0)) -> EMWeightGrads:
    """From a packed launch's streams (K members), or a solo one's (K 0);
    y0 and ys float32 (the states the recurrence read)."""
    M, B, HH = st.dxh.shape[-3:]
    H, n_inner, m = y0.shape[-1], st.es.shape[0], (K,) if K else ()
    drift, noise = modes.flags["drift"], modes.flags["noise"]
    S = _LIB.kept("wgrad_splits", M, B, H, HH, n_inner, *modes.codes)
    size = lambda s: sum(wgrad_partial_sizes(s, H, HH, n_inner, drift, noise))
    p = _empty(max(K, 1), size(S), device=y0.device)
    w = _empty(*m, size(1), device=y0.device)
    da = _empty(*m, M, HH, device=y0.device) if drift != "xt" else None
    dgk = _empty(*m, M, H, device=y0.device) if noise != "elem" else None
    _LIB.launch("wgrad", (y0, ys, st.dxh, st.hs, st.es, st.dz3, st.q, st.dn,
                          st.dz2, nh, p, w, da, dgk),
                (M, B, H, HH, n_inner) + modes.ints + (max(K, 1),)
                + tuple(prec), stream)
    g = split_weight_grads(w, H, HH, n_inner, drift, noise)
    return EMWeightGrads(*g[:5], da, dgk, *g[5:])


_FWD_NAMES = ("y0", "xh", "dw", "a", "gk", "dts", "theta", "wy", "w_inner",
              "b_inner", "wout", "bo", "wn1", "wn2", "bn2", "lat")
_BWD_NAMES = ("y0", "ys", "gys") + _FWD_NAMES[1:]


def fused_em_forward(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                     wout, bo, wn1=None, wn2=None, bn2=None, lat=None, *,
                     mult_y: bool, geometric: bool, drift: str = "embm",
                     noise: str = "precomp", elem: int = 0,
                     latent: bool = False, stream: str = "f32",
                     matmul: str = "f32"):
    """(ys [M, B, H], EMNoise in the nets' modes else None), each with a
    leading member axis in a packed launch (y0 [K, B, H]): the CUDA forward
    kernel for CUDA tensors, the plain version for CPU tensors (member by
    member in a packed launch). `latent` (with its rows `lat`) takes the
    latent instance. `matmul` is the products' operand mode ('f32',
    'bf16x3', 'bf16'); with `stream` 'bf16', xh and dw come and ys goes in
    bf16 (the nets' streams stay float32)."""
    global FWD_LAUNCHES, PACKED_FWD_LAUNCHES, LATENT_FWD_LAUNCHES
    modes = sde_mode(mult_y, geometric, drift, noise, elem, latent)
    prec = precision_ints("fused EM", stream, matmul)
    args = (y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout, bo,
            wn1, wn2, bn2, lat)
    if y0.device.type == "cpu":
        check_mode("fused EM", modes, xh=xh, a=a, gk=gk, wy=wy, wn1=wn1,
                   wn2=wn2, bn2=bn2, lat=lat)
        kw = dict(**modes.flags, latent=modes.latent, stream=stream,
                  matmul=matmul)
        K = member_count(y0)
        if K:
            return per_member(fused_em_forward_reference, _FWD_NAMES, args,
                              K, **kw)
        return fused_em_forward_reference(*args, **kw)
    dims, K = _checked(*args, None, None, modes, stream)
    stream_h = _LIB.stream(y0, dims[1:] + modes.codes + (max(K, 1), prec[1]),
                           backward=False)
    out = _launch_forward(dims, modes, args, stream_h, K, prec)
    if K:
        PACKED_FWD_LAUNCHES += 1
    elif latent:
        LATENT_FWD_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "fwd", stream, matmul)
    return out


def fused_em_backward_recurrence(y0, ys, gys, xh, dw, a, gk, dts, theta, wy,
                                 w_inner, b_inner, wout, bo, wn1=None,
                                 wn2=None, bn2=None, lat=None, *,
                                 mult_y: bool, geometric: bool,
                                 drift: str = "embm", noise: str = "precomp",
                                 elem: int = 0, latent: bool = False,
                                 ns: Optional[EMNoise] = None,
                                 stream: str = "f32",
                                 matmul: str = "f32") -> EMStreams:
    """The reverse loop given gys = dL/dys (EMStreams, float32 whatever the
    stream dtype; in a packed launch each with a member axis: the first, or
    hs's and es's second): the CUDA backward recurrence kernel for CUDA
    tensors (d theta's per-CTA partials summed in the library), the plain
    version for CPU tensors. y0 is the float32 initial state (with bf16
    streams the kernel reads it rounded, as it reads ys)."""
    global BWD_LAUNCHES, PACKED_BWD_LAUNCHES, LATENT_BWD_LAUNCHES
    modes = sde_mode(mult_y, geometric, drift, noise, elem, latent)
    prec = precision_ints("fused EM", stream, matmul)
    args = (y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
            wout, bo, wn1, wn2, bn2, lat)
    if y0.device.type == "cpu":
        check_mode("fused EM", modes, xh=xh, a=a, gk=gk, wy=wy, wn1=wn1,
                   wn2=wn2, bn2=bn2, lat=lat)
        kw = dict(**modes.flags, latent=modes.latent, ns=ns, stream=stream,
                  matmul=matmul)
        K = member_count(y0)
        if K:
            return per_member(fused_em_backward_recurrence_reference,
                              _BWD_NAMES, args, K, _STREAM_AXES, **kw)
        return fused_em_backward_recurrence_reference(*args, **kw)
    if is_net(noise) and ns is None:
        raise ValueError("the noise nets' backward takes the forward's "
                         "EMNoise (ns=)")
    dims, K = _checked(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                       wout, bo, wn1, wn2, bn2, lat, ys, gys, modes, stream)
    if ns is not None:
        check_tensors("fused EM", {"nb": tuple(ys.shape),
                                   "nh": tuple(ys.shape)},
                      ns._asdict(), y0.device)
    stream_h = _LIB.stream(y0, dims[1:] + modes.codes + (max(K, 1), prec[1]),
                           backward=True)
    y0k = y0.to(torch.bfloat16) if prec[1] else y0
    st = _launch_recurrence(dims, modes, (y0k,) + args[1:16] + (lat,), ns,
                            stream_h, K, prec)
    if K:
        PACKED_BWD_LAUNCHES += 1
    elif latent:
        LATENT_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "bwd", stream, matmul)
    return st


def fused_em_weight_grads(y0, ys, st: EMStreams, nh=None, *,
                          drift: str = "embm", noise: str = "precomp",
                          matmul: str = "f32") -> EMWeightGrads:
    """The weight, bias and per-step gradients from the recurrence's
    streams (EMWeightGrads, each with a leading member axis in a packed
    launch; nh: net2's hidden activations from the forward), the products
    in operand mode `matmul`: the CUDA weight-gradient kernel for CUDA
    tensors (its split partials summed in the library, in a fixed order),
    the plain version for CPU tensors. y0 and ys are the states the
    recurrence read (with bf16 streams the rounded y0 and ys, in bf16;
    widened here)."""
    global WGRAD_LAUNCHES, PACKED_WGRAD_LAUNCHES
    # the weight gradient reads no flag but the modes (any elem option)
    modes = sde_mode(False, False, drift, noise, 7)
    prec = precision_ints("fused EM", "f32", matmul)
    stream_of = "bf16" if ys.dtype == torch.bfloat16 else "f32"
    K = member_count(y0)
    wide = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    y0, ys = wide(y0), wide(ys)
    if y0.device.type == "cpu":
        if K:
            return stack_members([fused_em_weight_grads(
                y0[k], ys[k], select_member(st, k, _STREAM_AXES),
                None if nh is None else nh[k], drift=drift, noise=noise,
                matmul=matmul) for k in range(K)])
        return fused_em_weight_grads_reference(
            y0, ys, st.dxh, st.hs, st.es, st.dz3, st.q, st.dn, st.dz2, nh,
            drift=drift, noise=noise, matmul=matmul)
    M, B, H = st.dz3.shape[-3:]
    HH, n_inner = st.dxh.shape[-1], st.es.shape[0]
    s3, m = (M, B, H), (K,) if K else ()
    want = {"y0": m + (B, H), "ys": m + s3, "dxh": m + (M, B, HH),
            "hs": (n_inner + 1,) + m + (M, B, HH),
            "es": (n_inner,) + m + (M, B, HH), "dz3": m + s3, "q": m + s3,
            "dn": m + s3, "dz2": m + s3, "nh": m + s3}
    check_tensors("fused EM", want, {"y0": y0, "ys": ys, "dxh": st.dxh,
                                     "hs": st.hs, "es": st.es,
                                     "dz3": st.dz3, "q": st.q, "dn": st.dn,
                                     "dz2": st.dz2, "nh": nh}, y0.device)
    if ((noise == "precomp") != (st.q is not None)
            or is_net(noise) != (st.dn is not None)
            or (noise == "net2") != (st.dz2 is not None and nh is not None)):
        raise ValueError(f"fused EM weight gradient ({noise}): the streams "
                         f"are not the mode's")
    stream = _LIB.stream(y0, (B, H, HH, n_inner) + modes.codes
                         + (max(K, 1), 0), backward=True)
    out = _launch_weight_grads(y0, ys, st, nh, modes, stream, K, prec)
    if K:
        PACKED_WGRAD_LAUNCHES += 1
    else:
        WGRAD_LAUNCHES += 1
    count_precision(PRECISION_LAUNCHES, "wgrad", stream_of, matmul)
    return out


def fused_em_backward(y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner,
                      b_inner, wout, bo, wn1=None, wn2=None, bn2=None,
                      lat=None, *, mult_y: bool, geometric: bool,
                      drift: str = "embm", noise: str = "precomp",
                      elem: int = 0, latent: bool = False,
                      ns: Optional[EMNoise] = None, stream: str = "f32",
                      matmul: str = "f32"):
    """Cotangents of the solve's inputs given gys = dL/dys (FusedEMGrads,
    FusedEMNetGrads in the nets' modes; in a packed launch each member's
    along a leading axis): for CUDA tensors the backward recurrence kernel,
    then the weight-gradient kernel (in the latent mode that of 'precomp':
    only dz3 differs); for CPU tensors the plain reverse loop. With bf16
    streams dxh leaves in bf16 (the recurrence's dz1 stream, which the
    weight gradient reads, stays float32)."""
    modes = dict(mult_y=mult_y, geometric=geometric, drift=drift,
                 noise=noise, elem=elem, latent=latent)
    args = (y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
            wout, bo, wn1, wn2, bn2, lat)
    prec = dict(stream=stream, matmul=matmul)
    if y0.device.type == "cpu":
        check_mode("fused EM", sde_mode(**modes), xh=xh, a=a, gk=gk, wy=wy,
                   wn1=wn1, wn2=wn2, bn2=bn2, lat=lat)
        K = member_count(y0)
        if not K:
            return fused_em_backward_reference(*args, **modes, ns=ns, **prec)
        return per_member(fused_em_backward_reference, _BWD_NAMES, args, K,
                          ns=ns, **modes, **prec)
    st = fused_em_backward_recurrence(*args, **modes, ns=ns, **prec)
    w = fused_em_weight_grads(y0.to(ys.dtype), ys, st,
                              None if ns is None else ns.nh, drift=drift,
                              noise=noise, matmul=matmul)
    dxh = st.dxh.to(xh.dtype) if xh is not None else None
    out = (st.dy0, None if drift == "yy" else dxh, w.da, w.dgk,
           st.dtheta, w.dwy, w.dw_inner, w.db_inner, w.dwout, w.dbo)
    return (FusedEMNetGrads(*out, w.dwn1, w.dwn2, w.dbn2) if is_net(noise)
            else FusedEMGrads(*out))


# launches of each kernel ('fwd', 'bwd', 'wgrad') in each reduced
# precision (operand mode, stream) since the count was last set to 0, keyed
# '<kernel> <matmul> <stream>' (also counted in the counts above)
PRECISION_LAUNCHES = precision_counts(("fwd", "bwd", "wgrad"))


_ARG_ORDER = _FWD_NAMES
# the modes every SDE pair's autograd.Function takes (FusedEM also takes
# `latent`, False when not given, and the precision `stream` and `matmul`,
# 'f32' when not given)
_MODE_KEYS = ("mult_y", "geometric", "drift", "noise", "elem")
_PRECISION_KEYS = ("stream", "matmul")


class FusedEM(torch.autograd.Function):
    """ys = EM solve of a DiffusionField (or, with the mode `latent`, of a
    LatentSDE's augmented system); backward by the backward kernels. The
    modes (a dict of _MODE_KEYS and optionally `latent`, `stream` and
    `matmul`), then the inputs in _ARG_ORDER (None where the mode takes
    none): y0 [B,H], xh [M,B,HH],
    dw [M,B,H] (not differentiated), a [M,HH], gk [M,H] (the an1 rows in
    the nets' modes), dts [M] (not differentiated), theta [1], wy [H,HH],
    w_inner [n_inner,HH,HH], b_inner [n_inner,HH], wout [HH,H], bo [H],
    wn1 [H,H], wn2 [H,H], bn2 [H], lat [3,H] (the latent rows, not
    differentiated); in a packed solve of K members each but dts with a
    leading K axis, and ys [K, M, B, H]. With `stream` 'bf16', xh and dw
    are bf16 and so is ys (and the cotangent autograd hands back)."""

    @staticmethod
    def forward(ctx, modes, *tensors):
        ys, ns = fused_em_forward(*tensors, **modes)
        ctx.save_for_backward(*tensors, ys,
                              *(ns if ns is not None else (None, None)))
        ctx.modes = modes
        return ys

    @staticmethod
    def backward(ctx, gys):
        *tensors, ys, nb, nh = ctx.saved_tensors
        modes = ctx.modes
        ns = EMNoise(nb, nh) if is_net(modes["noise"]) else None
        gr = fused_em_backward(tensors[0], ys, gys.contiguous(), *tensors[1:],
                               **modes, ns=ns)
        net = gr if is_net(modes["noise"]) else None
        return (None, gr.dy0, gr.dxh, None, gr.da, gr.dgk, None, gr.dtheta,
                gr.dwy, gr.dw_inner, gr.db_inner, gr.dwout, gr.dbo,
                net.dwn1 if net else None, net.dwn2 if net else None,
                net.dbn2 if net else None, None)


# ---------------------------------------------------------------------------
# Public entry: solve a DiffusionField SDE with the fused kernels
# ---------------------------------------------------------------------------

def fused_em_inputs(field, path, grid: np.ndarray, y0: torch.Tensor,
                    dW: torch.Tensor) -> dict:
    """The kernels' inputs for a field on a host step grid: the drift's and
    diffusion's precomputes (differentiable through autograd; None where the
    mode has none), the stacked weights in [in, out] layout, and the modes
    (_MODE_KEYS)."""
    check_supported(field, "fused EM")
    dev, f32 = y0.device, torch.float32
    t_lo, dts = stage_times(dev, grid[:-1], np.diff(grid))
    xh, a = drift_rows(field, path, grid[:-1], t_lo)
    return {"y0": y0.contiguous(), "xh": xh,
            "dw": dW.to(device=dev, dtype=f32).contiguous(), "a": a,
            "gk": noise_rows(field, t_lo), "dts": dts,
            "theta": field.theta.reshape(1), **drift_weights(field, dev),
            **noise_weights(field), "lat": None, **sde_modes(field)}


def precision_inputs(inputs: dict, stream_dtype=None, matmul=None) -> dict:
    """The kernels' inputs in a precision (resolve_precision: None from
    SNSDE_FUSED_STREAM and SNSDE_FUSED_MATMUL): the control and noise
    streams xh and dw in the stream dtype (fused_em.py:1198-1244), and the
    modes `stream` ('f32' or 'bf16') and `matmul` ('f32', 'bf16x3',
    'bf16')."""
    sd, mm = resolve_precision(stream_dtype, matmul)
    out = dict(inputs, stream="bf16" if sd == torch.bfloat16 else "f32",
               matmul=mm)
    for k in ("xh", "dw"):
        if out[k] is not None:
            out[k] = out[k].to(sd)
    return out


def solve_modes(inputs: dict, latent: bool = False) -> dict:
    """FusedEM's modes from a solve's inputs (precision_inputs')."""
    keys = _MODE_KEYS + _PRECISION_KEYS + (("latent",) if latent else ())
    return {k: inputs[k] for k in keys}



def fused_em_solve(field, path, times, y0: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None,
                   dt: Optional[float] = None,
                   dW_override: Optional[torch.Tensor] = None,
                   stream_dtype: Optional[torch.dtype] = None,
                   matmul: Optional[str] = None) -> torch.Tensor:
    """EM solve of a DiffusionField through the fused kernels. Returns ys
    [T, B, H] on the output times (time-major). Brownian increments come
    from `dW_override` [M, B, H] when given, else from `generator`.
    Matches DiffusionField.f/g except for float32 reassociation of the
    merged drift input (~1e-7 per step) and sqrt's nan_to_num taken as 0
    where y <= 0. `stream_dtype` (torch.float32 or torch.bfloat16) holds
    the control, noise, trajectory and cotangent streams, `matmul` ('f32',
    'bf16x3' or 'bf16') the in-kernel products' operands, as in the JAX
    entry (fused_em.py:1098-1339); None takes SNSDE_FUSED_STREAM and
    SNSDE_FUSED_MATMUL, exact fp32 when unset. The result is float32 (a
    bf16 trajectory widened, its first row the rounded y0)."""
    from ..models.neuralsde import resolve_dt

    dt = resolve_dt(times) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    if dW_override is None:
        dW = brownian_increments(generator, grid,
                                 (y0.shape[0], field.hidden_channels),
                                 torch.float32, y0.device)
    else:
        dW = dW_override
    inputs = precision_inputs(fused_em_inputs(field, path, grid, y0, dW),
                              stream_dtype, matmul)
    ys = FusedEM.apply(solve_modes(inputs),
                       *(inputs[k] for k in _ARG_ORDER))
    return widen_output(y0, ys)[torch.as_tensor(out_idx, device=y0.device)]


def latent_inputs(model, grid: np.ndarray, aug0: torch.Tensor,
                  dW: torch.Tensor) -> dict:
    """The kernels' inputs in the latent mode for a LatentSDE (its H - 1
    latent lanes and the KL lane) on a host step grid, as the JAX entry
    builds them (fused_em.py:1404-1452): the a row tf Wt + b_in from the
    sin/cos of each step's start time, Wy with a zero row for the KL lane,
    Wout and bo with a zero KL column (the KL lane stays out of the drift
    MLP), the gk row sigma on the latent lanes and 0 on the KL lane, and
    lat = (theta, mu, mask / sigma) [3, H] (differentiable where the
    model's parameters enter; the buffers carry no gradient)."""
    dev, f32 = aug0.device, torch.float32
    H = aug0.shape[1]
    t_lo, dts = stage_times(dev, grid[:-1], np.diff(grid))
    w_in = model.linear_in.weight                     # [HH, 2 + (H - 1)]
    HH = w_in.shape[0]
    tf = torch.stack([torch.sin(t_lo), torch.cos(t_lo)], dim=-1)   # [M, 2]
    a = (tf @ w_in[:, :2].t() + model.linear_in.bias).contiguous()
    wy = torch.cat([w_in[:, 2:].t(), w_in.new_zeros((1, HH))])     # [H, HH]
    wout = torch.cat([model.linear_out.weight.t(),
                      w_in.new_zeros((HH, 1))], dim=1)             # [HH, H]
    bo = torch.cat([model.linear_out.bias, w_in.new_zeros(1)])
    if len(model.linears):
        w_inner = torch.stack([l.weight.t() for l in model.linears])
        b_inner = torch.stack([l.bias for l in model.linears])
    else:
        w_inner = torch.zeros((0, HH, HH), dtype=f32, device=dev)
        b_inner = torch.zeros((0, HH), dtype=f32, device=dev)
    mask = latent_mask(H, dev)
    sig = model.sigma[0, 0].to(f32)
    gk = (sig * mask).expand(dts.shape[0], H).contiguous()
    isg = mask / torch.where(sig == 0.0, torch.ones_like(sig), sig)
    lat = torch.stack([model.theta[0, 0].to(f32).expand(H),
                       model.mu[0, 0].to(f32).expand(H), isg]).detach()
    return {"y0": aug0.contiguous(), "xh": None,
            "dw": dW.to(device=dev, dtype=f32).contiguous(), "a": a,
            "gk": gk, "dts": dts,
            "theta": torch.zeros(1, dtype=f32, device=dev),
            "wy": wy.contiguous(), "w_inner": w_inner, "b_inner": b_inner,
            "wout": wout.contiguous(), "bo": bo, "wn1": None, "wn2": None,
            "bn2": None, "lat": lat.contiguous(), "mult_y": False,
            "geometric": False, "drift": "yy", "noise": "precomp",
            "elem": 0, "latent": True}


def fused_latent_em_solve(model, times, aug0: torch.Tensor, *,
                          generator: Optional[torch.Generator] = None,
                          dt: Optional[float] = None,
                          dW: Optional[torch.Tensor] = None,
                          stream_dtype: Optional[torch.dtype] = None,
                          matmul: Optional[str] = None) -> torch.Tensor:
    """EM solve of a LatentSDE's augmented system (models/latent_sde.py
    f_aug/g_aug) through the latent instances of the fused kernels
    (fused_em.py:1342-1474): the posterior drift MLP, the OU prior and the
    KL rate on the card. aug0 [B, H]: the latent state and a zero KL lane.
    The increments come from `dW` [M, B, H] when given, else from
    `generator`, drawn exactly as sdeint(f_aug, g_aug, aug0, ...) draws
    them. Returns ys [T, B, H] on the output times (the KL total at
    ys[-1, :, H-1]). `stream_dtype` and `matmul` as fused_em_solve's
    (fused_em.py:1359-1376; the KL rate's product with klm in the operand
    mode too)."""
    from ..models.neuralsde import resolve_dt

    dt = resolve_dt(times) if dt is None else dt
    grid, out_idx = make_grid(times, dt)
    if dW is None:
        dW = brownian_increments(generator, grid, tuple(aug0.shape),
                                 aug0.dtype, aug0.device)
    inputs = precision_inputs(latent_inputs(model, grid, aug0, dW),
                              stream_dtype, matmul)
    ys = FusedEM.apply(solve_modes(inputs, latent=True),
                       *(inputs[k] for k in _ARG_ORDER))
    return widen_output(aug0, ys)[torch.as_tensor(out_idx,
                                                  device=aug0.device)]
