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
(~13 us and ~16 us at 3.35 TB/s and 67 TFLOP/s). Neither is the limit:
the work is a chain of 71 dependent steps, each a few [rows x 49] x
[49 x 49] products with barriers between them, over only 1024 independent
rows. The design (csrc/fused_em.cu) keeps a cluster's weight slices, state
and activations in shared memory for the whole loop, with register-tiled
products on 512 threads and the step's streams copied a step ahead; the
backward runs only the dependent chain in its loop, recomputing each
step's activations beside the previous step's chain, and writes the
streams from which one weight-gradient kernel forms the weight, bias and
per-step gradients after the loop. Exact fp32 on the CUDA cores.

As in the JAX package, the y-independent parts stay outside the kernels as
plain matrix products whose gradients come from torch autograd
(`fused_em.py:1225-1293`): the hoist xh' = (X(t) W_init + b_init) We2, the
merge Wy' = Wy We1 and a' = (tf Wt + b_in) We1 + be, and the diffusion
magnitude gk(t). The weight gradient's split partials and d theta's
per-CTA partials are summed here in a fixed order (as the JAX package sums
its per-block partials, `:905-941`), so runs are reproducible.

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
                      sum_wgrad_partials, supports_fused,
                      wgrad_partial_sizes)

__all__ = ["fused_em_solve", "fused_em_inputs", "supports_fused", "FusedEM",
           "fused_em_forward", "fused_em_backward",
           "fused_em_backward_recurrence", "fused_em_weight_grads",
           "fused_em_forward_reference", "fused_em_backward_reference",
           "fused_em_backward_recurrence_reference",
           "fused_em_weight_grads_reference", "fused_em_plan",
           "force_em_plan", "FusedEMGrads", "EMStreams", "EMWeightGrads"]

# launches of each CUDA kernel since the count was last set to 0: the
# forward, the backward recurrence and the weight gradient
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
WGRAD_LAUNCHES = 0


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


class EMWeightGrads(NamedTuple):
    """The weight gradient's products over the recurrence's streams."""
    dwy: torch.Tensor        # [H, HH]
    dw_inner: torch.Tensor   # [n_inner, HH, HH]
    db_inner: torch.Tensor   # [n_inner, HH]
    dwout: torch.Tensor      # [HH, H]
    dbo: torch.Tensor        # [H]
    da: torch.Tensor         # [M, HH]
    dgk: torch.Tensor        # [M, H]


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


def fused_em_backward_recurrence_reference(y0, ys, gys, xh, dw, a, gk, dts,
                                           theta, wy, w_inner, b_inner, wout,
                                           bo, *, mult_y: bool,
                                           geometric: bool,
                                           relu=torch.relu) -> EMStreams:
    """The backward recurrence kernel's plain version: the reverse loop of
    fused_em_backward_reference without the weight gradients, recording
    instead the streams they are formed from (EMStreams)."""
    sth = torch.sigmoid(theta.reshape(()))
    M, n_inner = dts.shape[0], w_inner.shape[0]
    gbar = torch.zeros_like(y0)
    dth = torch.zeros((), dtype=y0.dtype, device=y0.device)
    hs_out = xh.new_empty((n_inner + 1,) + tuple(xh.shape))
    es = xh.new_empty((n_inner,) + tuple(xh.shape))
    dxh, dz3s, qs = (torch.empty_like(xh), torch.empty_like(gys),
                     torch.empty_like(gys))
    for u in range(M - 1, -1, -1):
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
        dsg = gbar * dw[u] * (1.0 - g * g)
        dth = dth + (dsg * graw).sum()
        dgraw = dsg * sth
        if mult_y:
            qs[u], dy = dgraw * y, dgraw * gk[u]
        else:
            qs[u], dy = dgraw, torch.zeros_like(y)
        dz3 = gbar * dts[u] * (1.0 - f * f)
        if geometric:
            dz3l = dz3 * ty
            dy = dy + dz3 * z3l * (1.0 - ty * ty)
        else:
            dz3l = dz3
        dz3s[u] = dz3l
        for l in range(n_inner + 1):
            hs_out[l, u] = hs[l]
        dz = (dz3l @ wout.T) * (hs[-1] > 0)
        for l in range(n_inner - 1, -1, -1):
            es[l, u] = dz
            dz = (dz @ w_inner[l].T) * (hs[l] > 0)
        dxh[u] = dz
        gbar = gbar + dy + dz @ wy.T
    dtheta = (dth * sth * (1.0 - sth)).reshape(theta.shape)
    return EMStreams(gbar, dtheta, dxh, hs_out, es, dz3s, qs)


def fused_em_weight_grads_reference(y0, ys, dxh, hs, es, dz3,
                                    q) -> EMWeightGrads:
    """The weight-gradient kernel's plain version: over K = M B rows of the
    recurrence's streams, dWy' = sum y_{u-1}^T dz1_u, dW_l = sum h_l^T
    e_{l+1}, dWout = sum h_NI^T dz3 and the bias sums; da[u] and dgk[u]
    the step's column sums of dz1 and q."""
    M, B, H = dz3.shape
    HH, n_inner = dxh.shape[2], es.shape[0]
    x = torch.cat([y0[None], ys])[:M].reshape(-1, H)
    dwi = torch.stack([hs[l].reshape(-1, HH).T @ es[l].reshape(-1, HH)
                       for l in range(n_inner)]) if n_inner else \
        dxh.new_zeros((0, HH, HH))
    return EMWeightGrads(
        x.T @ dxh.reshape(-1, HH), dwi, es.sum((1, 2)),
        hs[n_inner].reshape(-1, HH).T @ dz3.reshape(-1, H),
        dz3.sum((0, 1)), dxh.sum(1), q.sum(1))


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

# built and loaded at first launch
_LIB = SolverLib("fused_em", "fused EM", 13, 21,
                 shape_names=("B", "H", "HH", "n_inner"),
                 launches={"wgrad": 10},
                 int_fns={"plan": 6, "force_placement": 1, "force_plan": 2,
                          "wgrad_splits": 5})
_PLAN_FIELDS = ("level", "rows", "cluster", "active_clusters", "smem_bytes")


def fused_em_plan(B: int, H: int, HH: int, n_inner: int,
                  backward: bool) -> dict:
    """The CUDA library's plan of an EM launch: its level (0 the weight
    slices in shared memory, 1 the weights read from device memory,
    csrc/fused_em.cu), batch rows and CTAs a cluster,
    cudaOccupancyMaxActiveClusters (a negative CUDA error when the plan
    cannot be scheduled) and the shared bytes a CTA. Needs the card."""
    shape = (B, H, HH, n_inner, int(backward))
    return {name: _LIB.call("plan", *shape, i)
            for i, name in enumerate(_PLAN_FIELDS)}


def force_em_plan(cluster: int = 0, rows: int = 0) -> None:
    """Make later launches take clusters of `cluster` CTAs and `rows`
    batch rows a cluster (0: the plan's own choice of each); for tests of
    each plan. Raises ValueError on a size the kernels do not take."""
    if _LIB.call("force_plan", cluster, rows) != 0:
        raise ValueError(f"no EM plan with {cluster} CTAs and {rows} rows "
                         f"a cluster")
    _LIB._kept.clear()


def check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                        wout, bo, ys=None, gys=None):
    """Raise ValueError on what the kernels do not take: a dtype other
    than float32, tensors on different devices, a non-contiguous tensor,
    or a shape that disagrees with y0/wy/w_inner/dts. Every width is
    taken (the plan splits the weights over a cluster or reads them from
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


def _empty(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _launch_forward(dims, flags, tensors, stream) -> torch.Tensor:
    M, B, H, _, _ = dims
    ys = _empty(M, B, H, device=tensors[0].device)
    _LIB.launch("fwd", tensors + (ys,), dims + flags, stream)
    return ys


def _launch_recurrence(dims, flags, tensors, stream) -> EMStreams:
    M, B, H, HH, n_inner = dims
    dev = tensors[0].device
    ctas = (-(-B // _LIB.rows(dims[1:], backward=True))
            * _LIB.kept("plan", B, H, HH, n_inner, 1, 2))
    dxh, dy0 = _empty(M, B, HH, device=dev), _empty(B, H, device=dev)
    hs, es = (_empty(n_inner + 1, M, B, HH, device=dev),
              _empty(n_inner, M, B, HH, device=dev))
    dz3, q = _empty(M, B, H, device=dev), _empty(M, B, H, device=dev)
    p_th = _empty(ctas, device=dev)
    _LIB.launch("bwd", tensors + (dxh, dy0, hs, es, dz3, q, p_th),
                dims + flags, stream)
    return EMStreams(dy0, p_th.sum(0, keepdim=True), dxh, hs, es, dz3, q)


def _launch_weight_grads(y0, ys, st: EMStreams, stream) -> EMWeightGrads:
    M, B, HH = st.dxh.shape
    H, n_inner = y0.shape[1], st.es.shape[0]
    S = _LIB.kept("wgrad_splits", M, B, H, HH, n_inner)
    p = _empty(sum(wgrad_partial_sizes(S, H, HH, n_inner)), device=y0.device)
    da, dgk = _empty(M, HH, device=y0.device), _empty(M, H, device=y0.device)
    _LIB.launch("wgrad", (y0, ys, st.dxh, st.hs, st.es, st.dz3, st.q, p, da,
                          dgk), (M, B, H, HH, n_inner, 0, 0), stream)
    return EMWeightGrads(*sum_wgrad_partials(p, S, H, HH, n_inner), da, dgk)


def fused_em_forward(y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
                     wout, bo, *, mult_y: bool,
                     geometric: bool) -> torch.Tensor:
    """ys [M, B, H]: the CUDA forward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global FWD_LAUNCHES
    args = (y0, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout, bo)
    if y0.device.type == "cpu":
        return fused_em_forward_reference(*args, mult_y=mult_y,
                                          geometric=geometric)
    dims = check_kernel_inputs(*args)
    stream = _LIB.stream(y0, dims[1:], backward=False)
    ys = _launch_forward(dims, (mult_y, geometric), args, stream)
    FWD_LAUNCHES += 1
    return ys


def fused_em_backward_recurrence(y0, ys, gys, xh, dw, a, gk, dts, theta, wy,
                                 w_inner, b_inner, wout, bo, *,
                                 mult_y: bool,
                                 geometric: bool) -> EMStreams:
    """The reverse loop given gys = dL/dys (EMStreams): the CUDA backward
    recurrence kernel for CUDA tensors (d theta's per-CTA partials summed
    here), the plain version for CPU tensors."""
    global BWD_LAUNCHES
    args = (y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
            wout, bo)
    if y0.device.type == "cpu":
        return fused_em_backward_recurrence_reference(
            *args, mult_y=mult_y, geometric=geometric)
    dims = check_kernel_inputs(y0, xh, dw, a, gk, dts, theta, wy, w_inner,
                               b_inner, wout, bo, ys=ys, gys=gys)
    stream = _LIB.stream(y0, dims[1:], backward=True)
    st = _launch_recurrence(dims, (mult_y, geometric), args, stream)
    BWD_LAUNCHES += 1
    return st


def fused_em_weight_grads(y0, ys, st: EMStreams) -> EMWeightGrads:
    """The weight, bias and per-step gradients from the recurrence's
    streams (EMWeightGrads): the CUDA weight-gradient kernel for CUDA
    tensors (its split partials summed here, in a fixed order), the plain
    version for CPU tensors."""
    global WGRAD_LAUNCHES
    if y0.device.type == "cpu":
        return fused_em_weight_grads_reference(y0, ys, st.dxh, st.hs, st.es,
                                               st.dz3, st.q)
    M, B, H = st.dz3.shape
    HH, n_inner = st.dxh.shape[2], st.es.shape[0]
    want = {"y0": (B, H), "ys": (M, B, H), "dxh": (M, B, HH),
            "hs": (n_inner + 1, M, B, HH), "es": (n_inner, M, B, HH),
            "dz3": (M, B, H), "q": (M, B, H)}
    check_tensors("fused EM", want, {"y0": y0, "ys": ys, "dxh": st.dxh,
                                     "hs": st.hs, "es": st.es,
                                     "dz3": st.dz3, "q": st.q}, y0.device)
    stream = _LIB.stream(y0, (B, H, HH, n_inner), backward=True)
    out = _launch_weight_grads(y0, ys, st, stream)
    WGRAD_LAUNCHES += 1
    return out


def fused_em_backward(y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner,
                      b_inner, wout, bo, *, mult_y: bool,
                      geometric: bool) -> FusedEMGrads:
    """Cotangents of the solve's inputs given gys = dL/dys: for CUDA
    tensors the backward recurrence kernel, then the weight-gradient
    kernel; for CPU tensors the plain reverse loop."""
    args = (y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner,
            wout, bo)
    if y0.device.type == "cpu":
        return fused_em_backward_reference(*args, mult_y=mult_y,
                                           geometric=geometric)
    st = fused_em_backward_recurrence(*args, mult_y=mult_y,
                                      geometric=geometric)
    w = fused_em_weight_grads(y0, ys, st)
    return FusedEMGrads(st.dy0, st.dxh, w.da, w.dgk, st.dtheta, w.dwy,
                        w.dw_inner, w.db_inner, w.dwout, w.dbo)


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
