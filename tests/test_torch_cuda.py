"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device.

The module imports torch, numpy and snsde_torch only, never JAX, so it
runs on a machine with the card and no JAX (tests/conftest.py imports
JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

The shapes are the awkward ones the main paths do not reach: a batch
that leaves the last 8-row tile ragged, the sepsis width H=49, and zero,
one and two inner layers (for the CDE pair: every tableau, both fields,
and a control of 35 channels), each at two scales of the weights:
- "init": weights at the scale of the layers' init (1/sqrt(fan_in)), so
  the trajectory stays O(1) as in training. The kernels are held to
  chip_smoke.py's tolerances: the trajectory's largest error from the
  plain version, over its largest entry, at most 5e-6 (chip_smoke.TOL_YS),
  for the CDE pair the larger of that and 8 times the float32 plain
  version's own largest error from float64 (chip_smoke.YS_F64_FACTOR,
  where the readings they were set from stand); every cotangent 1e-5
  relative to its largest entry.
- "wide": weights of N(0,1)/2 and biases of N(0,1), the inputs of the
  CPU tests: large activations and saturated tanh. The trajectory grows
  several-fold over the steps, and the float32 plain version itself then
  drifts from its float64 result by more than those tolerances. So this
  case is judged against a float64 run of the plain version: each
  output's root-mean-square error from it, over its largest entry, may
  be at most F64_FACTOR times the float32 plain version's own, plus
  F64_FLOOR. The mean square, not the largest error: the largest error of
  a float32 run sits on the few rows that grow fastest, and moves by
  several-fold with the order of summation alone (on the card, EM (4,17)
  wide: kernel 4.05e-5, float32 plain 8.64e-6; the plain version on the
  CPU 2.2e-5), while the mean over every entry does not. The CDE pair's
  wide cases step by dt = 0.05, not 0.5: at 0.5 with these weights two of
  its solves are chaotic (the float32 plain version 0.3 of max|ys| from
  float64 on the card), and a rule relative to the plain version's error
  would then pass almost any kernel. At 0.05 every output of the float32
  plain version stays within 3.4e-5 of its largest entry from float64
  (on an H100; run with -s to see the readings).
Both cases also pass that float64 check, and print its readings, largest
and root-mean-square (run pytest with -s to see them).

The EM, SRK and CDE pairs also run at H = HH = 128 (one and two inner
layers) and 256, where the weights no longer fit a block's shared memory,
in every placement forced once (the CDE pair: the levels of its plan,
csrc/fused_cde.cu; the EM and SRK pairs: their plan's levels, the weight
slices in shared memory or the weights in device memory, with clusters of
1, 2, 4 and 8 CTAs, csrc/sde_hopper.cuh), under the init-scale rules. The
EM and SRK pairs' own plans at H = HH = 256 are clusters; each pair's
weight-gradient kernel runs alone against its plain version; each
backward is bit-reproducible (the EM's at the sepsis width and at 128,
the SRK's at the MuJoCo width and at 128), and a plan that cannot run
raises.

The EM and SRK pairs' drift modes 'yy' and 'xt' and noise modes 'elem',
'net1' and 'net2' run at the sepsis width and at H = 16 on a ragged batch
with zero to two inner layers, under the init-scale rules (every drift
mode with every new noise mode, sqrt noise on states of either sign; the
trajectory and cotangents of these by the float64 rule, YS_F64_FACTOR, as
sqrt noise near 0 amplifies float32 rounding), net2 also at H = HH = 128
and 256, and each pair's weight-gradient kernel alone in the nets' modes.

The CDE pair splits Wout over a thread-block cluster: it also runs with
each cluster size forced (1, 2, 4 and 8 CTAs; H = 20 leaves the last CTAs
of a cluster of 8 two units and none) at several rows a cluster on a
ragged batch at C = 6 and 35, on every tableau and activation with zero,
one and two inner layers in a cluster of two, with the backward keeping
the stage activations and recomputing them; its backward is
bit-reproducible, its plan splits Wout as the host rule says, and a plan
that cannot run raises.

The GRU and LSTM pairs run at init-scale weights over H = 5 ... 512, a
ragged batch, with and without the GRU's decay stream, under the same
rules: hs within 5e-6 of its largest entry, every cotangent within 1e-5,
the float64 rms rule on every output. Both pairs split W_hh over a
thread-block cluster: each also runs at every kind of its plan (one CTA;
clusters of 2, 4 and 8 CTAs with the W_hh slices in shared memory, units
split evenly and raggedly; the slices in device memory) at two batches
(the GRU with and without its decay), in both scan directions, and its
backward is bit-reproducible; the LSTM also as the inference primal. The
weight-gradient kernel they share runs alone against its plain version.
The plain-mode pairs are also held against cuDNN (`torch.nn.GRU`/
`torch.nn.LSTM` with TF32 off) on the same weights.

The ODE-RNN hybrids' instances (the GRU pair's obs, obs + decay row and
obs + evolve modes, the LSTM pair's evolve; one to three evolve layers,
one and two substeps) run under every kind of plan, forced
(`force_rnn_plan`: the host's own, one CTA, clusters of 2, 4 and 8 with
H = 20 leaving the last CTAs two units and none), on ragged batches, by
the same rules, each launch counted in its own counter; at H = 256 under
the plan's cluster of 8; their backwards bit-reproducible; and the four
hybrids' registry layers through the kernels against their eager loops on
the card.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import copy

import numpy as np
import pytest
import torch

from snsde_torch.kernels import fused_cde as fc
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels import fused_rnn as fr
from snsde_torch.kernels import fused_srk as fs
from snsde_torch.kernels._solver import (DRIFT_BY_IO, ELEM_NO, MULT_Y_NO,
                                        noise_mode)
from snsde_torch.models.rnn import scan_cell
from snsde_torch.nn.layers import GRUCell, LSTMCell

CASES = [(4, 17, 1), (2, 16, 2), (6, 17, 0)]
# (method, activation, inner layers, control channels, H = HH) of the CDE
# pair; the last is the width of the sepsis CDE bench shape, whose output
# weight fills most of a block's shared memory
CDE_CASES = [("euler", "relu", 1, 6, 49), ("midpoint", "tanh", 0, 6, 49),
             ("heun", "relu", 2, 6, 49), ("rk4", "relu", 0, 6, 49),
             ("rk4", "tanh", 0, 6, 49), ("rk4", "relu", 1, 35, 32)]
SCALES = ["init", "wide"]
RNN_H = [5, 8, 16, 32, 128, 512]
# LSTM widths at each kind of plan (at B = 13 and 100): one CTA (16, 64,
# 96), clusters of 2 (128), 4 (200) and 8 CTAs (256; 250 leaves the last
# CTA 26 units of 32) with the W_hh slices in shared memory, and the slices
# in device memory (512)
LSTM_PLAN_H = [16, 64, 96, 128, 200, 250, 256, 512]
F64_FACTOR = 4.0
F64_FLOOR = 1e-5
TOL_YS = 5e-6           # chip_smoke.TOL_YS
YS_F64_FACTOR = 8.0     # chip_smoke.YS_F64_FACTOR
TOL_GRAD = 1e-5


def _inputs(srk, io, no, n_inner, scale, B=20, M=9, H=49, seed=0):
    """Random kernel inputs on the card in the solver's argument order, at
    the weight scale `scale` names, and the cotangent gys."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda")
    k, kb = (1.0 / np.sqrt(H),) * 2 if scale == "init" else (0.5, 1.0)
    common = dict(dts=torch.full((M,), 0.5, device="cuda"), theta=t(1),
                  wy=k * t(H, H), w_inner=k * t(n_inner, H, H),
                  b_inner=kb * t(n_inner, H), wout=k * t(H, H), bo=kb * t(H))
    if srk:
        streams = dict(y0=t(B, H), xh0=t(M, B, H), xh1=t(M, B, H),
                       dw=0.7 * t(M, B, H), i10=0.2 * t(M, B, H),
                       a0=t(M, H), a1=t(M, H), gk0=t(M, H).abs(),
                       gk1=t(M, H).abs(), gk2=t(M, H).abs())
    else:
        streams = dict(y0=t(B, H), xh=t(M, B, H), dw=0.3 * t(M, B, H),
                       a=t(M, H), gk=t(M, H).abs())
    flags = dict(mult_y=no in MULT_Y_NO, geometric=io in (5, 6))
    # init: the cotangent of a batch-mean loss; wide: N(0,1), as on the CPU
    gys = t(M, B, H) / (B if scale == "init" else 1)
    return {**streams, **common}, flags, gys


def _cde_inputs(method, act, n_inner, C, scale, B=20, M=9, H=49, seed=0):
    """Random inputs of the CDE pair on the card, at the weight scale
    `scale` names, and the cotangent gys."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda")
    HH = H
    NT = len(fc._stage_times(method)[0])
    k, kb = (1.0 / np.sqrt(H),) * 2 if scale == "init" else (0.5, 1.0)
    dt = 0.5 if scale == "init" else 0.05
    inputs = dict(z0=t(B, H), dx=t(M, B, NT * C),
                  dts=torch.full((M,), dt, device="cuda"))
    if act == "gruode":         # the GRU-ODE field: three gates, no MLP
        inputs.update(dict.fromkeys(("win", "bin", "w_inner", "b_inner",
                                     "wout", "bout")),
                      wg=k * t(3, H, H * C), bg=kb * t(3, H * C))
    else:
        inputs.update(win=k * t(H, HH), bin=kb * t(HH),
                      w_inner=k * t(n_inner, HH, HH),
                      b_inner=kb * t(n_inner, HH), wout=k * t(HH, H * C),
                      bout=kb * t(H * C))
    gys = t(M, B, H) / (B if scale == "init" else 1)
    return inputs, dict(method=method, act=act), gys


def _errs(a, ref):
    """(largest, root-mean-square) error of a from ref, each over ref's
    largest entry."""
    d = a.double() - ref
    scale = max(float(ref.abs().max()), 1e-30)
    return (float(d.abs().max()) / scale,
            float(d.square().mean().sqrt()) / scale)


def _mode_inputs(srk, io, no, n_inner, B=20, M=9, H=49, seed=0):
    """Random init-scale kernel inputs on the card of a drift and noise
    mode (None where the mode takes none), its flags, and gys."""
    inputs, flags, gys = _inputs(srk, io, no, n_inner, "init", B=B, M=M, H=H,
                                 seed=seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda")
    drift, noise = DRIFT_BY_IO[io], noise_mode(no)
    flags.update(drift=drift, noise=noise, elem=no if no in ELEM_NO else 0)
    none = {"yy": ("xh", "xh0", "xh1"), "xt": ("a", "a0", "a1", "wy"),
            "embm": ()}[drift]
    if noise == "elem":
        none += ("gk", "gk0", "gk1", "gk2")
    for name in none:
        if name in inputs:
            inputs[name] = None
    k = 1.0 / np.sqrt(H)
    inputs.update(wn1=k * t(H, H) if noise in ("net1", "net2") else None,
                  wn2=k * t(H, H) if noise == "net2" else None,
                  bn2=k * t(H) if noise == "net2" else None)
    return inputs, flags, gys


def _check(fns, inputs, flags, gys, scale, ys_f64_factor=0.0,
           grad_f64_factor=0.0):
    fwd, fwd_ref, bwd, bwd_ref = fns
    ys_k, ns_k = fwd(**inputs, **flags)
    ys_p, ns_p = fwd_ref(**inputs, **flags)
    g_k = bwd(ys=ys_p, gys=gys, **inputs, **flags, ns=ns_p)
    g_p = bwd_ref(ys=ys_p, gys=gys, **inputs, **flags, ns=ns_p)
    in64 = {k: None if v is None else v.double() for k, v in inputs.items()}
    ys_64, ns_64 = fwd_ref(**in64, **flags)
    g_64 = bwd_ref(ys=ys_64, gys=gys.double(), **in64, **flags, ns=ns_64)
    torch.cuda.synchronize()
    outs = [("ys", ys_k, ys_p, ys_64)] + [
        (f"ns.{name}", a, b, c)
        for name, a, b, c in zip(ns_p._fields if ns_p else (), ns_k or (),
                                 ns_p or (), ns_64 or ()) if c is not None
    ] + [(name, a, b, c) for name, a, b, c in zip(g_p._fields, g_k, g_p, g_64)
         if c is not None and c.numel()]
    plain_max = {}
    for name, k_, p_, ref in outs:
        (k_max, k_rms), (p_max, p_rms) = _errs(k_, ref), _errs(p_, ref)
        plain_max[name] = p_max
        print(f"{scale} {name}: max|float64| {float(ref.abs().max()):.3e}, "
              f"error from float64 over it (largest, rms): kernel "
              f"{k_max:.2e} {k_rms:.2e}, float32 plain {p_max:.2e} "
              f"{p_rms:.2e}")
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, (
            f"{name}: rms error from float64: kernel {k_rms:.2e}, float32 "
            f"plain {p_rms:.2e}")
    if scale == "init":
        for name, a, b, _ in outs:
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            tol = (max(TOL_YS, ys_f64_factor * plain_max[name])
                   if name == "ys" or name.startswith("ns.")
                   else max(TOL_GRAD, grad_f64_factor * plain_max[name]))
            assert rel < tol, f"{name}: rel err {rel:.2e}"


def _fns(mod, pre):
    """(forward, plain forward, backward, plain backward), each forward
    returning (ys, the noise nets' streams or None) and each backward
    taking those streams as `ns`: the CDE pair's, which return ys alone
    and take no streams, wrapped to that form."""
    fns = tuple(getattr(mod, f"{pre}_{n}") for n in (
        "forward", "forward_reference", "backward", "backward_reference"))
    if pre != "fused_cde":
        return fns
    fwd = lambda f: lambda **k: (f(**k), None)
    bwd = lambda f: lambda ns=None, **k: f(**k)
    return fwd(fns[0]), fwd(fns[1]), bwd(fns[2]), bwd(fns[3])


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("io,no,n_inner", CASES)
def test_em_kernels_match_plain_versions(io, no, n_inner, scale):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _inputs(False, io, no, n_inner, scale)
    _check(_fns(fe, "fused_em"), inputs, flags, gys, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("io,no,n_inner", CASES)
def test_srk_kernels_match_plain_versions(io, no, n_inner, scale):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _inputs(True, io, no, n_inner, scale)
    _check(_fns(fs, "fused_srk"), inputs, flags, gys, scale)


@pytest.mark.cuda
def test_srk_zero_step_is_identity_on_the_card():
    """dt = 0 steps leave y exactly as it was in the kernel too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, _ = _inputs(True, 4, 17, 1, "init")
    inputs["dts"] = torch.zeros_like(inputs["dts"])
    inputs["dw"] = torch.zeros_like(inputs["dw"])
    inputs["i10"] = torch.zeros_like(inputs["i10"])
    ys, _ = fs.fused_srk_forward(**inputs, **flags)
    torch.cuda.synchronize()
    assert torch.equal(ys, inputs["y0"].expand_as(ys))


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("method,act,n_inner,C,H", CDE_CASES)
def test_cde_kernels_match_plain_versions(method, act, n_inner, C, H, scale):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _cde_inputs(method, act, n_inner, C, scale, H=H)
    _check(_fns(fc, "fused_cde"), inputs, flags, gys, scale,
           ys_f64_factor=YS_F64_FACTOR)


@pytest.mark.cuda
def test_cde_zero_step_is_identity_on_the_card():
    """dt = 0 steps leave z exactly as it was, and move no weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _cde_inputs("rk4", "relu", 1, 6, "init")
    inputs["dts"] = torch.zeros_like(inputs["dts"])
    ys = fc.fused_cde_forward(**inputs, **flags)
    g = fc.fused_cde_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.cuda.synchronize()
    assert torch.equal(ys, inputs["z0"].expand_as(ys))
    assert not g.dwin.any() and not g.dwout.any() and not g.ddx.any()


@pytest.mark.cuda
def test_cde_kernels_raise_above_the_shared_memory_limit():
    """A field whose output weight does not fit a cluster's shared memory
    (H = 128, C = 64: Wout 4 MB) runs, its weights read from device
    memory; only a field whose tiles alone overflow a CTA at one batch row
    (H = 4096: its stage increments) raises ValueError naming the limit,
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _cde_inputs("rk4", "relu", 0, 64, "init", H=128,
                                     B=3, M=2)
    shape = (3, 128, 128, 64, 0, 3, 0, 1)    # rk4, relu, one member
    assert fc._LIB.placement(shape, backward=False) >= 2
    _check(_fns(fc, "fused_cde"), inputs, flags, gys, "init",
           ys_f64_factor=YS_F64_FACTOR)
    inputs, flags, _ = _cde_inputs("rk4", "relu", 0, 16, "init", H=4096,
                                   B=1, M=1)
    with pytest.raises(ValueError, match="limit per block"):
        fc.fused_cde_forward(**inputs, **flags)


def _rnn_inputs(kind, H, B=13, L=9, dec=False, seed=0):
    """Random inputs of the GRU or LSTM pair on the card at init-scale
    weights (U(-1/sqrt(H), 1/sqrt(H))), gi ~ N(0, 1) (a projection of unit
    inputs), and the cotangent of a batch-mean loss."""
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    t = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    k = 1.0 / np.sqrt(H)
    inputs = dict(gi=t(rng.normal(size=(L, B, G * H))),
                  whh=t(rng.uniform(-k, k, size=(H, G * H))),
                  bhh=t(rng.uniform(-k, k, size=(G * H,))))
    if kind == "gru":
        inputs["h0"] = t(0.5 * rng.normal(size=(B, H)))
        if dec:
            inputs["hdec"] = t(rng.uniform(0.2, 1.0, size=(L, B, H)))
    return inputs, t(rng.normal(size=(L, B, H)) / B)


def _rnn_run(kind, fwd, bwd, inputs, ghs):
    """(hs, the backward's outputs by name) of one pair's two functions."""
    if kind == "gru":
        hs = fwd(**inputs)
        g = bwd(hs=hs, ghs=ghs, **inputs)
        outs = {"hs": hs, **{n: v for n, v in zip(g._fields, g)
                             if v is not None}}
    else:
        hs, cs, _ = fwd(**inputs)
        g = bwd(hs=hs, cs=cs, ghs=ghs, **inputs)
        outs = {"hs": hs, "cs": cs, **{n: v for n, v in zip(g._fields, g)
                                       if v is not None}}
    return outs


def _check_rnn(kind, inputs, ghs):
    mod = fr
    k = _rnn_run(kind, getattr(mod, f"fused_{kind}_forward"),
                 getattr(mod, f"fused_{kind}_backward"), inputs, ghs)
    ref = lambda n: getattr(mod, f"fused_{kind}_{n}_reference")
    p = _rnn_run(kind, ref("forward"), ref("backward"), inputs, ghs)
    r64 = _rnn_run(kind, ref("forward"), ref("backward"),
                   {n: v.double() for n, v in inputs.items()}, ghs.double())
    torch.cuda.synchronize()
    assert set(k) == set(p)
    for name in k:
        (k_max, k_rms), (p_max, p_rms) = (_errs(k[name], r64[name]),
                                          _errs(p[name], r64[name]))
        print(f"{kind} {name}: error from float64 over max (largest, rms): "
              f"kernel {k_max:.2e} {k_rms:.2e}, float32 plain {p_max:.2e} "
              f"{p_rms:.2e}")
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, name
        rel = float((k[name] - p[name]).abs().max()) / max(
            float(p[name].abs().max()), 1e-30)
        tol = TOL_YS if name in ("hs", "cs") else TOL_GRAD
        assert rel < tol, f"{kind} {name}: rel err {rel:.2e}"


@pytest.mark.cuda
@pytest.mark.parametrize("H", RNN_H)
@pytest.mark.parametrize("kind,dec", [("gru", False), ("gru", True),
                                      ("lstm", False)])
def test_rnn_kernels_match_plain_versions(kind, dec, H):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, ghs = _rnn_inputs(kind, H, dec=dec, B=13 if H < 512 else 16,
                              L=9 if H < 512 else 5)
    _check_rnn(kind, inputs, ghs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_scan_on_the_card_matches_the_eager_loop(kind, reverse):
    """fused_*_scan (projection, flips, the kernels) against the eager loop
    over the cell, in both directions: hs and every gradient (xs and the
    cell's four parameters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(3)
    L, B, C, H = 11, 21, 6, 16
    cell = (GRUCell if kind == "gru" else LSTMCell)(
        C, H, generator=torch.Generator().manual_seed(0)).cuda()
    xs = torch.as_tensor(rng.normal(size=(L, B, C)).astype(np.float32),
                         device="cuda")
    w = torch.as_tensor(rng.normal(size=(L, B, H)).astype(np.float32),
                        device="cuda")
    scan = getattr(fr, f"fused_{kind}_scan")
    outs = []
    for f in (lambda x: scan(cell, x, reverse=reverse),
              lambda x: scan_cell(cell, x, reverse)):
        cell.zero_grad()
        x = xs.clone().requires_grad_(True)
        hs = f(x)
        (hs * w).sum().backward()
        outs.append([hs.detach(), x.grad] + [p.grad for p in
                                             cell.parameters()])
    for a, b in zip(*outs):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert rel < TOL_GRAD, rel


def _recurrence_grads(kind, cell, xs, w, h0):
    """hs and the gradients (w_ih, b_ih, w_hh, b_hh, h0 for the GRU) of
    sum(hs * w) through the fused scan (or, in float64, the eager loop)."""
    h0 = h0.clone().requires_grad_(True)
    if kind == "gru":
        hs = (fr.fused_gru_scan(cell, xs, h0=h0) if xs.dtype == torch.float32
              else _eager_gru(cell, xs, h0))
    else:
        hs = (fr.fused_lstm_scan(cell, xs) if xs.dtype == torch.float32
              else scan_cell(cell, xs))
    (hs * w).sum().backward()
    out = [hs.detach()] + [p.grad for p in (cell.w_ih, cell.b_ih, cell.w_hh,
                                            cell.b_hh)]
    return out + ([h0.grad] if kind == "gru" else [])


def _eager_gru(cell, xs, h, hdec=None):
    """The eager loop over the cell, the state decayed before each step
    when hdec is given."""
    hs = []
    for t in range(xs.shape[0]):
        h = cell(xs[t], h if hdec is None else h * hdec[t])
        hs.append(h)
    return torch.stack(hs)


def _cudnn_grads(kind, cell, xs, w, h0):
    """The same through torch.nn.GRU / nn.LSTM (cuDNN) with the cell's
    weights."""
    C, H = cell.w_ih.shape[0], cell.hidden_size
    lib = (torch.nn.GRU if kind == "gru" else torch.nn.LSTM)(C, H).cuda()
    with torch.no_grad():
        lib.weight_ih_l0.copy_(cell.w_ih.T)
        lib.weight_hh_l0.copy_(cell.w_hh.T)
        lib.bias_ih_l0.copy_(cell.b_ih)
        lib.bias_hh_l0.copy_(cell.b_hh)
    h0 = h0.clone()[None].requires_grad_(True)
    hs, _ = lib(xs, h0) if kind == "gru" else lib(xs)
    (hs * w).sum().backward()
    out = [hs.detach(), lib.weight_ih_l0.grad.T, lib.bias_ih_l0.grad,
           lib.weight_hh_l0.grad.T, lib.bias_hh_l0.grad]
    return out + ([h0.grad[0]] if kind == "gru" else [])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_rnn_kernels_match_cudnn(kind):
    """The pairs in the plain mode against torch.nn.GRU / nn.LSTM (cuDNN,
    TF32 off) with the same weights: hs and the gradients of the input
    projection, W_hh, b_hh (and h0 for the GRU). cuDNN's sums and its
    gate functions round differently (its LSTM hs is 9.5e-6 of the
    largest entry from the kernel's at this shape, on an H100), so, as for
    the CDE pair, each output may differ by the larger of the kernel
    tolerance and YS_F64_FACTOR times cuDNN's own largest error from a
    float64 run, and the kernel's rms error from float64 may be at most
    F64_FACTOR times cuDNN's, plus F64_FLOOR."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    L, B, C, H = 12, 37, 6, 32
    mk = GRUCell if kind == "gru" else LSTMCell
    cell = mk(C, H, generator=torch.Generator().manual_seed(1)).cuda()
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda")
    xs, w, h0 = t(L, B, C), t(L, B, H), t(B, H)
    k = _recurrence_grads(kind, cell, xs, w, h0)
    lib = _cudnn_grads(kind, cell, xs, w, h0)
    ref = _recurrence_grads(kind, copy.deepcopy(cell).double(), xs.double(),
                            w.double(), h0.double())
    names = ["hs", "dw_ih", "db_ih", "dw_hh", "db_hh", "dh0"]
    for name, a, b, r in zip(names, k, lib, ref):
        (k_max, k_rms), (l_max, l_rms) = _errs(a, r), _errs(b, r)
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        tol = max(TOL_YS if name == "hs" else TOL_GRAD,
                  YS_F64_FACTOR * l_max)
        print(f"{kind} {name} vs cuDNN: rel {rel:.2e} (tol {tol:.2e}); from "
              f"float64 (largest, rms): kernel {k_max:.2e} {k_rms:.2e}, "
              f"cuDNN {l_max:.2e} {l_rms:.2e}")
        assert rel < tol, name
        assert k_rms <= F64_FACTOR * l_rms + F64_FLOOR, name


@pytest.mark.cuda
def test_lstm_forward_without_grad_writes_no_cell_states():
    """With grad mode off the LSTM forward kernel runs with no cell-state
    stream and gives the same hs as the training forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, _ = _rnn_inputs("lstm", 32)
    hs, cs, _ = fr.fused_lstm_forward(**inputs, save_cs=True)
    hs2, cs2, _ = fr.fused_lstm_forward(**inputs, save_cs=False)
    assert cs is not None and cs2 is None
    assert torch.equal(hs, hs2)
    cell = LSTMCell(6, 32, generator=torch.Generator().manual_seed(0)).cuda()
    xs = torch.randn(9, 13, 6, device="cuda")
    before = fr.LSTM_FWD_LAUNCHES
    with torch.no_grad():
        a = fr.fused_lstm_scan(cell, xs)
    b = fr.fused_lstm_scan(cell, xs)
    assert fr.LSTM_FWD_LAUNCHES == before + 2
    assert torch.equal(a, b.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [13, 100])
@pytest.mark.parametrize("H", LSTM_PLAN_H)
def test_lstm_cluster_plans_match_plain_versions(H, B):
    """The LSTM pair against its plain versions at every kind of plan (the
    tolerances of _check_rnn)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    plan = fr.fused_lstm_plan(H, B, backward=True)
    print(f"H={H} B={B} backward plan {plan}")
    assert plan["active_clusters"] >= 1
    inputs, ghs = _rnn_inputs("lstm", H, B=B, L=9 if H < 512 else 5)
    _check_rnn("lstm", inputs, ghs)


@pytest.mark.cuda
def test_lstm_plan_splits_w_hh_as_it_must():
    """W_hh in one CTA up to H = 96; split over 2 CTAs at H = 128 (its
    256 KB exceed a CTA's shared memory) and over 8 at H = 256, at the
    bench batch; read from device memory at H = 512."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    for backward in (False, True):
        got = {H: fr.fused_lstm_plan(H, 1024, backward)
               for H in (32, 64, 96, 128, 256, 512)}
        assert [got[H]["cluster"] for H in got] == [1, 1, 1, 2, 8, 8]
        assert [got[H]["w_smem"] for H in got] == [1, 1, 1, 1, 1, 0]
        assert got[128]["rows"] == 16
        assert all(p["active_clusters"] >= 1 for p in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 250])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_at_cluster_widths_matches_the_eager_loop(H, reverse):
    """fused_lstm_scan through the cluster kernels against the eager loop
    over the cell, both directions: hs and every gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(6)
    L, B, C = 10, 37, 6
    cell = LSTMCell(C, H, generator=torch.Generator().manual_seed(0)).cuda()
    xs = torch.as_tensor(rng.normal(size=(L, B, C)).astype(np.float32),
                         device="cuda")
    w = torch.as_tensor(rng.normal(size=(L, B, H)).astype(np.float32) / B,
                        device="cuda")
    outs = []
    for f in (lambda x: fr.fused_lstm_scan(cell, x, reverse=reverse),
              lambda x: scan_cell(cell, x, reverse)):
        cell.zero_grad()
        x = xs.clone().requires_grad_(True)
        hs = f(x)
        (hs * w).sum().backward()
        outs.append([hs.detach(), x.grad] + [p.grad for p in
                                             cell.parameters()])
    for a, b in zip(*outs):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert rel < TOL_GRAD, rel


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 512])
def test_lstm_inference_primal_at_cluster_widths(H):
    """Without a cell-state stream the cluster forward gives the same hs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, _ = _rnn_inputs("lstm", H, B=100)
    hs, cs, _ = fr.fused_lstm_forward(**inputs, save_cs=True)
    hs2, cs2, _ = fr.fused_lstm_forward(**inputs, save_cs=False)
    assert cs is not None and cs2 is None
    assert torch.equal(hs, hs2)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 128, 250, 512])
def test_lstm_backward_is_bit_reproducible(H):
    """Two backward calls on the same inputs give bitwise-equal outputs:
    no atomics, the cluster's partials and the weight gradient's split
    partials summed in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, ghs = _rnn_inputs("lstm", H, B=100)
    hs, cs, _ = fr.fused_lstm_forward(**inputs)
    a = fr.fused_lstm_backward(hs=hs, cs=cs, ghs=ghs, **inputs)
    b = fr.fused_lstm_backward(hs=hs, cs=cs, ghs=ghs, **inputs)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
def test_lstm_weight_grad_kernel_matches_its_plain_version():
    """The weight-gradient kernel alone, at a width that is not a multiple
    of 4 (its 4-byte copies) and one that is, against the plain product:
    within TOL_GRAD of the largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(7)
    for L, B, H in ((13, 37, 5), (72, 1024, 128), (3, 8, 250)):
        t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                       device="cuda")
        hs, dgi = t(L, B, H), t(L, B, 4 * H)
        before = fr.LSTM_WGRAD_LAUNCHES
        k = fr.fused_lstm_weight_grads(hs, dgi)
        p = fr.fused_lstm_weight_grads_reference(hs, dgi)
        assert fr.LSTM_WGRAD_LAUNCHES == before + 1
        for a, b in zip(k, p):
            rel = float((a - b).abs().max()) / float(b.abs().max())
            assert rel < TOL_GRAD, (L, B, H, rel)


# (H = HH, inner layers) of the wide SDE and CDE cases: past the shared
# memory of one block for the weights and their gradient accumulators
WIDE = [(128, 1), (128, 2), (256, 1)]
# placements, each forced once at H = HH = 128 with one inner layer: the
# CDE pair's plan's levels from 0 on
PLACEMENTS = [0, 1, 2, 3, 4, 5]
# the EM and SRK pairs' (csrc/sde_hopper.cuh: sde_plan) at the same six
# cases: (the lowest level, CTAs a cluster, rows a cluster; 0 the plan's
# own choice): its own plan, level 1 (the weights in device memory),
# clusters of 2, 4 and 8 with the weight slices in shared memory, and
# level 1 in clusters of 8
EM_FORCED = {0: (0, 0, 0), 1: (1, 0, 0), 2: (0, 2, 0), 3: (0, 4, 4),
             4: (0, 8, 2), 5: (1, 8, 1)}
SDE = {"em": (fe, "fused_em"), "srk": (fs, "fused_srk")}


def _sde_force(kind, level, cs, rows):
    mod, pre = SDE[kind]
    mod._LIB.force_placement(level)
    getattr(mod, f"force_{kind}_plan")(cs, rows)


def _wide_check(kind, H, n_inner, placement):
    """One SDE or CDE pair at H = HH with `placement` forced (the lowest
    level the CDE plan may take; for the EM and SRK pairs the plan
    EM_FORCED names), against its plain versions: init-scale rules."""
    mod, pre = {"em": (fe, "fused_em"), "srk": (fs, "fused_srk"),
                "cde": (fc, "fused_cde")}[kind]
    if kind == "cde":
        inputs, flags, gys = _cde_inputs("rk4", "relu", n_inner, 6, "init",
                                         B=13, M=4, H=H)
        shape = (13, H, H, 6, n_inner, 3, 0, 1)  # rk4, relu, 1 member
    else:
        inputs, flags, gys = _inputs(kind == "srk", 4, 17, n_inner, "init",
                                     B=13, M=5, H=H)
        shape = (13, H, H, n_inner, 0, 0, 1)  # 'embm', 'precomp', 1 member
    if kind in SDE:
        level, cs, rows = EM_FORCED[placement]
        _sde_force(kind, level, cs, rows)
    else:
        mod._LIB.force_placement(placement)
    try:
        got = [mod._LIB.placement(shape, b) for b in (False, True)]
        print(f"{kind} H={H} n_inner={n_inner} forced {placement}: "
              f"placements (forward, backward) {got}, rows "
              f"{[mod._LIB.rows(shape, b) for b in (False, True)]}")
        if kind in SDE:
            for b in (False, True):
                p = getattr(mod, f"{pre}_plan")(13, H, H, n_inner, b)
                print(f"  {kind} plan {'backward' if b else 'forward'}: {p}")
                assert p["level"] >= level and p["active_clusters"] >= 1
                assert cs in (0, p["cluster"]) and rows in (0, p["rows"])
                if H == 256 and placement == 0:  # the own plan: a cluster
                    assert p["cluster"] > 1, p
        else:
            assert min(got) >= placement
        _check(_fns(mod, pre), inputs, flags, gys, "init",
               ys_f64_factor=YS_F64_FACTOR if kind == "cde" else 0.0)
    finally:
        if kind in SDE:
            _sde_force(kind, 0, 0, 0)
        else:
            mod._LIB.force_placement(0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk", "cde"])
@pytest.mark.parametrize("H,n_inner", WIDE)
def test_sde_and_cde_kernels_take_wide_fields(kind, H, n_inner):
    """At H = HH = 128 and 256 the pairs run in the placement their plan
    takes (weights and accumulators past a block's shared memory) and
    match their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _wide_check(kind, H, n_inner, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk", "cde"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_each_placement_matches_plain_versions(kind, placement):
    """Every placement, forced once, gives the plain versions' results."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _wide_check(kind, 128, 1, placement)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [49, 128])
def test_wide_backward_is_bit_reproducible(H):
    """The EM backward at the sepsis width and at 128 (a cluster): the
    cluster's partials summed in rank order, d theta's per-CTA partials
    and the weight gradient's split partials summed in a fixed order, no
    atomics: two backward calls agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _inputs(False, 4, 17, 2, "init", B=40, M=5, H=H)
    ys, _ = fe.fused_em_forward(**inputs, **flags)
    a = fe.fused_em_backward(ys=ys, gys=gys, **inputs, **flags)
    b = fe.fused_em_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 128])
def test_srk_backward_is_bit_reproducible(H):
    """The SRK backward at the MuJoCo width and at 128 (a cluster): the
    same fixed orders as the EM's, no atomics: two backward calls agree
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _inputs(True, 4, 17, 1, "init", B=40, M=5, H=H)
    ys, _ = fs.fused_srk_forward(**inputs, **flags)
    a = fs.fused_srk_backward(ys=ys, gys=gys, **inputs, **flags)
    b = fs.fused_srk_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _wgrad_check(kind, H, n_inner):
    """An SDE weight-gradient kernel alone on the plain recurrence's
    streams: every output within TOL_GRAD of its largest entry and within
    the float64 rms rule."""
    mod, pre = SDE[kind]
    inputs, flags, gys = _inputs(kind == "srk", 4, 17, n_inner, "init",
                                 B=37, M=6, H=H)
    ys, _ = getattr(mod, f"{pre}_forward_reference")(**inputs, **flags)
    st = getattr(mod, f"{pre}_backward_recurrence_reference")(
        ys=ys, gys=gys, **inputs, **flags)
    streams = ((st.h01,) if kind == "srk" else ()) + (st.dxh, st.hs, st.es,
                                                      st.dz3, st.q)
    plain = getattr(mod, f"{pre}_weight_grads_reference")
    k = getattr(mod, f"{pre}_weight_grads")(inputs["y0"], ys, st)
    p = plain(inputs["y0"], ys, *streams)
    r = plain(inputs["y0"].double(), ys.double(),
              *(t.double() for t in streams))
    torch.cuda.synchronize()
    for name, a, b, ref in zip(p._fields, k, p, r):
        if b is None or not b.numel():
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        (_, k_rms), (_, p_rms) = _errs(a, ref), _errs(b, ref)
        print(f"{name}: rel {rel:.2e}, rms from float64 kernel {k_rms:.2e} "
              f"plain {p_rms:.2e}")
        assert rel < TOL_GRAD, name
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, name


# every drift mode with every new noise mode: (io, no, inner layers)
MODE_CASES = [(0, 7, 1), (1, 8, 0), (3, 9, 2), (5, 10, 1), (0, 14, 0),
              (3, 15, 1), (1, 18, 2), (5, 19, 1), (6, 7, 0), (4, 14, 1),
              (2, 19, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk"])
@pytest.mark.parametrize("H", [49, 16])
@pytest.mark.parametrize("io,no,n_inner", MODE_CASES)
def test_sde_mode_kernels_match_plain_versions(kind, io, no, n_inner, H):
    """The new drift and noise modes' kernels (and the nets' forward
    streams) against their plain versions, init-scale rules with the
    float64 rule for the trajectory and the cotangents."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mod, pre = SDE[kind]
    inputs, flags, gys = _mode_inputs(kind == "srk", io, no, n_inner, H=H)
    _check(_fns(mod, pre), inputs, flags, gys, "init",
           ys_f64_factor=YS_F64_FACTOR, grad_f64_factor=YS_F64_FACTOR)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk"])
@pytest.mark.parametrize("H", [128, 256])
def test_net2_kernels_take_wide_fields(kind, H):
    """net2 (2,19) at H = HH = 128 and 256: its plan (a CTA a cluster,
    the weights in device memory where they do not fit) runs and matches
    the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mod, pre = SDE[kind]
    for b in (False, True):
        p = getattr(mod, f"{pre}_plan")(13, H, H, 1, b, "embm", "net2")
        print(f"{kind} net2 H={H} {'backward' if b else 'forward'}: {p}")
        assert p["cluster"] == 1 and p["active_clusters"] >= 1, p
    inputs, flags, gys = _mode_inputs(kind == "srk", 2, 19, 1, B=13, M=5,
                                      H=H)
    _check(_fns(mod, pre), inputs, flags, gys, "init",
           ys_f64_factor=YS_F64_FACTOR, grad_f64_factor=YS_F64_FACTOR)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk"])
@pytest.mark.parametrize("io,no", [(1, 18), (3, 15), (0, 14)])
def test_net_weight_grad_kernels_match_their_plain_versions(kind, io, no):
    """The weight-gradient kernel in the nets' modes (dWn1, dWn2, dbn2 and
    the an1 rows' cotangents beside the drift's) on the plain recurrence's
    streams: _wgrad_check's rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mod, pre = SDE[kind]
    inputs, flags, gys = _mode_inputs(kind == "srk", io, no, 1, B=37, M=6,
                                      H=49)
    ys, ns = getattr(mod, f"{pre}_forward_reference")(**inputs, **flags)
    st = getattr(mod, f"{pre}_backward_recurrence_reference")(
        ys=ys, gys=gys, **inputs, **flags, ns=ns)
    md = dict(drift=flags["drift"], noise=flags["noise"])
    y0 = inputs["y0"]
    if kind == "em":
        k = fe.fused_em_weight_grads(y0, ys, st, ns.nh, **md)
        plain = lambda c: fe.fused_em_weight_grads_reference(
            c(y0), c(ys), *(c(t) for t in (st.dxh, st.hs, st.es, st.dz3)),
            None, c(st.dn), c(st.dz2), c(ns.nh), **md)
    else:
        k = fs.fused_srk_weight_grads(y0, ys, st, ns, **md)
        plain = lambda c: fs.fused_srk_weight_grads_reference(
            c(y0), c(ys), *(c(t) for t in (st.h01, st.dxh, st.hs, st.es,
                                           st.dz3)),
            None, c(ns.nst), c(st.dn), c(st.dz2), c(ns.nh), **md)
    p = plain(lambda t: t)
    r = plain(lambda t: None if t is None else t.double())
    torch.cuda.synchronize()
    for name, a, b, ref in zip(p._fields, k, p, r):
        if b is None:
            assert a is None, name
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        (_, k_rms), (_, p_rms) = _errs(a, ref), _errs(b, ref)
        print(f"{name}: rel {rel:.2e}, rms from float64 kernel {k_rms:.2e} "
              f"plain {p_rms:.2e}")
        assert rel < TOL_GRAD, name
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, name


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_inner", [(49, 1), (16, 0), (128, 2)])
def test_em_weight_grad_kernel_matches_its_plain_version(H, n_inner):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _wgrad_check("em", H, n_inner)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_inner", [(32, 1), (16, 0), (128, 2)])
def test_srk_weight_grad_kernel_matches_its_plain_version(H, n_inner):
    """The SRK weight-gradient kernel over both evaluations (K = 2 M B):
    _wgrad_check's rules."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _wgrad_check("srk", H, n_inner)


def _plan_raises(kind):
    """A cluster size or row count the kernels do not take raises
    ValueError; so does a forced plan whose CTA fits at no level (one CTA
    of 32 rows at H = HH = 1024: its tiles alone exceed 227 KB), before
    any launch."""
    mod, pre = SDE[kind]
    force = getattr(mod, f"force_{kind}_plan")
    with pytest.raises(ValueError):
        force(3, 0)
    with pytest.raises(ValueError):
        force(0, 64)
    force(1, 32)
    try:
        inputs, flags, gys = _inputs(kind == "srk", 4, 17, 1, "init", B=40,
                                     M=2, H=1024)
        with pytest.raises(ValueError, match="limit per block"):
            getattr(mod, f"{pre}_forward")(**inputs, **flags)
    finally:
        force(0, 0)


@pytest.mark.cuda
def test_em_plan_raises_when_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _plan_raises("em")


@pytest.mark.cuda
def test_srk_plan_raises_when_it_cannot_run():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _plan_raises("srk")


# GRU widths at each kind of its plan (at B = 13 and 100): one CTA (16, 96),
# clusters of 2 (128), 4 (200) and 8 CTAs (256; 250 leaves the last CTA 26
# units of 32) with the W_hh slices in shared memory, and the slices in
# device memory (512); 120 has a forward of one CTA and a backward of two
GRU_PLAN_H = [16, 96, 120, 128, 200, 250, 256, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [13, 100])
@pytest.mark.parametrize("dec", [False, True])
@pytest.mark.parametrize("H", GRU_PLAN_H)
def test_gru_cluster_plans_match_plain_versions(H, dec, B):
    """The GRU pair against its plain versions at every kind of plan, with
    and without the decay stream (the tolerances of _check_rnn)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    plan = fr.fused_gru_plan(H, B, backward=True)
    print(f"H={H} B={B} backward plan {plan}")
    assert plan["active_clusters"] >= 1
    inputs, ghs = _rnn_inputs("gru", H, B=B, L=9 if H < 512 else 5, dec=dec)
    _check_rnn("gru", inputs, ghs)


@pytest.mark.cuda
def test_gru_plan_splits_w_hh_as_it_must():
    """W_hh (3 H^2 floats) in one CTA up to H = 112; split over 2 CTAs at
    H = 128, 4 at 200 and 8 at 256, at the bench batch; read from device
    memory at H = 512."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    for backward in (False, True):
        got = {H: fr.fused_gru_plan(H, 1024, backward)
               for H in (32, 64, 112, 128, 200, 256, 512)}
        assert [got[H]["cluster"] for H in got] == [1, 1, 1, 2, 4, 8, 8]
        assert [got[H]["w_smem"] for H in got] == [1, 1, 1, 1, 1, 1, 0]
        assert got[128]["rows"] == 16
        assert all(p["active_clusters"] >= 1 for p in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dec", [False, True])
@pytest.mark.parametrize("H", [128, 250])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_at_cluster_widths_matches_the_eager_loop(H, reverse, dec):
    """fused_gru_scan through the cluster kernels, from a nonzero h0 and
    with or without the decay stream, against the eager loop over the
    cell, both directions: hs and every gradient (xs, h0, the decay and
    the cell's parameters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(6)
    L, B, C = 10, 37, 6
    cell = GRUCell(C, H, generator=torch.Generator().manual_seed(0)).cuda()
    t = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    xs, w = t(rng.normal(size=(L, B, C))), t(rng.normal(size=(L, B, H)) / B)
    h0 = t(0.5 * rng.normal(size=(B, H)))
    hdec = t(rng.uniform(0.2, 1.0, size=(L, B, H))) if dec else None
    flip = lambda a: torch.flip(a, (0,)) if reverse else a
    outs = []
    for fused in (True, False):
        cell.zero_grad()
        x, h = xs.clone().requires_grad_(True), h0.clone().requires_grad_(True)
        d = hdec.clone().requires_grad_(True) if dec else None
        if fused:
            hs = fr.fused_gru_scan(cell, x, h0=h, reverse=reverse, hdec=d)
        else:
            hs = flip(_eager_gru(cell, flip(x), h, flip(d) if dec else None))
        (hs * w).sum().backward()
        outs.append([hs.detach(), x.grad, h.grad] + ([d.grad] if dec else [])
                    + [p.grad for p in cell.parameters()])
    for a, b in zip(*outs):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert rel < TOL_GRAD, rel


@pytest.mark.cuda
@pytest.mark.parametrize("H", [16, 128, 250, 512])
def test_gru_backward_is_bit_reproducible(H):
    """Two backward calls on the same inputs (with the decay stream) give
    bitwise-equal outputs: no atomics, the cluster's partials and the
    weight gradient's split partials summed in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, ghs = _rnn_inputs("gru", H, B=100, dec=True)
    hs = fr.fused_gru_forward(**inputs)
    a = fr.fused_gru_backward(hs=hs, ghs=ghs, **inputs)
    b = fr.fused_gru_backward(hs=hs, ghs=ghs, **inputs)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.cuda
def test_gru_weight_grad_kernel_matches_its_plain_version():
    """The weight-gradient kernel alone on the GRU's streams (h0, hs, the
    decay, dgh), at widths that are not a multiple of 4 (4-byte copies; 3H
    = 15 leaves dgh's rows unaligned) and ones that are, with and without
    the decay: within TOL_GRAD of the largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(8)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device="cuda")
    for L, B, H in ((13, 37, 5), (60, 64, 16), (72, 1024, 128), (3, 8, 250)):
        for dec in (False, True):
            h0, hs, dgh = t(B, H), t(L, B, H), t(L, B, 3 * H)
            hdec = t(L, B, H).abs() if dec else None
            before = fr.GRU_WGRAD_LAUNCHES
            k = fr.fused_gru_weight_grads(h0, hs, dgh, hdec)
            p = fr.fused_gru_weight_grads_reference(h0, hs, dgh, hdec)
            assert fr.GRU_WGRAD_LAUNCHES == before + 1
            for a, b in zip(k, p):
                rel = float((a - b).abs().max()) / float(b.abs().max())
                assert rel < TOL_GRAD, (L, B, H, dec, rel)


# (CTAs a cluster, batch rows a cluster, B, C) of the CDE pair at H = HH =
# 20, both forced: every cluster size the plan can pick, on batches that
# leave the last cluster ragged
CDE_CLUSTERS = [(1, 8, 13, 6), (2, 8, 13, 6), (4, 8, 13, 6), (8, 8, 13, 6),
                (1, 8, 37, 35), (2, 4, 37, 35), (4, 16, 37, 35),
                (8, 2, 37, 35), (1, 32, 37, 6)]


def _cde_forced(cs, rows, method, act, n_inner, C, B, H=20, M=5):
    """The CDE pair against its plain versions (init-scale rules) with the
    plan's cluster size and rows forced."""
    fc.force_cde_plan(cs, rows)
    try:
        for backward in (False, True):
            p = fc.fused_cde_plan(B, H, H, C, n_inner, method, backward)
            print(f"cs={cs} rows={rows} B={B} C={C} {method} {act} "
                  f"n_inner={n_inner} backward={backward}: {p}")
            assert (p["cluster"], p["rows"]) == (cs, rows)
            assert p["active_clusters"] >= 1
        inputs, flags, gys = _cde_inputs(method, act, n_inner, C, "init",
                                         B=B, M=M, H=H)
        _check(_fns(fc, "fused_cde"), inputs, flags, gys, "init",
               ys_f64_factor=YS_F64_FACTOR)
    finally:
        fc.force_cde_plan(0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cs,rows,B,C", CDE_CLUSTERS)
def test_cde_cluster_plans_match_plain_versions(cs, rows, B, C):
    """Each cluster size, forced, on a ragged batch at C = 6 and 35."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _cde_forced(cs, rows, "rk4", "relu", 1, C, B)


@pytest.mark.cuda
@pytest.mark.parametrize("n_inner", [0, 1, 2])
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_cde_every_tableau_activation_and_depth(method, act, n_inner):
    """Every tableau and activation with zero, one and two inner layers, in
    a cluster of two CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _cde_forced(2, 8, method, act, n_inner, 6, 13)


@pytest.mark.cuda
@pytest.mark.parametrize("C,cs,keep", [(6, 1, 1), (35, 2, 0)])
def test_cde_backward_keeps_or_recomputes_the_stages(C, cs, keep):
    """At 8 rows a cluster and H = 32 the backward keeps the stage
    activations at C = 6 in one CTA and recomputes them at C = 35 in a
    cluster of two (they do not fit beside the Wout and dWout slices);
    both match the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    fc.force_cde_plan(cs, 8)
    try:
        p = fc.fused_cde_plan(13, 32, 32, C, 1, "rk4", True)
        print(f"C={C}: {p}")
        assert p["keep"] == keep and p["active_clusters"] >= 1
        inputs, flags, gys = _cde_inputs("rk4", "relu", 1, C, "init", B=13,
                                         M=4, H=32)
        _check(_fns(fc, "fused_cde"), inputs, flags, gys, "init",
               ys_f64_factor=YS_F64_FACTOR)
    finally:
        fc.force_cde_plan(0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [1, 2, 8])
def test_cde_backward_is_bit_reproducible(cs):
    """Two backward calls agree bit for bit: the cluster's partials of dh
    and of the control cotangent summed in rank order, one owner an
    accumulator entry, the per-cluster partials summed in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    fc.force_cde_plan(cs, 8)
    try:
        inputs, flags, gys = _cde_inputs("rk4", "relu", 1, 35, "init", B=37,
                                         M=5, H=20)
        ys = fc.fused_cde_forward(**inputs, **flags)
        a = fc.fused_cde_backward(ys=ys, gys=gys, **inputs, **flags)
        b = fc.fused_cde_backward(ys=ys, gys=gys, **inputs, **flags)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    finally:
        fc.force_cde_plan(0, 0)


@pytest.mark.cuda
def test_cde_plan_splits_wout_as_it_must():
    """The host rule on an H100 (227 KB a CTA, 132 SMs): one CTA of 8 rows
    a cluster at the uea_rk4 width, whose backward keeps the stages; at
    the sepsis_rk4 width (Wout 143 KB) the forward in one CTA, the
    backward split over 2 (Wout and dWout slices in shared memory, the
    stages recomputed); at H = HH = 128 one CTA of 8 rows reading Wout
    from device memory (one wave, against 4-16 waves of clusters that each
    read or hold the hidden layers in full), the forward's hidden weights
    in shared memory, the backward's too in device memory; the sweep's 64
    rows one a cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    want = {(1024, 32, 6, 1): ((0, 1, 8, 0), (0, 1, 8, 1)),
            (1024, 32, 35, 1): ((0, 1, 8, 0), (0, 2, 8, 0)),
            (1024, 128, 6, 1): ((4, 1, 8, 0), (5, 1, 8, 1)),
            (64, 16, 6, 0): ((0, 1, 1, 0), (0, 1, 1, 1))}
    for (B, H, C, n_inner), plans in want.items():
        for backward, w in zip((False, True), plans):
            p = fc.fused_cde_plan(B, H, H, C, n_inner, "rk4", backward)
            assert (p["level"], p["cluster"], p["rows"], p["keep"]) == w, p
            assert p["active_clusters"] >= 1


@pytest.mark.cuda
def test_cde_plan_raises_when_it_cannot_run():
    """A cluster size or row count the kernels do not take raises
    ValueError; so does a forced plan whose CTA fits no level (32 rows a
    cluster of one at the sepsis_rk4 width: its O and dz tiles alone
    exceed 227 KB), before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    with pytest.raises(ValueError):
        fc.force_cde_plan(3, 0)
    with pytest.raises(ValueError):
        fc.force_cde_plan(0, 64)
    fc.force_cde_plan(1, 32)
    try:
        inputs, flags, gys = _cde_inputs("rk4", "relu", 1, 35, "init", B=40,
                                         M=2, H=32)
        ys = fc.fused_cde_forward_reference(**inputs, **flags)
        with pytest.raises(ValueError, match="limit per block"):
            fc.fused_cde_backward(ys=ys, gys=gys, **inputs, **flags)
    finally:
        fc.force_cde_plan(0, 0)


# The GRU-ODE field (act "gruode") on the CDE kernels: (CTAs a cluster,
# batch rows a cluster, B, C, H), both forced; every cluster size on a
# ragged batch, and the sweep's width
GRU_CDE_CLUSTERS = [(1, 8, 13, 6, 16), (2, 8, 13, 6, 20), (4, 4, 13, 6, 20),
                    (8, 2, 37, 6, 20), (1, 32, 37, 6, 16), (2, 16, 37, 35, 20)]


def _gru_forced(cs, rows, method, C, B, H, level=0, M=5):
    """The GRU-ODE instances against their plain versions (init-scale
    rules) with the plan's cluster size and rows, and its lowest level,
    forced."""
    fc.force_cde_plan(cs, rows)
    fc._LIB.force_placement(level)
    try:
        for backward in (False, True):
            p = fc.fused_cde_plan(B, H, H, C, 0, method, backward, "gruode")
            print(f"gruode cs={cs} rows={rows} level>={level} B={B} C={C} "
                  f"H={H} {method} backward={backward}: {p}")
            assert p["level"] >= level and p["active_clusters"] >= 1
            assert cs in (0, p["cluster"]) and rows in (0, p["rows"])
        inputs, flags, gys = _cde_inputs(method, "gruode", 0, C, "init",
                                         B=B, M=M, H=H)
        _check(_fns(fc, "fused_cde"), inputs, flags, gys, "init",
               ys_f64_factor=YS_F64_FACTOR, grad_f64_factor=YS_F64_FACTOR)
    finally:
        fc.force_cde_plan(0, 0)
        fc._LIB.force_placement(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cs,rows,B,C,H", GRU_CDE_CLUSTERS)
def test_cde_gruode_cluster_plans_match_plain_versions(cs, rows, B, C, H):
    """Each cluster size, forced, with the GRU-ODE field (its cotangents by
    the float64 rule: its z feedback through three gates amplifies float32
    rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _gru_forced(cs, rows, "rk4", C, B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6])
def test_cde_gruode_every_level_matches_plain_versions(level):
    """Every plan level forced (from 3 on the gates' gradients, from 4 the
    gates themselves in device memory), in a cluster of two CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _gru_forced(2, 0, "rk4", 6, 13, 20, level=level)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_cde_gruode_every_tableau(method):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _gru_forced(1, 8, method, 6, 13, 16)
    _gru_forced(0, 0, method, 6, 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 256])
def test_cde_gruode_wide_fields_match_plain_versions(H):
    """H = 128 and 256 at C = 6: the gates past a CTA's shared memory (the
    plan's own choice, printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _gru_forced(0, 0, "rk4", 6, 24, H, M=3)


# (field kind, inner layers, H, K) of the CDE pair's member axis
CDE_MEMBER_CASES = [("relu", 0, 16, 3), ("relu", 1, 32, 2),
                    ("tanh", 0, 16, 2), ("gruode", 0, 16, 3),
                    ("gruode", 0, 20, 1)]


def _cde_members(act, n_inner, H, K, B=21, M=6, C=6):
    """K members' init-scale inputs of the CDE pair (member k's from seed
    k), stacked but dts, their gys, and each member's own inputs."""
    members = [_cde_inputs("rk4", act, n_inner, C, "init", B=B, M=M, H=H,
                           seed=k) for k in range(K)]
    inputs = {n: t if t is None or n == "dts" else
              torch.stack([m[0][n] for m in members])
              for n, t in members[0][0].items()}
    return (inputs, members[0][1], torch.stack([m[2] for m in members]),
            [(m[0], m[2]) for m in members])


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(1, 8), (2, 4)])
@pytest.mark.parametrize("act,n_inner,H,K", CDE_MEMBER_CASES)
def test_cde_member_axis_is_bitwise_the_solo_launch(act, n_inner, H, K,
                                                    plan):
    """Under one forced plan, member k of a packed CDE launch is bit for
    bit the launch of member k alone: the trajectory and every
    cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys, members = _cde_members(act, n_inner, H, K)

    def run(inp, g):
        ys = fc.fused_cde_forward(**inp, **flags)
        return ys, fc.fused_cde_backward(ys=ys, gys=g, **inp, **flags)

    fc.force_cde_plan(*plan)
    try:
        ys, g = run(inputs, gys)
        solo = [run(m, gk) for m, gk in members]
    finally:
        fc.force_cde_plan(0, 0)
    torch.cuda.synchronize()
    for k, (ys_k, g_k) in enumerate(solo):
        assert torch.equal(ys[k], ys_k), f"member {k}: ys"
        for name, a, b in zip(g._fields, g, g_k):
            assert (a is None) == (b is None), name
            if b is not None:
                assert torch.equal(a[k], b), f"member {k}: {name}"
    # and each member against the plain versions under the plan's choice
    ys = fc.fused_cde_forward(**inputs, **flags)
    for k, (m, gk) in enumerate(members):
        ys_p = fc.fused_cde_forward_reference(**m, **flags)
        rel = float((ys[k] - ys_p).abs().max() / ys_p.abs().max())
        assert rel < 1e-4, (k, rel)


# ---------------------------------------------------------------------------
# The member axis: K same-configuration solves in one launch
# ---------------------------------------------------------------------------

# (pair, io, no, inner layers, H, K): the main paths' modes, a net mode,
# a yy drift, and a packed launch of one member
MEMBER_CASES = [("em", 4, 17, 1, 49, 3), ("em", 1, 18, 1, 16, 2),
                ("em", 4, 17, 1, 49, 1), ("srk", 4, 17, 0, 16, 3),
                ("srk", 3, 15, 1, 16, 2), ("srk", 4, 17, 1, 32, 1)]
# forced plans (CTAs a cluster, rows a cluster; 0 the plan's own choice)
MEMBER_PLANS = [(1, 8), (2, 4), (1, 1)]


def _member_inputs(kind, io, no, n_inner, H, K, B=21, M=7):
    """K members' init-scale inputs (each member's from its own seed),
    stacked on a leading axis but dts, their flags and cotangents, and
    each member's own inputs."""
    members = [_mode_inputs(kind == "srk", io, no, n_inner, B=B, M=M, H=H,
                            seed=7 * s + 1) for s in range(K)]
    flags = members[0][1]
    inputs = {}
    for name, t in members[0][0].items():
        if t is None or name == "dts":
            inputs[name] = t
        else:
            inputs[name] = torch.stack([m[0][name] for m in members])
    gys = torch.stack([m[2] for m in members])
    return inputs, flags, gys, [m[0] for m in members]


def _member_run(kind, inputs, flags, gys):
    """(ys, the backward's cotangents) of one launch."""
    mod, pre = SDE[kind]
    ys, ns = getattr(mod, f"{pre}_forward")(**inputs, **flags)
    g = getattr(mod, f"{pre}_backward")(ys=ys, gys=gys.contiguous(),
                                        **inputs, **flags, ns=ns)
    torch.cuda.synchronize()
    return ys, ns, g


@pytest.mark.cuda
@pytest.mark.parametrize("plan", MEMBER_PLANS)
@pytest.mark.parametrize("kind,io,no,n_inner,H,K", MEMBER_CASES)
def test_member_axis_is_bitwise_the_solo_launch(kind, io, no, n_inner, H, K,
                                                plan):
    """Under one forced plan, member k of a packed launch is bit for bit
    the launch of member k alone: the trajectory, the nets' streams and
    every cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    cs, rows = plan
    if no in (14, 15, 18, 19) and cs > 1:
        pytest.skip("the noise nets' instances run clusters of one CTA")
    inputs, flags, gys, members = _member_inputs(kind, io, no, n_inner, H, K)
    _sde_force(kind, 0, cs, rows)
    try:
        ys, ns, g = _member_run(kind, inputs, flags, gys)
        solo = [_member_run(kind, m, flags, gys[k])
                for k, m in enumerate(members)]
    finally:
        _sde_force(kind, 0, 0, 0)
    for k, (ys_k, ns_k, g_k) in enumerate(solo):
        assert torch.equal(ys[k], ys_k), f"member {k}: ys"
        if ns is not None:
            axis = 0 if kind == "em" else 1
            for name, a, b in zip(ns._fields, ns, ns_k):
                if b is not None:
                    assert torch.equal(a.select(axis, k), b), (k, name)
        for name, a, b in zip(g._fields, g, g_k):
            if b is not None:
                assert torch.equal(a[k], b), f"member {k}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind,io,no,n_inner,H,K", MEMBER_CASES)
def test_member_axis_matches_plain_versions(kind, io, no, n_inner, H, K):
    """Under the plan's own choice (waves over K x clusters) each member
    of a packed launch against the plain versions on its inputs:
    init-scale rules, the float64 rule in the noise nets' and sqrt's
    modes, as for the solo launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mod, pre = SDE[kind]
    inputs, flags, gys, members = _member_inputs(kind, io, no, n_inner, H, K)
    ys, ns, g = _member_run(kind, inputs, flags, gys)
    f64 = YS_F64_FACTOR if flags["noise"] != "precomp" else 0.0
    for k, m in enumerate(members):
        sel = lambda t: None if t is None else t[k]
        axis = 0 if kind == "em" else 1
        ns_k = None if ns is None else type(ns)(*(
            None if t is None else t.select(axis, k) for t in ns))
        fns = (lambda **kw: (ys[k], ns_k),
               getattr(mod, f"{pre}_forward_reference"),
               lambda **kw: type(g)(*(sel(t) for t in g)),
               getattr(mod, f"{pre}_backward_reference"))
        _check(fns, m, flags, gys[k], "init", ys_f64_factor=f64,
               grad_f64_factor=f64)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["em", "srk"])
def test_member_plans_weigh_waves_over_the_members(kind):
    """The plan of K members counts K x clusters: at the sweep's shape
    (B = 64, H = 16) five members fill more of the card than one, and
    every plan can be scheduled."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mod, pre = SDE[kind]
    for K in (1, 5, 64):
        for b in (False, True):
            p = getattr(mod, f"{pre}_plan")(64, 16, 16, 0, b, members=K)
            print(f"{kind} K={K} {'backward' if b else 'forward'}: {p}")
            assert p["active_clusters"] >= 1


@pytest.mark.cuda
def test_whole_sepsis_model_through_the_em_kernels_matches_jax(monkeypatch):
    """The full sepsis model (C = 69, H = 49, two hidden layers, LNSDE
    (4,17)) on the card, its solve through the EM kernels with the golden's
    increments: the loss and every gradient against the JAX package's
    (tests/goldens/sepsis_whole_model.npz, written by
    tests/test_torch_whole_model.py; loss 1e-5 relative, gradients 1e-4 of
    their largest entry, tests/sepsis_whole_model.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    import sepsis_whole_model as wm

    d = wm.data()
    dW = torch.as_tensor(d["dW"], device="cuda")
    monkeypatch.setattr(fe, "brownian_increments", lambda *a, **k: dW)
    launches = (fe.FWD_LAUNCHES, fe.BWD_LAUNCHES, fe.WGRAD_LAUNCHES)
    model = wm.port_model("cuda")
    loss, grads = wm.port_loss_and_grads(
        model, d, torch.Generator(device="cuda"))
    assert (fe.FWD_LAUNCHES, fe.BWD_LAUNCHES, fe.WGRAD_LAUNCHES) == tuple(
        n + 1 for n in launches)
    errs = wm.check(loss, grads, np.load(wm.GOLDEN))
    print("largest gradient error over its scale:", max(errs.values()))


# the latent instances (LatentSDE's augmented system): (H = HH, inner
# layers) at the sweep's width, the sepsis width and H = HH = 128, each
# under its own plan and forced ones (lowest level, CTAs a cluster, rows a
# cluster; 0 the plan's own choice)
LATENT_CASES = [(16, 0), (49, 1), (128, 1)]
LATENT_FORCED = [(0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 4, 4), (1, 0, 0),
                 (1, 8, 1)]


def _latent_inputs(H, n_inner, B=13, L=7, seed=0):
    """The latent mode's inputs of a random LatentSDE (5 channels, H = HH)
    over the times linspace(0, 1, L) on the card, its flags, and gys (on
    every lane, the KL lane's too)."""
    from snsde_torch.models.latent_sde import LatentSDE
    from snsde_torch.models.neuralsde import resolve_dt
    from snsde_torch.ops import make_grid

    rng = np.random.default_rng(seed)
    model = LatentSDE(5, H, H, n_inner + 1, method="euler",
                      generator=torch.Generator().manual_seed(seed)).cuda()
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    M = len(grid) - 1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    dW = t(rng.normal(size=(M, B, H)) * np.sqrt(np.diff(grid))[:, None, None])
    aug0 = t(np.concatenate([rng.normal(size=(B, H - 1)), np.zeros((B, 1))],
                            -1))
    with torch.no_grad():
        inp = fe.latent_inputs(model, grid, aug0, dW)
    flags = {k: inp.pop(k) for k in fe._MODE_KEYS + ("latent",)}
    inputs = {k: None if v is None else v.detach().contiguous()
              for k, v in inp.items()}
    return inputs, flags, t(rng.normal(size=(M, B, H)) / B)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_inner", LATENT_CASES)
def test_latent_kernels_match_plain_versions_under_every_plan(H, n_inner):
    """The latent forward and backward against their plain versions under
    each forced plan (the trajectory with its KL lane and every cotangent
    by the float64 rule), and the forward's bits the same under every plan:
    the KL rate is one thread's sum over the exchanged row in ascending q."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _latent_inputs(H, n_inner)
    first = None
    for level, cs, rows in LATENT_FORCED:
        _sde_force("em", level, cs, rows)
        try:
            for b in (False, True):
                p = fe.fused_em_plan(13, H, H, n_inner, b, "yy", "precomp",
                                     latent=True)
                print(f"latent H={H} forced {(level, cs, rows)} "
                      f"{'backward' if b else 'forward'}: {p}")
                assert p["active_clusters"] >= 1 and p["level"] >= level
            _check(_fns(fe, "fused_em"), inputs, flags, gys, "init",
                   ys_f64_factor=YS_F64_FACTOR,
                   grad_f64_factor=YS_F64_FACTOR)
            ys, _ = fe.fused_em_forward(**inputs, **flags)
        finally:
            _sde_force("em", 0, 0, 0)
        if first is None:
            first = ys
        assert torch.equal(ys, first), (level, cs, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_inner", LATENT_CASES)
def test_latent_weight_grads_kernel_matches_its_plain_version(H, n_inner):
    """The weight-gradient kernel on the latent recurrence's streams (the
    kernel's own recurrence, as the backward runs it) against its plain
    version on the same streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, flags, gys = _latent_inputs(H, n_inner, B=40)
    ys, _ = fe.fused_em_forward(**inputs, **flags)
    st = fe.fused_em_backward_recurrence(ys=ys, gys=gys, **inputs, **flags)
    k = fe.fused_em_weight_grads(inputs["y0"], ys, st, drift="yy")
    p = fe.fused_em_weight_grads_reference(inputs["y0"], ys, st.dxh, st.hs,
                                           st.es, st.dz3, st.q, drift="yy")
    for name, a, b in zip(p._fields, k, p):
        if b is None or not b.numel():
            continue
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        print(f"latent H={H} weight gradient {name}: rel err {rel:.2e}")
        assert rel < TOL_GRAD, name


# ---------------------------------------------------------------------------
# The ODE-RNN hybrids' instances: the GRU pair's obs (mode 1), obs + decay
# row (2) and obs + evolve (3), the LSTM pair's evolve (1); and the
# time-aware LSTMs': the LSTM pair's sel (2), tg (3) and TLSTM (4)
# ---------------------------------------------------------------------------

# (kind, mode, evolve layers, substeps, hh)
RNN_MODE_CASES = [("gru", 1, 0, 0, 0), ("gru", 2, 0, 0, 0),
                  ("gru", 3, 2, 1, 16), ("gru", 3, 3, 2, 7),
                  ("gru", 3, 1, 2, 0), ("lstm", 1, 2, 1, 20),
                  ("lstm", 1, 3, 2, 7), ("lstm", 2, 0, 0, 0),
                  ("lstm", 3, 0, 0, 0), ("lstm", 4, 0, 0, 0)]
# each mode's launch counters
RNN_MODE_COUNTERS = {("gru", 1): "GRU_OBS", ("gru", 2): "GRU_DEC1",
                     ("gru", 3): "GRU_ODE", ("lstm", 1): "LSTM_ODE",
                     ("lstm", 2): "LSTM_SEL", ("lstm", 3): "LSTM_TG",
                     ("lstm", 4): "LSTM_TLSTM"}
# every kind of plan, forced: the host's own, one CTA, clusters of 2, 4
# and 8 CTAs (H = 20: the last CTAs of 8 hold 2 units and none)
RNN_FORCED = [(0, 0), (1, 8), (2, 8), (4, 16), (8, 8)]


def _rnn_mode_inputs(kind, mode, n, S, hh, H, B, L, obs=True, seed=0):
    """The pair's inputs (_rnn_inputs) and a mode's: obs [L, B] ~
    Bernoulli(0.6), the decay row [L, H] ~ U(0.2, 1), the evolve's MLP at
    the init's scale with step sizes ~ U(0, 0.4) / S ([L] for the GRU,
    [L, B] for the LSTM); the LSTM's sel [L, B, H] ~ U(0, 1), tg [L, B, 3H]
    sigmoids of N(0, 1), TLSTM's W_d and b_d at the init's scale with
    elapsed times ~ U(0, 2) [L, B]."""
    inputs, ghs = _rnn_inputs(kind, H, B=B, L=L, seed=seed)
    rng = np.random.default_rng(seed + 100)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    kw = {}
    if kind == "gru" and obs:
        kw["obs"] = t(rng.uniform(size=(L, B)) < 0.6)
    if kind == "gru" and mode == 2:
        kw["hrow"] = t(rng.uniform(0.2, 1.0, size=(L, H)))
    if n:
        hh = hh if n > 1 else H
        parts = []
        for i, j in fr._mlp_dims(H, hh, n):
            k = 1.0 / np.sqrt(i)
            parts += [t(rng.uniform(-k, k, size=i * j)),
                      t(rng.uniform(-k, k, size=j))]
        dts = rng.uniform(0.0, 0.4, size=(L,) if kind == "gru" else (L, B))
        kw["ode"] = fr.Evolve(torch.cat(parts), t(dts / S), n, hh, S)
    if kind == "lstm" and mode == 2:
        kw["sel"] = t(rng.uniform(size=(L, B, H)))
    if kind == "lstm" and mode == 3:
        kw["tg"] = t(1.0 / (1.0 + np.exp(-rng.normal(size=(L, B, 3 * H)))))
    if kind == "lstm" and mode == 4:
        k = 1.0 / np.sqrt(H)
        kw["dec"] = fr.Decomp(t(rng.uniform(-k, k, size=(H, H))),
                              t(rng.uniform(-k, k, size=(H,))),
                              t(rng.uniform(0.0, 2.0, size=(L, B))))
    return inputs, kw, ghs


def _mode_f64(kw):
    """A mode's inputs in float64."""
    out = {}
    for n, v in kw.items():
        if n == "ode":
            out[n] = v._replace(mlp=v.mlp.double(), dts=v.dts.double())
        elif n == "dec":
            out[n] = fr.Decomp(*(x.double() for x in v))
        else:
            out[n] = v.double()
    return out


def _rnn_mode_run(kind, inputs, kw, ghs, plain=False):
    sfx = "_reference" if plain else ""
    fwd = getattr(fr, f"fused_{kind}_forward{sfx}")
    bwd = getattr(fr, f"fused_{kind}_backward{sfx}")
    if kind == "gru":
        hs = fwd(**inputs, **kw)
        out = {"hs": hs}
        g = bwd(hs=hs, ghs=ghs, **inputs, **kw)
    else:
        hs, cs, hcell = fwd(**inputs, save_cs=True, **kw)
        out = {"hs": hs, "cs": cs}
        if hcell is not None:
            out["hcell"] = hcell
        g = bwd(hs=hs, cs=cs, ghs=ghs, hcell=hcell, **inputs, **kw)
    out.update({n: v for n, v in zip(g._fields, g) if v is not None})
    return out


def _check_rnn_mode(kind, inputs, kw, ghs):
    """_check_rnn's rules for a mode: every output (the decay row's and
    the evolve's cotangents included) against the float32 plain version
    and a float64 run of it."""
    k = _rnn_mode_run(kind, inputs, kw, ghs)
    p = _rnn_mode_run(kind, inputs, kw, ghs, plain=True)
    r64 = _rnn_mode_run(kind, {n: v.double() for n, v in inputs.items()},
                        _mode_f64(kw), ghs.double(), plain=True)
    torch.cuda.synchronize()
    assert set(k) == set(p)
    for name in k:
        (k_max, k_rms), (p_max, p_rms) = (_errs(k[name], r64[name]),
                                          _errs(p[name], r64[name]))
        print(f"{kind} {name}: error from float64 over max (largest, rms): "
              f"kernel {k_max:.2e} {k_rms:.2e}, float32 plain {p_max:.2e} "
              f"{p_rms:.2e}")
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, name
        rel = float((k[name] - p[name]).abs().max()) / max(
            float(p[name].abs().max()), 1e-30)
        tol = TOL_YS if name in ("hs", "cs", "hcell") else TOL_GRAD
        assert rel < tol, f"{kind} {name}: rel err {rel:.2e}"
    return k


@pytest.fixture
def forced_rnn_plan():
    """force_rnn_plan for the test, the host's own plan restored after (on
    a machine with the card: the library needs it)."""
    yield fr.force_rnn_plan
    if torch.cuda.is_available():
        fr.force_rnn_plan(0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", RNN_FORCED)
@pytest.mark.parametrize("H,B", [(16, 13), (20, 37)])
@pytest.mark.parametrize("kind,mode,n,S,hh", RNN_MODE_CASES)
def test_rnn_mode_kernels_match_plain_versions(kind, mode, n, S, hh, H, B,
                                               plan, forced_rnn_plan):
    """Each hybrid instance against its plain version under every kind of
    plan, forced, on ragged batches, with the launch counted in its own
    counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    forced_rnn_plan(*plan)
    inputs, kw, ghs = _rnn_mode_inputs(kind, mode, n, S, hh, H, B, L=9)
    name = RNN_MODE_COUNTERS[kind, mode]
    before = (getattr(fr, f"{name}_FWD_LAUNCHES"),
              getattr(fr, f"{name}_BWD_LAUNCHES"))
    _check_rnn_mode(kind, inputs, kw, ghs)
    assert (getattr(fr, f"{name}_FWD_LAUNCHES"),
            getattr(fr, f"{name}_BWD_LAUNCHES")) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode,n,S,hh", [("gru", 2, 0, 0, 0),
                                              ("gru", 3, 2, 1, 256),
                                              ("lstm", 1, 2, 1, 256),
                                              ("lstm", 2, 0, 0, 0),
                                              ("lstm", 3, 0, 0, 0),
                                              ("lstm", 4, 0, 0, 0)])
def test_rnn_mode_kernels_at_cluster_width(kind, mode, n, S, hh):
    """At H = 256, where the plan splits W_hh over a cluster of 8 and
    every CTA runs the evolve on its full copy of the state (TLSTM: keeps
    every unit of c and sums dc's partials over the cluster)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, kw, ghs = _rnn_mode_inputs(kind, mode, n, S, hh, 256, 40, L=6)
    plan = (fr.fused_gru_plan(256, 40, True, mode, kw.get("ode"))
            if kind == "gru" else fr.fused_lstm_plan(256, 40, True,
                                                     kw.get("ode"), mode))
    print(f"{kind} mode {mode} H=256 backward plan {plan}")
    assert plan["cluster"] == 8 and plan["active_clusters"] >= 1
    _check_rnn_mode(kind, inputs, kw, ghs)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [2, 3, 4])
def test_time_lstm_modes_with_slices_in_device_memory(mode):
    """The time-aware LSTM instances at H = 512, B = 16: the W_hh (and
    W_d) slices read from device memory by a cluster of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs, kw, ghs = _rnn_mode_inputs("lstm", mode, 0, 0, 0, 512, 16, L=5)
    for backward in (False, True):
        plan = fr.fused_lstm_plan(512, 16, backward, mode=mode)
        print(f"lstm mode {mode} H=512 plan {plan}")
        assert plan["cluster"] == 8 and plan["active_clusters"] >= 1
    _check_rnn_mode("lstm", inputs, kw, ghs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode,n,S,hh", [("gru", 2, 0, 0, 0),
                                              ("gru", 3, 2, 2, 16),
                                              ("lstm", 1, 2, 2, 16),
                                              ("lstm", 4, 0, 0, 0)])
@pytest.mark.parametrize("plan", [(0, 0), (4, 8)])
def test_rnn_mode_backward_is_bit_reproducible(kind, mode, n, S, hh, plan,
                                               forced_rnn_plan):
    """Two backward calls on the same inputs give bitwise-equal outputs:
    the decay row's partials and the evolve's split partials summed in a
    fixed order, no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    forced_rnn_plan(*plan)
    inputs, kw, ghs = _rnn_mode_inputs(kind, mode, n, S, hh, 20, 100, L=7)
    a = _rnn_mode_run(kind, inputs, kw, ghs)
    b = _rnn_mode_run(kind, inputs, kw, ghs)
    torch.cuda.synchronize()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gru-dt", "gru-d", "ode-rnn", "ode-lstm"])
def test_hybrid_layers_on_the_card_match_their_eager_loops(name):
    """Each hybrid's registry layer on the card through the kernels against
    its eager loop on the card: the stream and every gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from snsde_torch.data import synthetic_uea
    from snsde_torch.harness.robustness import coeff_family, preprocess_ists
    from snsde_torch.registry import make_seq_layer

    X, _, _ = synthetic_uea(n=24, length=15, channels=4, num_classes=2,
                            seed=1)
    data = preprocess_ists(X, 0.3, interpolation=coeff_family(name), seed=1)
    seq = torch.as_tensor(data["seq"], device="cuda")
    coeffs = torch.as_tensor(data["coeffs"], device="cuda")
    layer = make_seq_layer(name, 4, 15, 16, num_hidden_layers=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
    outs = []
    for fused in (True, False):
        layer.zero_grad()
        out, hn = layer(seq, coeffs, use_fused=fused)
        ((out ** 2).sum() + (hn ** 2).sum()).backward()
        outs.append([hn.detach()] + [p.grad.clone()
                                     for p in layer.parameters()])
    for a, b in zip(*outs):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert rel < TOL_GRAD, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tlstm", "plstm", "tglstm"])
def test_time_lstm_layers_on_the_card_match_their_eager_loops(name):
    """Each time-aware LSTM's two-layer registry layer on the card through
    the kernels' modes against its eager loop on the card: the stream and
    every gradient (the phase parameters and weight_t included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from snsde_torch.data import synthetic_uea
    from snsde_torch.harness.robustness import coeff_family, preprocess_ists
    from snsde_torch.registry import make_seq_layer

    X, _, _ = synthetic_uea(n=24, length=15, channels=4, num_classes=2,
                            seed=1)
    data = preprocess_ists(X, 0.3, interpolation=coeff_family(name), seed=1)
    seq = torch.as_tensor(data["seq"], device="cuda")
    coeffs = torch.as_tensor(data["coeffs"], device="cuda")
    layer = make_seq_layer(name, 4, 15, 16, num_layers=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
    counter = {"tlstm": "LSTM_TLSTM", "plstm": "LSTM_SEL",
               "tglstm": "LSTM_TG"}[name]
    before = getattr(fr, f"{counter}_FWD_LAUNCHES")
    outs = []
    for fused in (True, False):
        layer.zero_grad()
        out, hn = layer(seq, coeffs, use_fused=fused)
        ((out ** 2).sum() + (hn ** 2).sum()).backward()
        outs.append([hn.detach()] + [p.grad.clone()
                                     for p in layer.parameters()])
    assert getattr(fr, f"{counter}_FWD_LAUNCHES") == before + 2
    for a, b in zip(*outs):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert rel < TOL_GRAD, rel
