"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device.

The module imports torch, numpy and snsde_torch only, never JAX, so it
runs on a machine with the card and no JAX (tests/conftest.py imports
JAX, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

The shapes are the awkward ones the main paths do not reach: a batch
that leaves the last 8-row tile ragged, the sepsis width H=49, and zero,
one and two inner layers, each at two scales of the weights:
- "init": weights at the scale of the layers' init (1/sqrt(fan_in)), so
  the trajectory stays O(1) as in training. The kernels are held to
  chip_smoke.py's tolerances: trajectory atol 5e-5, every cotangent 1e-5
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
  CPU 2.2e-5), while the mean over every entry does not.
Both cases also pass that float64 check, and print its readings, largest
and root-mean-square (run pytest with -s to see them).
"""

import numpy as np
import pytest
import torch

from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels import fused_srk as fs
from snsde_torch.kernels._solver import MULT_Y_NO

CASES = [(4, 17, 1), (2, 16, 2), (6, 17, 0)]
SCALES = ["init", "wide"]
F64_FACTOR = 4.0
F64_FLOOR = 1e-5


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


def _errs(a, ref):
    """(largest, root-mean-square) error of a from ref, each over ref's
    largest entry."""
    d = a.double() - ref
    scale = max(float(ref.abs().max()), 1e-30)
    return (float(d.abs().max()) / scale,
            float(d.square().mean().sqrt()) / scale)


def _check(fns, inputs, flags, gys, scale):
    fwd, fwd_ref, bwd, bwd_ref = fns
    ys_k = fwd(**inputs, **flags)
    ys_p = fwd_ref(**inputs, **flags)
    g_k = bwd(ys=ys_p, gys=gys, **inputs, **flags)
    g_p = bwd_ref(ys=ys_p, gys=gys, **inputs, **flags)
    in64 = {k: v.double() for k, v in inputs.items()}
    ys_64 = fwd_ref(**in64, **flags)
    g_64 = bwd_ref(ys=ys_64, gys=gys.double(), **in64, **flags)
    torch.cuda.synchronize()
    outs = [("ys", ys_k, ys_p, ys_64)] + [
        (name, a, b, c) for name, a, b, c in zip(g_p._fields, g_k, g_p, g_64)
        if c.numel()]
    for name, k_, p_, ref in outs:
        (k_max, k_rms), (p_max, p_rms) = _errs(k_, ref), _errs(p_, ref)
        print(f"{scale} {name}: max|float64| {float(ref.abs().max()):.3e}, "
              f"error from float64 over it (largest, rms): kernel "
              f"{k_max:.2e} {k_rms:.2e}, float32 plain {p_max:.2e} "
              f"{p_rms:.2e}")
        assert k_rms <= F64_FACTOR * p_rms + F64_FLOOR, (
            f"{name}: rms error from float64: kernel {k_rms:.2e}, float32 "
            f"plain {p_rms:.2e}")
    if scale == "init":
        err = float((ys_k - ys_p).abs().max())
        assert err < 5e-5, f"ys: max abs err {err:.2e}"
        for name, a, b, _ in outs[1:]:
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            assert rel < 1e-5, f"{name}: rel err {rel:.2e}"


def _fns(mod, pre):
    return tuple(getattr(mod, f"{pre}_{n}") for n in (
        "forward", "forward_reference", "backward", "backward_reference"))


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
    ys = fs.fused_srk_forward(**inputs, **flags)
    torch.cuda.synchronize()
    assert torch.equal(ys, inputs["y0"].expand_as(ys))
