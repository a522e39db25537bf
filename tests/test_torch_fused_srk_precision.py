"""The fused SRK pair's reduced-precision modes, port against the JAX package
on the CPU: bf16 streams (SNSDE_FUSED_STREAM, `stream_dtype=`) and bf16 or
bf16x3 operands of the in-kernel products (SNSDE_FUSED_MATMUL, `matmul=`).

The JAX kernels run in Pallas interpret mode (SNSDE_FUSED_INTERPRET=1) with
the modes set through the environment; the port runs its plain versions
(what its wrappers take for CPU tensors, and what chip_smoke.py holds the
CUDA kernels against) with the same weights (snsde_torch.convert), control
path and (dW, I10), drawn with numpy. The bars are those of
tests/test_torch_fused_em_precision.py, whose product test holds the
bf16x3 split of the products both pairs share (_solver.mm_op).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.fields import DiffusionField as JaxField
from snsde.nn.core import filter_value_and_grad
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.kernels import fused_srk as fs
from snsde_torch.kernels import multi
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

from test_torch_fused_em_precision import (COMBOS, GRAD_TOL, _check, _dtype,
                                           _jax_modes, jax_arrays)

B, L, C, W = 13, 6, 3, 16
# (input_option, noise_option, operand mode, stream dtype): every reduced
# combination once (a JAX solve in interpret mode takes ~8 s), over
# MuJoCo's and bench.py's LNSDE (embm, precomp, mult_y; bench.py's own
# precision first), naivesde's net2 (yy), drift 'xt' with sqrt noise, and
# net1 with the merged drift
CASES = [(4, 17, "bf16x3", "bf16"), (1, 18, "f32", "bf16"),
         (4, 17, "bf16x3", "f32"), (0, 7, "bf16", "f32"),
         (2, 14, "bf16", "bf16")]
assert sorted(c[2:] for c in CASES) == sorted(COMBOS)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.delenv("SNSDE_FUSED_STREAM", raising=False)
    monkeypatch.delenv("SNSDE_FUSED_MATMUL", raising=False)


def _setting(seed=0, Bn=B, Ln=L, width=W):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, C)).astype(np.float32)
    y0 = rng.normal(size=(Bn, width)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dts = np.diff(grid)[:, None, None]
    dW = rng.normal(size=(len(grid) - 1, Bn, width)) * np.sqrt(dts)
    I10 = 0.5 * dts * (dW + rng.normal(size=dW.shape) * np.sqrt(dts / 3.0))
    return times, x, y0, dW.astype(np.float32), I10.astype(np.float32)


def _path(times, x):
    return CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)


def _jax_solve(monkeypatch, io, no, matmul, stream, setting, layers=2):
    from snsde.kernels.fused_srk import fused_srk_solve as jax_solve

    _jax_modes(monkeypatch, matmul, stream)
    times, x, y0, dW, I10 = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, W, W,
                             layers, input_option=io, noise_option=no)

    def loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy,
                       jax.random.PRNGKey(0), dt=resolve_dt(times),
                       brownian_override=(jnp.asarray(dW), jnp.asarray(I10)))
        return jnp.mean(ys ** 2), ys

    (_, ys), g = filter_value_and_grad(loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))
    grads = jax_arrays(g[0])
    grads["y0"] = np.asarray(g[1])
    monkeypatch.delenv("SNSDE_FUSED_STREAM")
    monkeypatch.delenv("SNSDE_FUSED_MATMUL")
    return jfield, np.asarray(ys), grads


def _port_solve(jfield, io, no, matmul, stream, setting, layers=2):
    times, x, y0, dW, I10 = setting
    field = DiffusionField(C, W, W, layers, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    path = _path(times, x)
    y0t = torch.as_tensor(y0).requires_grad_(True)
    ys = fs.fused_srk_solve(field.bind(path), path, times, y0t,
                            dt=resolve_dt(times),
                            brownian_override=(torch.as_tensor(dW),
                                               torch.as_tensor(I10)),
                            stream_dtype=_dtype(stream), matmul=matmul)
    (ys ** 2).mean().backward()
    grads = grads_to_jax_layout(field)
    grads["y0"] = y0t.grad.numpy()
    return ys.detach().numpy(), grads


@pytest.mark.parametrize("io,no,matmul,stream", CASES)
def test_solve_matches_jax_kernel_in_reduced_precision(monkeypatch, matmul,
                                                       stream, io, no):
    """fused_srk_solve's plain versions in the mode against the JAX kernel
    in the same mode, at B=13, 5 steps, H=HH=16, one inner layer: every
    trajectory entry within one bf16 ulp of |ys| plus 1e-6, every gradient
    (y0's too) within 2e-3 of its leaf's largest entry (the EM pair's
    bars and their reasons). The control: apart from bf16x3 operands with
    fp32 streams (~1e-5 from exact; the split is held at one product by
    the EM file's test_product_matches_jax_dot, the same mm_op), JAX's
    result in the mode moves some gradient past the bar from the exact
    fp32 result (the port's, which holds JAX's to 5e-4 of each leaf's
    largest entry, tests/test_torch_fused_srk.py)."""
    setting = _setting()
    jfield, ys_j, g_j = _jax_solve(monkeypatch, io, no, matmul, stream,
                                   setting)
    ys, g = _port_solve(jfield, io, no, matmul, stream, setting)
    assert _check(ys, ys_j, g, g_j, f"({io},{no}) {matmul} {stream}") >= 6
    if (matmul, stream) != ("bf16x3", "f32"):
        _, exact = _port_solve(jfield, io, no, "f32", "f32", setting)
        gap = max(float(np.abs(g_j[k] - exact[k]).max()
                        / np.abs(g_j[k]).max())
                  for k in g_j if np.abs(g_j[k]).max())
        assert gap > GRAD_TOL, f"the mode moves JAX only {gap:.2e}"



@pytest.mark.parametrize("io,no", [(4, 17), (1, 18)])
@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_packed_members_are_their_solo_solves(matmul, stream, io, no):
    """A packed K=2 solve (fused_srk_solve_packed) in the mode: each
    member's trajectory and every gradient bit for bit its solo solve's
    with the same (dW, I10)."""
    times, x, y0, dW, I10 = _setting(seed=11, Bn=5, Ln=4, width=8)
    path = _path(times, x)
    y0s = torch.as_tensor(np.stack([y0, -0.5 * y0]))
    dWs = torch.as_tensor(np.stack([dW, dW[::-1].copy()]))
    I10s = torch.as_tensor(np.stack([I10, -I10]))
    prec = dict(stream_dtype=_dtype(stream), matmul=matmul)
    fields = [DiffusionField(C, 8, 8, 1, input_option=io, noise_option=no,
                             generator=torch.Generator().manual_seed(k))
              for k in range(2)]
    packed = multi.fused_srk_solve_packed(fields, path, times, y0s,
                                          (dWs, I10s), **prec)
    (packed ** 2).sum().backward()
    got = [[p.grad.clone() for p in f.parameters() if p.grad is not None]
           for f in fields]
    for k, f in enumerate(fields):
        f.zero_grad()
        solo = fs.fused_srk_solve(f.bind(path), path, times, y0s[k],
                                  brownian_override=(dWs[k], I10s[k]),
                                  **prec)
        assert torch.equal(solo, packed[k].detach()), k
        (solo ** 2).sum().backward()
        want = [p.grad for p in f.parameters() if p.grad is not None]
        assert len(want) == len(got[k]) > 0
        for a, b in zip(got[k], want):
            assert torch.equal(a, b), k


def _kernel_inputs(seed=4, M=5, Bk=6, Hk=8):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    return dict(y0=t(Bk, Hk), xh0=None, xh1=None, dw=0.3 * t(M, Bk, Hk),
                i10=0.05 * t(M, Bk, Hk), a0=t(M, Hk), a1=t(M, Hk),
                gk0=t(M, Hk), gk1=t(M, Hk), gk2=t(M, Hk),
                dts=torch.full((M,), 0.5), theta=t(1), wy=0.5 * t(Hk, Hk),
                w_inner=0.5 * t(1, Hk, Hk), b_inner=t(1, Hk),
                wout=0.5 * t(Hk, Hk), bo=t(Hk), wn1=0.5 * t(Hk, Hk),
                wn2=0.5 * t(Hk, Hk), bn2=t(Hk))


def test_plain_versions_keep_the_forward_carry_and_round_the_trajectory():
    """With bf16 streams the forward's carry and stage states stay float32
    (only the written trajectory is rounded): rounding the fp32-stream
    run's trajectory (with the streams rounded beforehand) gives the bf16
    run's bit for bit; and the backward recomputes the noise nets from the
    rounded trajectory, so its recurrence's stage states (nst) are those
    of a step from the rounded state, not the carry's."""
    inputs = _kernel_inputs()
    flags = dict(mult_y=False, geometric=False, drift="yy", noise="net2")
    r16 = {k: inputs[k].to(torch.bfloat16) for k in ("dw", "i10")}
    ys16, ns16 = fs.fused_srk_forward_reference(**{**inputs, **r16}, **flags,
                                                stream="bf16")
    ys32, ns32 = fs.fused_srk_forward_reference(
        **{**inputs, **{k: v.float() for k, v in r16.items()}}, **flags)
    assert ys16.dtype == torch.bfloat16 and ns16 is None
    assert torch.equal(ys16, ys32.to(torch.bfloat16))
    gys = torch.ones_like(ys16)
    st = fs.fused_srk_backward_recurrence_reference(
        inputs["y0"], ys16, gys, **{k: v for k, v in inputs.items()
                                    if k != "y0"} | r16, **flags,
        stream="bf16")
    # the stage-1 state of step 1, from the rounded state after step 0
    y = ys16[0].float()
    one = {k: (v[1:2] if k in ("dw", "i10", "a0", "a1", "gk0", "gk1", "gk2",
                               "dts") else v)
           for k, v in inputs.items() if k != "y0"}
    one.update(dw=r16["dw"][1:2].float(), i10=r16["i10"][1:2].float())
    _, ns1 = fs.fused_srk_forward_reference(y, **one, **flags)
    assert torch.equal(st.nst[:, 1], ns1.nst[:, 0])
    assert not torch.equal(st.nst[:, 1], ns32.nst[:, 1])


def test_reduced_weight_gradient_products_take_the_mode():
    """The weight-gradient kernel's plain version splits every product's
    operands in bf16x3 (the stage states and dn too) and keeps the column
    sums exact: from one recurrence's streams, bf16x3 parts from exact fp32
    on every product and not on a sum."""
    inputs = _kernel_inputs()
    flags = dict(mult_y=True, geometric=False, drift="yy", noise="net1")
    inputs.update(wn2=None, bn2=None)
    ys, _ = fs.fused_srk_forward_reference(**inputs, **flags,
                                           matmul="bf16x3")
    st = fs.fused_srk_backward_recurrence_reference(
        inputs["y0"], ys, torch.ones_like(ys),
        **{k: v for k, v in inputs.items() if k != "y0"}, **flags,
        matmul="bf16x3")
    w = {m: fs.fused_srk_weight_grads(inputs["y0"], ys, st, drift="yy",
                                      noise="net1", matmul=m)
         for m in ("f32", "bf16x3")}
    for name in ("dwy", "dw_inner", "dwout", "dwn1"):
        assert not torch.equal(getattr(w["f32"], name),
                               getattr(w["bf16x3"], name)), name
    for name in ("db_inner", "dbo", "da", "dgk"):
        assert torch.equal(getattr(w["f32"], name),
                           getattr(w["bf16x3"], name)), name


@pytest.mark.parametrize("part", ["forward", "backward"])
@pytest.mark.parametrize("key", ["srk", "cde"])
def test_chip_check_reduced_refuses_a_kernel_wrong_in_one_row(monkeypatch,
                                                             key, part):
    """chip_smoke.py's phase-17 check (check_reduced) holds the plain
    version itself, and refuses a kernel in bf16 operands and streams whose
    trajectory or first cotangent is wrong in one entry of one row, at a
    batch that leaves a partial block, through every fallback it has (the
    plain version in the kernel's order of sums, one bf16 flip, the float64
    rule in rms and largest entry, the rows with a relu near 0 set
    aside)."""
    import chip_smoke as c

    monkeypatch.setattr(c, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if key == "srk":
        inp, gys = c.kernel_inputs(c.mode_name(3, 15), 11, 5, 4, 8, 2,
                                   srk=True)
        fwd, flags = c._split(inp, True)
    else:
        fwd, flags, gys = c.cde_kernel_inputs(11, 6, 4, 8, 1,
                                              field="final_tanh")
    args = c.red_prec_args(key, fwd, flags, gys, "bf16", "bf16")
    c.check_reduced(key, "plain", *args)
    real = c.kernel_fns

    def wrong(k):
        fk, fp, bk, bp = real(k)

        def fk2(*a, **kw):
            ys, ns = fp(*a, **kw)
            ys = ys.clone()
            ys[-1, 3] += 0.05 * ys.float().abs().max().to(ys.dtype)
            return ys, ns

        def bk2(*a, **kw):
            g = bp(*a, **kw)
            t = g[0].clone()
            t.view(-1)[5] += 0.05 * float(t.abs().max())
            return g._replace(**{g._fields[0]: t})
        return (fk2, fp, bk, bp) if part == "forward" else (fk, fp, bk2, bp)

    monkeypatch.setattr(c, "kernel_fns", wrong)
    with pytest.raises(AssertionError, match="kernel"):
        c.check_reduced(key, "one row wrong", *args)
