"""snsde_torch.kernels.fused_srk against the JAX package's fused SRK kernel
and against the port's eager `sdeint(method="srk")`.

The JAX kernel runs in Pallas interpret mode on the CPU (as
tests/test_fused_srk.py runs it); the port runs its plain PyTorch
versions, which is what its wrapper takes for CPU tensors. Both sides get
the same weights (through snsde_torch.convert), the same control path and
the same (dW, I10), drawn with numpy. The CUDA kernels themselves are
compared with the plain versions on the card by chip_smoke.py and by
tests/test_torch_cuda.py.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

from types import SimpleNamespace

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
from snsde_torch.kernels._solver import MULT_Y_NO, PRECOMP_NO
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                             make_grid, sdeint)

B, L, C, H = 8, 6, 3, 5


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (the key format of
    snsde_torch.convert)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")


def _setting(Bn=B, Ln=L, width=H):
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, C)).astype(np.float32)
    y0 = rng.normal(size=(Bn, width)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dts = np.diff(grid)[:, None, None]
    dW = rng.normal(size=(len(grid) - 1, Bn, width)) * np.sqrt(dts)
    I10 = 0.5 * dts * (dW + rng.normal(size=dW.shape) * np.sqrt(dts / 3.0))
    return times, x, y0, grid, dW.astype(np.float32), I10.astype(np.float32)


@pytest.fixture(scope="module")
def setting():
    return _setting()


def port_path(times, x):
    return CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)


@pytest.mark.parametrize("io,no", [(4, 17), (2, 16), (6, 17)])
def test_fused_srk_matches_jax_kernel(setting, io, no):
    """Trajectory to atol 2e-5 and every parameter gradient (and y0's) to
    5e-4 relative to its largest entry, the EM kernels' bar: both sides
    merge the drift and reverse the tableau the same way and differ only in
    f32 summation order (measured: trajectory 2.4e-7, gradients 3.7e-6
    relative at most)."""
    _check_against_jax(setting, io, no, H)


def _check_against_jax(setting, io, no, width, layers=2, grad_tol=5e-4):
    """The port's fused SRK solve (plain versions on the CPU) against the
    JAX fused SRK kernel in interpret mode on the same weights, path and
    (dW, I10): the trajectory to atol 2e-5, y0's and every parameter's
    gradient to grad_tol relative to its largest entry."""
    from snsde.kernels.fused_srk import fused_srk_solve as jax_solve

    times, x, y0, _, dW, I10 = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, width,
                             width, layers, input_option=io,
                             noise_option=no)
    dt = resolve_dt(times)

    def jax_loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy,
                       jax.random.PRNGKey(0), dt=dt,
                       brownian_override=(jnp.asarray(dW), jnp.asarray(I10)))
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = DiffusionField(C, width, width, layers, input_option=io,
                           noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    path = port_path(times, x)
    y0_t = torch.as_tensor(y0).requires_grad_(True)
    ys_t = fs.fused_srk_solve(field.bind(path), path, times, y0_t, dt=dt,
                              brownian_override=(torch.as_tensor(dW),
                                                 torch.as_tensor(I10)))
    (ys_t ** 2).mean().backward()

    np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                               atol=2e-5)
    ours = grads_to_jax_layout(field)
    ours["y0"] = y0_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["y0"] = np.asarray(g_j[1])
    assert set(theirs) <= set(ours)
    for name, ref in theirs.items():
        denom = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(ours[name] - ref).max()) / denom
        assert err < grad_tol, f"({io},{no}) grad {name}: rel err {err:.2e}"


SUPPORTED = [(io, no) for io in (2, 4, 6) for no in sorted(PRECOMP_NO)]


@pytest.mark.parametrize("io,no", SUPPORTED)
def test_fused_srk_solve_matches_eager_srk(setting, io, no):
    """Over every configuration the kernels take, the fused solve (plain
    versions on the CPU) matches the port's eager srk on the same
    (dW, I10): the trajectory to atol 2e-5 (the merged drift reassociates
    f32 sums), and every parameter gradient and y0's to 1e-4 relative."""
    times, x, y0, grid, dW, I10 = setting
    gen = torch.Generator().manual_seed(io * 20 + no)
    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no,
                           generator=gen)
    path = port_path(times, x)
    field.bind(path)

    def run(fused):
        field.zero_grad(set_to_none=True)
        yy = torch.as_tensor(y0).requires_grad_(True)
        if fused:
            ys = fs.fused_srk_solve(field, path, times, yy,
                                    brownian_override=(torch.as_tensor(dW),
                                                       torch.as_tensor(I10)))
        else:
            ys = sdeint(field.f, field.g, yy, times, method="srk",
                        bm=BrownianGrid(grid, torch.as_tensor(dW),
                                        torch.as_tensor(I10)))
        (ys ** 2).mean().backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in field.named_parameters()}
        grads["y0"] = yy.grad
        return ys.detach(), grads

    ys_f, g_f = run(True)
    ys_e, g_e = run(False)
    np.testing.assert_allclose(ys_f.numpy(), ys_e.numpy(), atol=2e-5)
    for name, ref in g_e.items():
        denom = max(float(ref.abs().max()), 1e-6)
        err = float((g_f[name] - ref).abs().max()) / denom
        assert err < 1e-4, f"({io},{no}) grad {name}: rel err {err:.2e}"


def _kernel_inputs(io, no, n_inner, seed=0, Bk=6, M=5, Hk=4, dt=0.5):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    inputs = dict(y0=t(Bk, Hk), xh0=t(M, Bk, Hk), xh1=t(M, Bk, Hk),
                  dw=0.7 * t(M, Bk, Hk), i10=0.2 * t(M, Bk, Hk),
                  a0=t(M, Hk), a1=t(M, Hk), gk0=t(M, Hk).abs(),
                  gk1=t(M, Hk).abs(), gk2=t(M, Hk).abs(),
                  dts=torch.full((M,), dt), theta=t(1),
                  wy=0.5 * t(Hk, Hk), w_inner=0.5 * t(n_inner, Hk, Hk),
                  b_inner=t(n_inner, Hk), wout=0.5 * t(Hk, Hk), bo=t(Hk))
    flags = dict(mult_y=no in MULT_Y_NO, geometric=io in (5, 6))
    return inputs, flags, t(M, Bk, Hk)


@pytest.mark.parametrize("io,no,n_inner", [(4, 17, 1), (2, 16, 2),
                                           (6, 17, 1), (6, 16, 0)])
def test_backward_reference_is_autograd_of_forward(io, no, n_inner):
    """The plain reverse loop (the backward kernel's twin) equals torch
    autograd of the plain forward loop, to f32 rounding (1e-5 relative)."""
    inputs, flags, gys = _kernel_inputs(io, no, n_inner)
    leaves = {k: v.clone().requires_grad_(k not in ("dw", "i10", "dts"))
              for k, v in inputs.items()}
    ys, _ = fs.fused_srk_forward_reference(**leaves, **flags)
    (ys * gys).sum().backward()
    grads = fs.fused_srk_backward_reference(ys=ys.detach(), gys=gys,
                                            **inputs, **flags)
    for name in fs.FusedSRKGrads._fields:
        leaf = leaves[name[1:]]
        auto = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        ours = getattr(grads, name)
        assert ours.shape == auto.shape, name
        if not auto.numel():
            continue
        denom = max(float(auto.abs().max()), 1e-6)
        assert float((ours - auto).abs().max()) / denom < 1e-5, name


def _split_backward(y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2,
                    dts, theta, wy, w_inner, b_inner, wout, bo, wn1=None,
                    wn2=None, bn2=None, *, mult_y, geometric, drift="embm",
                    noise="precomp", elem=0, ns=None, stream="f32",
                    matmul="f32"):
    """The card's backward in plain form: the recurrence's plain version,
    then the weight-gradient kernel's plain version on its streams (with
    bf16 streams over the rounded states, dxh handed back in bf16; in a
    reduced precision the nets' streams the recurrence's own)."""
    st = fs.fused_srk_backward_recurrence_reference(
        y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta,
        wy, w_inner, b_inner, wout, bo, wn1, wn2, bn2, mult_y=mult_y,
        geometric=geometric, drift=drift, noise=noise, elem=elem, ns=ns,
        stream=stream, matmul=matmul)
    reduced = stream == "bf16" or matmul != "f32"
    nst, nh = (st.nst, st.nh) if reduced or ns is None else (ns.nst, ns.nh)
    y0r = y0.to(ys.dtype).to(y0.dtype)
    w = fs.fused_srk_weight_grads_reference(
        y0r, ys, st.h01, st.dxh, st.hs, st.es, st.dz3, st.q, nst, st.dn,
        st.dz2, nh, drift=drift, noise=noise, matmul=matmul)
    yy = drift == "yy"
    da = (None, None) if w.da is None else (w.da[0], w.da[1])
    dgk = (None,) * 3 if w.dgk is None else (w.dgk[0], w.dgk[1], w.dgk[2])
    dxh = st.dxh if yy else st.dxh.to(xh0.dtype)
    out = (st.dy0, None if yy else dxh[0], None if yy else dxh[1],
           *da, *dgk, st.dtheta, w.dwy, w.dw_inner, w.db_inner, w.dwout,
           w.dbo)
    if noise in ("net1", "net2"):
        return fs.FusedSRKNetGrads(*out, w.dwn1, w.dwn2, w.dbn2)
    return fs.FusedSRKGrads(*out)


@pytest.mark.parametrize("io,no,n_inner", [(4, 17, 1), (2, 16, 0),
                                           (6, 17, 2), (6, 16, 1)])
def test_weight_grads_reference_matches_backward_reference(io, no, n_inner):
    """The weight-gradient kernel's plain version, on the plain backward
    recurrence's streams, gives the in-loop sums of the plain reverse loop
    (fused_srk_backward_reference, the JAX `_bwd_kernel`'s twin), with
    mult_y on and off: every cotangent to 1e-5 of its largest entry in
    float32, and to 1e-12 in float64 (the two differ only in the order of
    the sums; measured at most 5.3e-7 and 1.1e-15)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        inputs, flags, gys = _kernel_inputs(io, no, n_inner, Bk=13, M=5,
                                            Hk=16)
        inputs = {k: v.to(dtype) for k, v in inputs.items()}
        gys = gys.to(dtype)
        ys, _ = fs.fused_srk_forward_reference(**inputs, **flags)
        ref = fs.fused_srk_backward_reference(ys=ys, gys=gys, **inputs,
                                              **flags)
        got = _split_backward(ys=ys, gys=gys, **inputs, **flags)
        for name, a, b in zip(ref._fields, got, ref):
            assert a.shape == b.shape, name
            if not b.numel():
                continue
            denom = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) / denom < tol, (name, dtype)


@pytest.mark.parametrize("io,no,layers", [(2, 16, 1), (4, 17, 2),
                                          (6, 17, 3)])
def test_split_backward_matches_jax_kernel(monkeypatch, io, no, layers):
    """The backward as the card runs it (recurrence, then the weight
    gradient over its streams), in plain form, against the JAX fused SRK
    kernel at B=13, M=5, H=HH=16 with 0, 1 and 2 inner layers, mult_y and
    geometric on and off: the trajectory to atol 2e-5 and every gradient
    to 1e-4 of its largest entry."""
    monkeypatch.setattr(fs, "fused_srk_backward_reference", _split_backward)
    _check_against_jax(_setting(Bn=13, Ln=6, width=16), io, no, 16, layers,
                       grad_tol=1e-4)


@pytest.mark.parametrize("n_inner", [0, 2])
def test_plain_versions_take_every_relu_from_their_argument(n_inner):
    """Every relu of the plain forward and backward (two drift evaluations
    a step) goes through their `relu` argument, and torch.relu given there
    changes nothing."""
    inputs, flags, gys = _kernel_inputs(4, 17, n_inner)
    seen = []

    def relu(z):
        seen.append(z.shape)
        return torch.relu(z)

    ys, _ = fs.fused_srk_forward_reference(**inputs, **flags, relu=relu)
    M, Bk = gys.shape[:2]
    assert seen == [(Bk, 4)] * (2 * M * (1 + n_inner))
    torch.testing.assert_close(
        ys, fs.fused_srk_forward_reference(**inputs, **flags)[0], rtol=0,
        atol=0)
    seen.clear()
    g = fs.fused_srk_backward_reference(ys=ys, gys=gys, **inputs, **flags,
                                        relu=relu)
    assert len(seen) == 2 * M * (1 + n_inner)
    for a, b in zip(g, fs.fused_srk_backward_reference(ys=ys, gys=gys,
                                                       **inputs, **flags)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_zero_step_is_identity():
    """dt = 0 steps (guarded 1/dt and 1/sqrt(dt)) leave y exactly as it
    was, forward and backward: dy0 is exactly the summed cotangent."""
    inputs, flags, gys = _kernel_inputs(4, 17, 1, dt=0.0)
    inputs["dw"] = torch.zeros_like(inputs["dw"])
    inputs["i10"] = torch.zeros_like(inputs["i10"])
    ys, _ = fs.fused_srk_forward(**inputs, **flags)
    assert torch.equal(ys, inputs["y0"].expand_as(ys))
    grads = fs.fused_srk_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.testing.assert_close(grads.dy0, gys.sum(0), rtol=0, atol=1e-6)
    assert not grads.dwy.any() and not grads.dtheta.any()


def test_supports_fused_srk_is_exactly_the_kernel_modes():
    """The kernels take the whole 7 x 20 grid, as the JAX kernels do; the
    input builder raises only for options out of range."""
    take = {(io, no) for io in range(7) for no in range(20)
            if fs.supports_fused_srk(DiffusionField(C, H, H, 1,
                                                    input_option=io,
                                                    noise_option=no))}
    assert take == {(io, no) for io in range(7) for no in range(20)}
    with pytest.raises(ValueError, match="fused SRK kernels take"):
        fs.fused_srk_inputs(SimpleNamespace(input_option=1, noise_option=20),
                            None, np.arange(3.0), torch.zeros(2, H),
                            torch.zeros(2, 2, H), torch.zeros(2, 2, H))


def test_kernel_input_checks_name_the_limit(monkeypatch):
    inputs, flags, gys = _kernel_inputs(4, 17, 1)
    assert fs.check_kernel_inputs(**inputs) == (5, 6, 4, 4, 1)
    with pytest.raises(ValueError, match="float32 only"):
        fs.check_kernel_inputs(**{**inputs, "i10": inputs["i10"].double()})
    with pytest.raises(ValueError, match="expected"):
        fs.check_kernel_inputs(**{**inputs, "gk2": inputs["gk2"][:, :3]})
    with pytest.raises(ValueError, match="expected"):
        fs.check_kernel_inputs(**inputs, ys=gys[:, :3], gys=gys)
    with pytest.raises(ValueError, match="not contiguous"):
        fs.check_kernel_inputs(**{**inputs, "wout": inputs["wout"].t()})
    # any width passes the checks (the plan splits the weights over a
    # cluster or reads them from device memory); the launch that cannot fit
    # even then raises naming the limit (stand-in library: the real one
    # needs the card)
    wide, _, wide_gys = _kernel_inputs(4, 17, 1, Bk=2, M=2, Hk=256)
    assert fs.check_kernel_inputs(**wide, ys=wide_gys, gys=wide_gys) == (
        2, 2, 256, 256, 1)
    limit = 232448
    kept = {"smem_bytes": limit + 4, "max_smem": limit}
    monkeypatch.setattr(fs._LIB, "kept", lambda fn, *ints: kept[fn])
    cuda = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match=f"above this device's {limit}-byte "
                                         f"limit per block"):
        fs._LIB.stream(cuda, (2, 4096, 4096, 1), backward=False)


def test_wrapper_raises_on_a_device_without_the_kernel():
    """CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back."""
    inputs, flags, gys = _kernel_inputs(4, 17, 1)
    meta = {k: v.to("meta") for k, v in inputs.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_srk_forward(**meta, **flags)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_srk_backward(ys=gys.to("meta"), gys=gys.to("meta"), **meta,
                              **flags)


def test_build_target_hashes_the_shared_headers(tmp_path):
    """A library is named by its source, every csrc/*.cuh and the flags:
    an edited header renames (so rebuilds) each library, an edited source
    only its own."""
    import shutil

    from snsde_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build._target(n, str(csrc)) for n in ("fused_em",
                                                        "fused_srk")}
    assert before == {n: _build._target(n) for n in before}
    header = csrc / "sde_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n, str(csrc)) for n in before}
    assert all(after[n] != before[n] for n in before)
    src = csrc / "fused_srk.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("fused_srk", str(csrc)) != after["fused_srk"]
    assert _build._target("fused_em", str(csrc)) == after["fused_em"]
