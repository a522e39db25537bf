"""snsde_torch.kernels.fused_em against the JAX package's fused EM kernel.

The JAX kernel runs in Pallas interpret mode on the CPU (as
tests/test_fused_grid.py runs it); the port runs its plain PyTorch
versions, which is what its wrapper takes for CPU tensors. Both sides get
the same weights (through snsde_torch.convert), the same control path and
the same Brownian increments, drawn with numpy. The CUDA kernels
themselves are compared with the plain versions on the card by
chip_smoke.py and by tests/test_torch_cuda.py.
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
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels._solver import MULT_Y_NO, PRECOMP_NO
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                             make_grid, sdeint)

B, L, C, H = 8, 6, 3, 5


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (BatchNorm buffers
    without their `.value`), the key format of snsde_torch.convert."""
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
    dW = (rng.normal(size=(len(grid) - 1, Bn, width))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    return times, x, y0, dW


@pytest.fixture(scope="module")
def setting():
    return _setting()


def port_field(jfield, io, no, layers, width=H):
    field = DiffusionField(C, width, width, layers, input_option=io,
                           noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    return field


@pytest.mark.parametrize("io,no", [(4, 17), (2, 16), (6, 17)])
def test_fused_em_matches_jax_kernel(setting, io, no):
    """Trajectory to atol 2e-5 and every parameter gradient (and y0's) to
    5e-4 relative: the bar tests/test_fused_grid.py holds the JAX kernel to
    against its scan; the two sides merge the drift the same way and
    differ only in f32 summation order."""
    _check_against_jax(setting, io, no, H)


def test_fused_em_matches_jax_kernel_at_width_128():
    """The same bar at H = HH = 128 with one inner layer (the width that
    took the kernels past their former 128 limit on the backward's shared
    memory), at a small batch and few steps."""
    _check_against_jax(_setting(Bn=3, Ln=4, width=128), 4, 17, 128)


def _check_against_jax(setting, io, no, width, layers=2):
    from snsde.kernels.fused_em import fused_em_solve as jax_solve

    times, x, y0, dW = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, width,
                             width, layers, input_option=io,
                             noise_option=no)
    dt = resolve_dt(times)
    key = jax.random.PRNGKey(0)

    def jax_loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy, key, dt=dt,
                       dW_override=jnp.asarray(dW))
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = port_field(jfield, io, no, layers, width)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    y0_t = torch.as_tensor(y0).requires_grad_(True)
    ys_t = fe.fused_em_solve(field.bind(path), path, times, y0_t, dt=dt,
                             dW_override=torch.as_tensor(dW))
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
        assert err < 5e-4, f"({io},{no}) grad {name}: rel err {err:.2e}"


def _kernel_inputs(io, no, n_inner, seed=0, Bk=6, M=5, Hk=4):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    inputs = dict(y0=t(Bk, Hk), xh=t(M, Bk, Hk), dw=0.3 * t(M, Bk, Hk),
                  a=t(M, Hk), gk=t(M, Hk).abs(),
                  dts=torch.full((M,), 0.5), theta=t(1),
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
    leaves = {k: v.clone().requires_grad_(k not in ("dw", "dts"))
              for k, v in inputs.items()}
    ys, _ = fe.fused_em_forward_reference(**leaves, **flags)
    (ys * gys).sum().backward()
    grads = fe.fused_em_backward_reference(ys=ys.detach(), gys=gys,
                                           **inputs, **flags)
    for name in fe.FusedEMGrads._fields:
        leaf = leaves[name[1:]]
        auto = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        ours = getattr(grads, name)
        assert ours.shape == auto.shape, name
        if not auto.numel():
            continue
        denom = max(float(auto.abs().max()), 1e-6)
        assert float((ours - auto).abs().max()) / denom < 1e-5, name


def _split_backward(y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner,
                    b_inner, wout, bo, wn1=None, wn2=None, bn2=None, lat=None,
                    *, mult_y, geometric, drift="embm", noise="precomp",
                    elem=0, latent=False, ns=None, stream="f32",
                    matmul="f32"):
    """The card's backward in plain form: the recurrence's plain version,
    then the weight-gradient kernel's plain version on its streams (with
    bf16 streams over the rounded states, dxh handed back in bf16)."""
    st = fe.fused_em_backward_recurrence_reference(
        y0, ys, gys, xh, dw, a, gk, dts, theta, wy, w_inner, b_inner, wout,
        bo, wn1, wn2, bn2, lat, mult_y=mult_y, geometric=geometric,
        drift=drift, noise=noise, elem=elem, latent=latent, ns=ns,
        stream=stream, matmul=matmul)
    w = fe.fused_em_weight_grads_reference(
        y0.to(ys.dtype), ys, st.dxh, st.hs, st.es, st.dz3, st.q, st.dn,
        st.dz2, None if ns is None else ns.nh, drift=drift, noise=noise,
        matmul=matmul)
    dxh = st.dxh if xh is None else st.dxh.to(xh.dtype)
    out = (st.dy0, None if drift == "yy" else dxh, w.da, w.dgk,
           st.dtheta, w.dwy, w.dw_inner, w.db_inner, w.dwout, w.dbo)
    if noise in ("net1", "net2"):
        return fe.FusedEMNetGrads(*out, w.dwn1, w.dwn2, w.dbn2)
    return fe.FusedEMGrads(*out)


@pytest.mark.parametrize("io,no,n_inner", [(4, 17, 1), (2, 16, 0),
                                           (6, 17, 2), (6, 16, 1)])
def test_weight_grads_reference_matches_backward_reference(io, no, n_inner):
    """The weight-gradient kernel's plain version, on the plain backward
    recurrence's streams, gives the in-loop sums of the plain reverse loop
    (fused_em_backward_reference, the JAX `_bwd_kernel`'s twin): every
    cotangent to 1e-5 of its largest entry in float32, and to 1e-12 in
    float64 (the two differ only in the order of the sums)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        inputs, flags, gys = _kernel_inputs(io, no, n_inner, Bk=13, M=5,
                                            Hk=16)
        inputs = {k: v.to(dtype) for k, v in inputs.items()}
        gys = gys.to(dtype)
        ys, _ = fe.fused_em_forward_reference(**inputs, **flags)
        ref = fe.fused_em_backward_reference(ys=ys, gys=gys, **inputs,
                                             **flags)
        got = _split_backward(ys=ys, gys=gys, **inputs, **flags)
        for name, a, b in zip(ref._fields, got, ref):
            assert a.shape == b.shape, name
            if not b.numel():
                continue
            denom = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) / denom < tol, (name, dtype)


@pytest.mark.parametrize("io,no,layers", [(2, 16, 1), (4, 17, 2),
                                          (6, 16, 3), (6, 17, 1),
                                          (2, 17, 3)])
def test_split_backward_matches_jax_kernel(monkeypatch, io, no, layers):
    """The backward as the card runs it (recurrence, then the weight
    gradient over its streams), in plain form, against the JAX fused EM
    kernel at B=13, M=5, H=HH=16 with 0, 1 and 2 inner layers, mult_y and
    geometric on and off: the bar of test_fused_em_matches_jax_kernel."""
    monkeypatch.setattr(fe, "fused_em_backward_reference", _split_backward)
    _check_against_jax(_setting(Bn=13, Ln=6, width=16), io, no, 16, layers)


@pytest.mark.parametrize("n_inner", [0, 2])
def test_plain_versions_take_every_relu_from_their_argument(n_inner):
    """Every relu of the plain forward and backward goes through their
    `relu` argument (a probe of the pre-activations sees all of them), and
    torch.relu given there changes nothing."""
    inputs, flags, gys = _kernel_inputs(4, 17, n_inner)
    seen = []

    def relu(z):
        seen.append(z.shape)
        return torch.relu(z)

    ys, _ = fe.fused_em_forward_reference(**inputs, **flags, relu=relu)
    M, Bk = gys.shape[:2]
    assert seen == [(Bk, 4)] * (M * (1 + n_inner))
    torch.testing.assert_close(
        ys, fe.fused_em_forward_reference(**inputs, **flags)[0], rtol=0,
        atol=0)
    seen.clear()
    g = fe.fused_em_backward_reference(ys=ys, gys=gys, **inputs, **flags,
                                       relu=relu)
    assert len(seen) == M * (1 + n_inner)
    for a, b in zip(g, fe.fused_em_backward_reference(ys=ys, gys=gys,
                                                      **inputs, **flags)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SUPPORTED = [(io, no) for io in (2, 4, 6) for no in sorted(PRECOMP_NO)]


@pytest.mark.parametrize("io,no", SUPPORTED)
def test_fused_solve_matches_eager_solver(setting, io, no):
    """Over every configuration the kernels take, the fused solve (plain
    versions on the CPU) matches the port's eager sdeint on the same dW;
    the merged drift reassociates f32 sums, hence atol 2e-5, not bitwise."""
    times, x, y0, dW = setting
    gen = torch.Generator().manual_seed(io * 20 + no)
    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no,
                           generator=gen)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    grid, _ = make_grid(times, resolve_dt(times))
    field.bind(path)
    with torch.no_grad():
        ys_f = fe.fused_em_solve(field, path, times, torch.as_tensor(y0),
                                 dW_override=torch.as_tensor(dW))
        ys_e = sdeint(field.f, field.g, torch.as_tensor(y0), times,
                      bm=BrownianGrid(grid, torch.as_tensor(dW)))
    np.testing.assert_allclose(ys_f.numpy(), ys_e.numpy(), atol=2e-5)


def test_supports_fused_is_exactly_the_kernel_modes():
    """The kernels take the whole 7 x 20 grid, as the JAX kernels do; the
    input builder raises only for options out of range."""
    take = {(io, no) for io in range(7) for no in range(20)
            if fe.supports_fused(DiffusionField(C, H, H, 1, input_option=io,
                                                noise_option=no))}
    assert take == {(io, no) for io in range(7) for no in range(20)}
    assert not fe.supports_fused(object())
    with pytest.raises(ValueError, match="fused EM kernels take"):
        fe.fused_em_inputs(SimpleNamespace(input_option=7, noise_option=18),
                           None, np.arange(3.0), torch.zeros(2, H),
                           torch.zeros(2, 2, H))


def test_kernel_input_checks_name_the_limit(monkeypatch):
    """The input checks take any width (H = HH = 256 here); the one limit
    left is a launch whose tiles do not fit a block's shared memory even
    with the weights and accumulators in device memory and one row a
    block, which the library reports and the wrapper raises on, naming the
    bytes and the limit (a stand-in library here: the real one needs the
    card)."""
    inputs, flags, gys = _kernel_inputs(4, 17, 1)
    assert fe.check_kernel_inputs(**inputs) == (5, 6, 4, 4, 1)
    with pytest.raises(ValueError, match="float32 only"):
        fe.check_kernel_inputs(**{**inputs, "xh": inputs["xh"].double()})
    with pytest.raises(ValueError, match="expected"):
        fe.check_kernel_inputs(**{**inputs, "a": inputs["a"][:, :3]})
    with pytest.raises(ValueError, match="not contiguous"):
        fe.check_kernel_inputs(**{**inputs,
                                  "wout": inputs["wout"].t()})
    wide, _, wide_gys = _kernel_inputs(4, 17, 1, Bk=2, M=2, Hk=256)
    assert fe.check_kernel_inputs(**wide, ys=wide_gys, gys=wide_gys) == (
        2, 2, 256, 256, 1)
    limit = 232448
    kept = {"smem_bytes": limit + 4, "max_smem": limit}
    monkeypatch.setattr(fe._LIB, "kept", lambda fn, *ints: kept[fn])
    cuda = SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match=f"above this device's {limit}-byte "
                                         f"limit per block"):
        fe._LIB.stream(cuda, (4096, 4096, 1), backward=True)


def test_wrapper_raises_on_a_device_without_the_kernel():
    """CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back."""
    inputs, flags, _ = _kernel_inputs(4, 17, 1)
    meta = {k: v.to("meta") for k, v in inputs.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fe.fused_em_forward(**meta, **flags)
