"""snsde_torch.kernels.fused_cde against the JAX package's fused CDE kernel
and against autograd of its own plain forward.

The JAX kernel runs in Pallas interpret mode on the CPU with float32
streams (as tests/test_fused_cde.py runs it); the port runs its plain
PyTorch versions, which is what its wrapper takes for CPU tensors. Both
sides get the same weights (through snsde_torch.convert), the same initial
state and the same control-derivative stream dx, drawn from a numpy-seeded
spline. The CUDA kernels themselves are compared with the plain versions
on the card by chip_smoke.py and by tests/test_torch_cuda.py.

Tolerances: trajectories 1e-5 absolute (both sides run the same tableau
in float32 and differ in summation order only); every gradient (the field's
weights, z0 and the control stream ddx) 1e-4 relative to its largest
entry.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.models.neuralcde import FinalTanh as JaxFinalTanh
from snsde.models.neuralcde import SingleHiddenLayer as JaxSingle
from snsde.nn.core import filter_value_and_grad

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.kernels import fused_cde as fc
from snsde_torch.models.neuralcde import (FinalTanh, GRUODEField,
                                          SingleHiddenLayer)
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

B, L, H, HH = 8, 6, 5, 7
TOL_YS = 1e-5
TOL_GRAD = 1e-4


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


def _fields(kind, C, n_inner, seed=3, width=H, hwidth=HH):
    """(JAX field, port field) with the same weights."""
    key = jax.random.PRNGKey(seed)
    if kind == "final_tanh":
        jf = JaxFinalTanh.create(key, C, width, hwidth, n_inner + 1)
        tf = FinalTanh(C, width, hwidth, n_inner + 1)
    else:
        jf = JaxSingle.create(key, C, width, hwidth)
        tf = SingleHiddenLayer(C, width, hwidth)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


def _setting(C, seed=0, Bn=B, Ln=L, width=H):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, C)).astype(np.float32)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    z0 = rng.normal(size=(Bn, width)).astype(np.float32)
    return rng, times, path, z0


CASES = ([("euler", "final_tanh", 1, 3), ("midpoint", "final_tanh", 1, 3),
          ("heun", "final_tanh", 1, 3), ("rk4", "final_tanh", 1, 3),
          ("rk4", "final_tanh", 0, 3), ("rk4", "final_tanh", 2, 3),
          ("rk4", "single", 0, 3), ("midpoint", "single", 0, 3),
          ("rk4", "final_tanh", 1, 50)])


@pytest.mark.parametrize("method,kind,n_inner,C", CASES)
def test_plain_versions_match_jax_kernel(method, kind, n_inner, C):
    """The trajectory and every cotangent (the field's weights, z0 and the
    control stream ddx) of the plain forward and backward against JAX
    `fused_cde_solve` and its custom VJP, on the same dx stream."""
    _check_against_jax(method, kind, n_inner, C, _setting(C),
                       _fields(kind, C, n_inner), L, B, H)


def test_plain_versions_match_jax_kernel_at_width_128():
    """The same at H = HH = 128 with one inner layer and rk4 (a field
    whose weights and accumulators overflow a block's shared memory on the
    card), at a small batch and few steps."""
    C = 3
    _check_against_jax("rk4", "final_tanh", 1, C,
                       _setting(C, Bn=3, Ln=4, width=128),
                       _fields("final_tanh", C, 1, width=128, hwidth=128),
                       4, 3, 128, dt=0.25)


def _check_against_jax(method, kind, n_inner, C, setting, fields, Ln, Bn,
                       width, dt=0.1):
    from snsde.kernels.fused_cde import fused_cde_solve as jax_solve

    rng, times, path, z0 = setting
    jf, tf = fields
    grid, out_idx = make_grid(times, dt)
    inp = fc.fused_cde_inputs(tf, path, grid, torch.as_tensor(z0), method)
    dx = inp["dx"].detach().numpy()
    G = rng.normal(size=(Ln, Bn, width)).astype(np.float32)

    def jax_loss(tree):
        fld, zz, dd = tree
        zs = jax_solve(fld, None, times, zz, dt=dt, method=method,
                       dx_override=dd)
        return jnp.sum(zs * G), zs

    (_, zs_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jf, jnp.asarray(z0), jnp.asarray(dx)))

    z0_t = torch.as_tensor(z0).requires_grad_(True)
    dx_t = torch.as_tensor(dx).requires_grad_(True)
    inp = fc.fused_cde_inputs(tf, path, grid, z0_t, method)
    ys = fc.FusedCDE.apply(z0_t, dx_t, *(inp[k] for k in fc._ARG_ORDER[2:]),
                           method, inp["act"])
    zs_t = torch.cat([z0_t[None], ys])[torch.as_tensor(out_idx)]
    (zs_t * torch.as_tensor(G)).sum().backward()

    np.testing.assert_allclose(zs_t.detach().numpy(), np.asarray(zs_j),
                               atol=TOL_YS)
    ours = grads_to_jax_layout(tf)
    ours["z0"], ours["dx"] = z0_t.grad.numpy(), dx_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["z0"], theirs["dx"] = np.asarray(g_j[1]), np.asarray(g_j[2])
    assert set(theirs) == set(ours)
    for name, ref in theirs.items():
        denom = max(float(np.abs(ref).max()), 1e-6)
        err = float(np.abs(ours[name] - ref).max()) / denom
        assert err < TOL_GRAD, f"{method} {kind}: grad {name} rel {err:.2e}"


def test_derivative_stream_matches_jax():
    """The stage grid is JAX's bit for bit, and the dx stream the port
    builds from derivative_grid matches the JAX stream (to float32
    rounding of the spline evaluation)."""
    from snsde.kernels.fused_cde import _stage_grid as jax_stage_grid
    from snsde.ops.interp import CubicPath as JaxPath
    from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite

    rng = np.random.default_rng(1)
    times = np.linspace(0.0, 1.0, 9).astype(np.float32)
    x = rng.normal(size=(4, 9, 3)).astype(np.float32)
    grid, _ = make_grid(times, float(np.min(np.diff(times.astype(
        np.float64)))))
    hs = np.diff(grid)
    for method in ("euler", "midpoint", "rk4"):
        ut, _ = fc._stage_times(method)
        st = fc._stage_grid(grid, hs, ut)
        assert np.array_equal(st, jax_stage_grid(grid, hs, ut))
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    np.testing.assert_allclose(path.derivative_grid(st).numpy(),
                               np.asarray(jpath.derivative_grid(st)),
                               rtol=1e-5, atol=1e-5)


def _kernel_inputs(method, act, n_inner, seed=0, Bk=6, M=5, Hk=4, HHk=5,
                   C=3, dt=0.3):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    NT = len(fc._stage_times(method)[0])
    inputs = dict(z0=t(Bk, Hk), dx=t(M, Bk, NT * C), dts=torch.full((M,), dt),
                  win=0.5 * t(Hk, HHk), bin=t(HHk),
                  w_inner=0.5 * t(n_inner, HHk, HHk), b_inner=t(n_inner, HHk),
                  wout=0.5 * t(HHk, Hk * C), bout=t(Hk * C))
    return inputs, dict(method=method, act=act), t(M, Bk, Hk)


@pytest.mark.parametrize("method,act,n_inner", [
    ("euler", "relu", 1), ("midpoint", "relu", 2), ("heun", "tanh", 0),
    ("rk2", "relu", 0), ("rk4", "relu", 1), ("rk4", "tanh", 0)])
def test_backward_reference_is_autograd_of_forward(method, act, n_inner):
    """The plain reverse loop (the backward kernel's twin) equals torch
    autograd of the plain forward loop, to float32 rounding (1e-5 relative
    to each cotangent's largest entry)."""
    inputs, flags, gys = _kernel_inputs(method, act, n_inner)
    leaves = {k: v.clone().requires_grad_(k != "dts")
              for k, v in inputs.items()}
    ys = fc.fused_cde_forward_reference(**leaves, **flags)
    (ys * gys).sum().backward()
    grads = fc.fused_cde_backward_reference(ys=ys.detach(), gys=gys,
                                            **inputs, **flags)
    for name in fc.FusedCDEGrads._fields:
        leaf = leaves[name[1:]]
        auto = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        ours = getattr(grads, name)
        assert ours.shape == auto.shape, name
        if not auto.numel():
            continue
        denom = max(float(auto.abs().max()), 1e-6)
        assert float((ours - auto).abs().max()) / denom < 1e-5, name


@pytest.mark.parametrize("method,act,n_inner", [
    ("rk4", "relu", 1), ("euler", "relu", 0), ("rk4", "tanh", 1)])
def test_plain_versions_take_every_relu_from_their_argument(method, act,
                                                            n_inner):
    """With act "relu" every hidden activation of the plain forward and
    backward (which re-evaluates each stage) goes through their `relu`
    argument, with "tanh" none; torch.relu given there changes nothing."""
    inputs, flags, gys = _kernel_inputs(method, act, n_inner)
    seen = []

    def relu(z):
        seen.append(z.shape)
        return torch.relu(z)

    ys = fc.fused_cde_forward_reference(**inputs, **flags, relu=relu)
    M, Bk = gys.shape[:2]
    evals = M * len(fc._TABLEAUS[method][2]) * (1 + n_inner)
    assert seen == ([(Bk, 5)] * evals if act == "relu" else [])
    torch.testing.assert_close(
        ys, fc.fused_cde_forward_reference(**inputs, **flags), rtol=0,
        atol=0)
    seen.clear()
    g = fc.fused_cde_backward_reference(ys=ys, gys=gys, **inputs, **flags,
                                        relu=relu)
    assert len(seen) == (2 * evals if act == "relu" else 0)
    for a, b in zip(g, fc.fused_cde_backward_reference(ys=ys, gys=gys,
                                                       **inputs, **flags)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_zero_step_is_identity():
    """dt = 0 steps leave z exactly as it was, forward and backward: dz0 is
    exactly the summed cotangent and no weight moves."""
    inputs, flags, gys = _kernel_inputs("rk4", "relu", 1, dt=0.0)
    ys = fc.fused_cde_forward(**inputs, **flags)
    assert torch.equal(ys, inputs["z0"].expand_as(ys))
    grads = fc.fused_cde_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.testing.assert_close(grads.dz0, gys.sum(0), rtol=0, atol=1e-6)
    assert not grads.dwin.any() and not grads.dwout.any()
    assert not grads.ddx.any()


def test_supports_fused_cde_is_exactly_the_kernel_modes():
    fields = {"final_tanh": FinalTanh(3, H, HH, 2),
              "single": SingleHiddenLayer(3, H, HH),
              "gruode": GRUODEField(3, H)}
    for method in ("euler", "midpoint", "heun", "rk2", "rk4", "dopri5",
                   "srk"):
        for name, f in fields.items():
            want = name != "gruode" and method in fc.FUSED_CDE_METHODS
            assert fc.supports_fused_cde(f, method) == want, (name, method)
    assert fc.FUSED_CDE_METHODS == set(fc._METHOD_CODE)
    with pytest.raises(ValueError, match="fused CDE kernels take"):
        fc.fused_cde_inputs(fields["gruode"], None, np.arange(3.0),
                            torch.zeros(2, H))


@pytest.mark.parametrize("kind,C,width,hwidth", [
    ("final_tanh", 8, 512, 256), ("final_tanh", 16, 256, 256),
    ("single", 32, 128, 128), ("final_tanh", 6, 128, 128)])
def test_supports_fused_cde_takes_every_width_the_jax_gate_takes(
        kind, C, width, hwidth):
    """Fields at the JAX gate's edges (H*C = 4096, H = 512, Wout at its
    4 MB cap) are taken by both gates, and the kernel's input checks take
    their shapes: no width sends a field the JAX package fuses to the
    eager solver, or raises before the launch."""
    from snsde.kernels.fused_cde import supports_fused_cde as jax_supports

    jf, tf = _fields(kind, C, 1, width=width, hwidth=hwidth)
    assert jax_supports(jf, "rk4") and fc.supports_fused_cde(tf, "rk4")
    n_inner = 1 if kind == "final_tanh" else 0
    inputs, flags, gys = _kernel_inputs("rk4", "relu", n_inner, Bk=2, M=1,
                                        Hk=width, HHk=hwidth, C=C)
    assert fc.check_kernel_inputs(**inputs, **flags, ys=gys, gys=gys) == (
        1, 2, width, hwidth, C, n_inner)


def test_kernel_input_checks():
    inputs, flags, gys = _kernel_inputs("rk4", "relu", 1)
    assert fc.check_kernel_inputs(**inputs, **flags) == (5, 6, 4, 5, 3, 1)
    with pytest.raises(ValueError, match="float32 only"):
        fc.check_kernel_inputs(**{**inputs, "bin": inputs["bin"].double()},
                               **flags)
    with pytest.raises(ValueError, match="expected"):
        fc.check_kernel_inputs(**{**inputs, "wout": inputs["wout"][:, :5]},
                               **flags)
    with pytest.raises(ValueError, match="expected"):
        fc.check_kernel_inputs(**inputs, **{**flags, "method": "euler"})
    with pytest.raises(ValueError, match="not contiguous"):
        fc.check_kernel_inputs(**{**inputs, "wout": inputs["wout"].t()
                                  .contiguous().t()}, **flags)
    with pytest.raises(ValueError, match="methods"):
        fc.check_kernel_inputs(**inputs, method="dopri5", act="relu")


def test_wrapper_raises_on_a_device_without_the_kernel(tmp_path,
                                                      monkeypatch):
    """CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back, and so does a machine that cannot
    build the kernels."""
    inputs, flags, gys = _kernel_inputs("rk4", "relu", 1)
    meta = {k: v.to("meta") for k, v in inputs.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.fused_cde_forward(**meta, **flags)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc.fused_cde_backward(ys=gys.to("meta"), gys=gys.to("meta"), **meta,
                              **flags)
    from snsde_torch.kernels import _build
    from snsde_torch.kernels._solver import SolverLib

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    lib = SolverLib("fused_cde", "fused CDE", 10, 19,
                    int_names=fc._LIB.int_names,
                    shape_names=fc._LIB.shape_names)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.kept("max_smem")
