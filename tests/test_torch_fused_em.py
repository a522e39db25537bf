"""snsde_torch.kernels.fused_em against the JAX package's fused EM kernel.

The JAX kernel runs in Pallas interpret mode on the CPU (as
tests/test_fused_grid.py runs it); the port runs its plain PyTorch
versions, which is what its wrapper takes for CPU tensors. Both sides get
the same weights (through snsde_torch.convert), the same control path and
the same Brownian increments, drawn with numpy. The CUDA kernels
themselves are compared with the plain versions on the card by
chip_smoke.py and by tests/test_torch_cuda.py.
"""

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
from snsde_torch.kernels._solver import MAX_WIDTH, MULT_Y_NO, PRECOMP_NO
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


@pytest.fixture(scope="module")
def setting():
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    y0 = rng.normal(size=(B, H)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dW = (rng.normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    return times, x, y0, dW


def port_field(jfield, io, no, layers):
    field = DiffusionField(C, H, H, layers, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    return field


@pytest.mark.parametrize("io,no", [(4, 17), (2, 16), (6, 17)])
def test_fused_em_matches_jax_kernel(setting, io, no):
    """Trajectory to atol 2e-5 and every parameter gradient (and y0's) to
    5e-4 relative: the bar tests/test_fused_grid.py holds the JAX kernel to
    against its scan; the two sides merge the drift the same way and
    differ only in f32 summation order."""
    from snsde.kernels.fused_em import fused_em_solve as jax_solve

    times, x, y0, dW = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    dt = resolve_dt(times)
    key = jax.random.PRNGKey(0)

    def jax_loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy, key, dt=dt,
                       dW_override=jnp.asarray(dW))
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = port_field(jfield, io, no, 2)
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
    ys = fe.fused_em_forward_reference(**leaves, **flags)
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
    take = {(io, no) for io in range(7) for no in range(20)
            if fe.supports_fused(DiffusionField(C, H, H, 1, input_option=io,
                                                noise_option=no))}
    assert take == set(SUPPORTED)
    assert not fe.supports_fused(object())
    with pytest.raises(ValueError, match="fused EM kernels take"):
        fe.fused_em_inputs(DiffusionField(C, H, H, 1, input_option=1,
                                          noise_option=18),
                           None, np.arange(3.0), torch.zeros(2, H),
                           torch.zeros(2, 2, H))


def test_kernel_input_checks_name_the_limit():
    inputs, flags, gys = _kernel_inputs(4, 17, 1)
    assert fe.check_kernel_inputs(**inputs) == (5, 6, 4, 4, 1)
    with pytest.raises(ValueError, match="float32 only"):
        fe.check_kernel_inputs(**{**inputs, "xh": inputs["xh"].double()})
    with pytest.raises(ValueError, match="expected"):
        fe.check_kernel_inputs(**{**inputs, "a": inputs["a"][:, :3]})
    with pytest.raises(ValueError, match="not contiguous"):
        fe.check_kernel_inputs(**{**inputs,
                                  "wout": inputs["wout"].t()})
    wide = torch.zeros(4, MAX_WIDTH + 1)
    with pytest.raises(ValueError, match=f"up to {MAX_WIDTH}"):
        fe.check_kernel_inputs(**{**inputs, "wy": wide})


def test_wrapper_raises_on_a_device_without_the_kernel():
    """CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back."""
    inputs, flags, _ = _kernel_inputs(4, 17, 1)
    meta = {k: v.to("meta") for k, v in inputs.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        fe.fused_em_forward(**meta, **flags)
