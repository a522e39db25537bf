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
from snsde_torch.kernels._solver import MAX_WIDTH, MULT_Y_NO, PRECOMP_NO
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


@pytest.fixture(scope="module")
def setting():
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    y0 = rng.normal(size=(B, H)).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    dts = np.diff(grid)[:, None, None]
    dW = rng.normal(size=(len(grid) - 1, B, H)) * np.sqrt(dts)
    I10 = 0.5 * dts * (dW + rng.normal(size=dW.shape) * np.sqrt(dts / 3.0))
    return times, x, y0, grid, dW.astype(np.float32), I10.astype(np.float32)


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
    from snsde.kernels.fused_srk import fused_srk_solve as jax_solve

    times, x, y0, _, dW, I10 = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    dt = resolve_dt(times)

    def jax_loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy,
                       jax.random.PRNGKey(0), dt=dt,
                       brownian_override=(jnp.asarray(dW), jnp.asarray(I10)))
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
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
        assert err < 5e-4, f"({io},{no}) grad {name}: rel err {err:.2e}"


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
    ys = fs.fused_srk_forward_reference(**leaves, **flags)
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


def test_zero_step_is_identity():
    """dt = 0 steps (guarded 1/dt and 1/sqrt(dt)) leave y exactly as it
    was, forward and backward: dy0 is exactly the summed cotangent."""
    inputs, flags, gys = _kernel_inputs(4, 17, 1, dt=0.0)
    inputs["dw"] = torch.zeros_like(inputs["dw"])
    inputs["i10"] = torch.zeros_like(inputs["i10"])
    ys = fs.fused_srk_forward(**inputs, **flags)
    assert torch.equal(ys, inputs["y0"].expand_as(ys))
    grads = fs.fused_srk_backward(ys=ys, gys=gys, **inputs, **flags)
    torch.testing.assert_close(grads.dy0, gys.sum(0), rtol=0, atol=1e-6)
    assert not grads.dwy.any() and not grads.dtheta.any()


def test_supports_fused_srk_is_exactly_the_kernel_modes():
    take = {(io, no) for io in range(7) for no in range(20)
            if fs.supports_fused_srk(DiffusionField(C, H, H, 1,
                                                    input_option=io,
                                                    noise_option=no))}
    assert take == set(SUPPORTED)
    with pytest.raises(ValueError, match="fused SRK kernels take"):
        fs.fused_srk_inputs(DiffusionField(C, H, H, 1, input_option=1,
                                           noise_option=18),
                            None, np.arange(3.0), torch.zeros(2, H),
                            torch.zeros(2, 2, H), torch.zeros(2, 2, H))


def test_kernel_input_checks_name_the_limit():
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
    wide = torch.zeros(4, MAX_WIDTH + 1)
    with pytest.raises(ValueError, match=f"up to {MAX_WIDTH}"):
        fs.check_kernel_inputs(**{**inputs, "wy": wide})


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
