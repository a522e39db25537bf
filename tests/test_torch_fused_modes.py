"""The fused EM and SRK pairs' drift modes 'yy' and 'xt' and noise modes
'elem', 'net1' and 'net2' (snsde_torch.kernels) against the JAX package's
fused kernels and against the port's eager sdeint.

The JAX kernels run in Pallas interpret mode on the CPU (as
tests/test_fused_grid.py and tests/test_fused_srk.py run them); the port
runs its plain PyTorch versions, which is what its wrappers take for CPU
tensors, with the backward in the form the card runs it (the recurrence's
plain version, then the weight-gradient kernel's on its streams). Both
sides get the same weights (through snsde_torch.convert), the same control
path and the same numpy-drawn Brownian increments (and, for srk, Lévy
areas). The CUDA kernels are compared with the plain versions on the card
by chip_smoke.py and tests/test_torch_cuda.py.
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
from snsde_torch.kernels import _solver
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels import fused_srk as fs
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import (BrownianGrid, CubicPath, hermite_cubic_coeffs,
                             make_grid, sdeint)

from test_torch_fused_em import _split_backward as em_split
from test_torch_fused_em import jax_arrays
from test_torch_fused_srk import _split_backward as srk_split

B, L, C, H = 8, 6, 3, 5

# every drift mode with every new noise mode at least once: (0,7) and (6,7)
# with negative states, mult_y on (3,15), (5,19) and off, geometric (io 5,
# 6) on and off
CONFIGS = [(0, 7), (1, 8), (3, 9), (5, 10), (0, 14), (3, 15), (1, 18),
           (5, 19), (6, 7), (4, 14), (2, 19)]


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


def _solve_port(pair, field, path, times, y0, dW, I10, dt):
    if pair == "em":
        return fe.fused_em_solve(field.bind(path), path, times, y0, dt=dt,
                                 dW_override=torch.as_tensor(dW))
    return fs.fused_srk_solve(field.bind(path), path, times, y0, dt=dt,
                              brownian_override=(torch.as_tensor(dW),
                                                 torch.as_tensor(I10)))


@pytest.mark.parametrize("pair", ["em", "srk"])
@pytest.mark.parametrize("io,no", CONFIGS)
def test_modes_match_jax_kernels(monkeypatch, setting, pair, io, no):
    """The port's fused solve, its backward as the card runs it (the
    recurrence's plain version, then the weight gradient's on its
    streams), against the JAX fused kernel of the pair on the same
    weights, path and Brownian draws: the trajectory to atol 2e-5 and y0's
    and every parameter's gradient to 5e-4 of its largest entry, the bar
    tests/test_torch_fused_em.py and test_torch_fused_srk.py hold the
    'embm' + 'precomp' modes to (the two sides differ only in float32
    summation order)."""
    from snsde.kernels.fused_em import fused_em_solve as jax_em
    from snsde.kernels.fused_srk import fused_srk_solve as jax_srk

    if pair == "em":
        monkeypatch.setattr(fe, "fused_em_backward_reference", em_split)
    else:
        monkeypatch.setattr(fs, "fused_srk_backward_reference", srk_split)
    times, x, y0, _, dW, I10 = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, H, H, 2,
                             input_option=io, noise_option=no)
    dt = resolve_dt(times)

    def jax_loss(tree):
        fld, yy = tree
        if pair == "em":
            ys = jax_em(fld.bind(jpath), jpath, times, yy,
                        jax.random.PRNGKey(0), dt=dt,
                        dW_override=jnp.asarray(dW))
        else:
            ys = jax_srk(fld.bind(jpath), jpath, times, yy,
                         jax.random.PRNGKey(0), dt=dt,
                         brownian_override=(jnp.asarray(dW),
                                            jnp.asarray(I10)))
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))

    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    path = port_path(times, x)
    y0_t = torch.as_tensor(y0).requires_grad_(True)
    ys_t = _solve_port(pair, field, path, times, y0_t, dW, I10, dt)
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
        assert err < 5e-4, f"{pair} ({io},{no}) grad {name}: rel err {err:.2e}"


@pytest.mark.parametrize("pair", ["em", "srk"])
@pytest.mark.parametrize("io,no", CONFIGS)
def test_modes_match_eager_solver(setting, pair, io, no):
    """The fused solve (plain versions on the CPU) against the port's eager
    sdeint on the same Brownian draws: the trajectory to atol 2e-5 and
    every parameter's and y0's gradient to 1e-4 of its largest entry (the
    srk pair's bar in test_torch_fused_srk.py). For sqrt (noise_option 7)
    the states are kept positive (y0 shifted by 4: the drift moves a state
    by at most 1 over [0, 1] and these draws by less than 3): the eager
    field's gradient is NaN at a negative state (nan_to_num's backward),
    where the kernels, as the JAX kernels, take it as 0 (the JAX comparison
    above covers negative states)."""
    times, x, y0, grid, dW, I10 = setting
    if no == 7:
        y0 = np.abs(y0) + 4.0
    gen = torch.Generator().manual_seed(io * 20 + no)
    field = DiffusionField(C, H, H, 2, input_option=io, noise_option=no,
                           generator=gen)
    path = port_path(times, x)
    field.bind(path)
    method = "euler" if pair == "em" else "srk"

    def run(fused):
        field.zero_grad(set_to_none=True)
        yy = torch.as_tensor(y0).requires_grad_(True)
        if fused:
            ys = _solve_port(pair, field, path, times, yy, dW, I10,
                             resolve_dt(times))
        else:
            bm = BrownianGrid(grid, torch.as_tensor(dW),
                              torch.as_tensor(I10) if pair == "srk"
                              else None)
            ys = sdeint(field.f, field.g, yy, times, method=method, bm=bm)
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
        assert err < 1e-4, f"{pair} ({io},{no}) grad {name}: rel err {err:.2e}"


def test_sqrt_noise_matches_the_eager_field_on_negative_and_zero_states():
    """noise_option 7's base as the kernels take it (0 where y <= 0) is the
    eager field's nan_to_num(sqrt(y)), on states with negative and zero
    entries; its derivative is 0 there and 1/(2 sqrt y) elsewhere."""
    field = DiffusionField(C, H, H, 1, input_option=1, noise_option=7)
    y = torch.tensor([[-2.0, -1e-30, 0.0, 1e-30, 4.0],
                      [0.25, -0.5, 0.0, 9.0, -3.0]])
    base = _solver.elem_base(7, y)
    torch.testing.assert_close(
        base, torch.nan_to_num(torch.sqrt(y)), rtol=0, atol=0)
    sth = torch.sigmoid(field.theta[0, 0])
    torch.testing.assert_close(field.g(0.0, y), torch.tanh(sth * base))
    deriv = _solver.elem_deriv(7, y)
    assert not deriv[y <= 0].any()
    torch.testing.assert_close(deriv[y > 0], 0.5 / torch.sqrt(y[y > 0]))


def _kernel_inputs(pair, io, no, n_inner, Bk=6, M=5, Hk=4, seed=0):
    """Random kernel inputs of a mode (None where it takes none), its flags
    and a cotangent gys; states of either sign."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    modes = _solver.sde_modes(SimpleNamespace(input_option=io,
                                              noise_option=no))
    drift, noise = modes["drift"], modes["noise"]
    xh = (lambda: t(M, Bk, Hk)) if drift != "yy" else (lambda: None)
    row = (lambda: t(M, Hk)) if drift != "xt" else (lambda: None)
    gk = (lambda: t(M, Hk)) if noise != "elem" else (lambda: None)
    w = dict(theta=t(1), wy=0.5 * t(Hk, Hk) if drift != "xt" else None,
             w_inner=0.5 * t(n_inner, Hk, Hk), b_inner=t(n_inner, Hk),
             wout=0.5 * t(Hk, Hk), bo=t(Hk),
             wn1=0.5 * t(Hk, Hk) if noise in ("net1", "net2") else None,
             wn2=0.5 * t(Hk, Hk) if noise == "net2" else None,
             bn2=t(Hk) if noise == "net2" else None)
    if pair == "em":
        inputs = dict(y0=t(Bk, Hk), xh=xh(), dw=0.3 * t(M, Bk, Hk), a=row(),
                      gk=gk(), dts=torch.full((M,), 0.5), **w)
    else:
        inputs = dict(y0=t(Bk, Hk), xh0=xh(), xh1=xh(),
                      dw=0.7 * t(M, Bk, Hk), i10=0.2 * t(M, Bk, Hk),
                      a0=row(), a1=row(), gk0=gk(), gk1=gk(), gk2=gk(),
                      dts=torch.full((M,), 0.5), **w)
    return inputs, modes, t(M, Bk, Hk)


_MODULES = {"em": (fe, em_split), "srk": (fs, srk_split)}
_NOT_DIFF = ("dw", "i10", "dts")


@pytest.mark.parametrize("pair", ["em", "srk"])
@pytest.mark.parametrize("io,no,n_inner", [(0, 7, 1), (1, 8, 0), (3, 15, 1),
                                           (5, 19, 2), (2, 14, 1),
                                           (6, 18, 0)])
def test_plain_backward_versions_are_autograd_of_forward(pair, io, no,
                                                         n_inner):
    """The plain reverse loop (the JAX `_bwd_kernel`'s twin) and the
    card's split form (the recurrence's plain version, then the weight
    gradient's) both equal torch autograd of the plain forward in float64
    to 1e-9 of each cotangent's largest entry (the three differ only in
    the order of the sums): every drift and noise mode's cotangents,
    the noise nets' weights' included."""
    mod, split = _MODULES[pair]
    inputs, modes, gys = _kernel_inputs(pair, io, no, n_inner)
    inputs = {k: None if v is None else v.double() for k, v in inputs.items()}
    gys = gys.double()
    leaves = {k: None if v is None else
              v.clone().requires_grad_(k not in _NOT_DIFF)
              for k, v in inputs.items()}
    ys, ns = getattr(mod, f"fused_{pair}_forward_reference")(**leaves,
                                                             **modes)
    (ys * gys).sum().backward()
    full = getattr(mod, f"fused_{pair}_backward_reference")(
        ys=ys.detach(), gys=gys, **inputs, **modes, ns=ns)
    got = split(ys=ys.detach(), gys=gys, **inputs, **modes, ns=ns)
    assert type(full) is type(got)
    for name in full._fields:
        leaf = leaves[name[1:]]
        if leaf is None:
            assert getattr(full, name) is None and getattr(got, name) is None
            continue
        auto = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        for ours in (getattr(full, name), getattr(got, name)):
            assert ours.shape == auto.shape, name
            if not auto.numel():
                continue
            denom = max(float(auto.abs().max()), 1e-12)
            assert float((ours - auto).abs().max()) / denom < 1e-9, name


@pytest.mark.parametrize("pair", ["em", "srk"])
def test_wrappers_raise_on_tensors_that_are_not_the_modes(pair):
    """A wrapper given a tensor its modes do not take, or missing one they
    need, raises instead of ignoring it."""
    mod = _MODULES[pair][0]
    inputs, modes, _ = _kernel_inputs(pair, 1, 18, 1)
    fwd = getattr(mod, f"fused_{pair}_forward")
    with pytest.raises(ValueError, match="wn1 missing"):
        fwd(**{**inputs, "wn1": None}, **modes)
    with pytest.raises(ValueError, match="not taken"):
        fwd(**inputs, **{**modes, "noise": "precomp"})
    with pytest.raises(ValueError, match="elem option"):
        fwd(**inputs, **{**modes, "noise": "elem", "elem": 3})


@pytest.mark.parametrize("pair", ["em", "srk"])
def test_kernel_input_check_holds_the_modes(pair):
    """The CUDA path's input check (check_kernel_inputs, device-agnostic)
    also holds the tensors to the modes in its one pass, and the modes are
    made once per distinct value."""
    from snsde_torch.kernels._solver import sde_mode

    mod = _MODULES[pair][0]
    inputs, modes, _ = _kernel_inputs(pair, 1, 18, 1)
    m = sde_mode(**modes)
    assert m is sde_mode(**modes)
    dims = mod.check_kernel_inputs(**inputs, modes=m)
    assert dims[1:3] == tuple(inputs["y0"].shape)
    with pytest.raises(ValueError, match="wn1 missing"):
        mod.check_kernel_inputs(**{**inputs, "wn1": None}, modes=m)
    with pytest.raises(ValueError, match="wn2 not taken"):
        mod.check_kernel_inputs(**inputs,
                                modes=sde_mode(**{**modes, "noise": "net1"}))


def test_solve_dispatch_sends_every_configuration_to_the_kernels(
        monkeypatch):
    """On a CUDA tensor (stood in for here: the kernels need the card),
    solve_dispatch sends every one of the 140 configurations to the EM
    kernels for euler and the SRK kernels for srk; the eager sdeint takes
    only CPU tensors, an injected Brownian grid, use_fused=False and the
    methods without a kernel."""
    from snsde_torch.models import neuralsde as nsde

    calls = []
    monkeypatch.setattr(nsde, "fused_em_solve",
                        lambda *a, **k: calls.append("em"))
    monkeypatch.setattr(nsde, "fused_srk_solve",
                        lambda *a, **k: calls.append("srk"))
    monkeypatch.setattr(nsde, "sdeint",
                        lambda *a, **k: calls.append("eager"))
    cuda_y0 = SimpleNamespace(device=torch.device("cuda"))
    for io in range(7):
        for no in range(20):
            field = DiffusionField(C, H, H, 1, input_option=io,
                                   noise_option=no)
            for method in ("euler", "srk"):
                calls.clear()
                nsde.solve_dispatch(field, None, None, cuda_y0,
                                    generator=None, dt=0.1, method=method)
                assert calls == [{"euler": "em", "srk": "srk"}[method]], (
                    io, no, method)
    field = DiffusionField(C, H, H, 1, input_option=1, noise_option=18)
    for kw in (dict(y0=torch.zeros(2, H)),
               dict(y0=cuda_y0, bm=object()),
               dict(y0=cuda_y0, use_fused=False),
               dict(y0=cuda_y0, method="milstein")):
        calls.clear()
        y0 = kw.pop("y0")
        nsde.solve_dispatch(field, None, None, y0, generator=None, dt=0.1,
                            **{"method": "euler", **kw})
        assert calls == ["eager"], kw
