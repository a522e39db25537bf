"""snsde_torch.kernels.multi (the member axis of the EM and SRK pairs)
against the JAX package's packed solves, and against the port's own solo
solves.

The JAX packed solves (snsde/kernels/multi.py) pack K members into the
lane axis with block-diagonal weights and run the fused Pallas kernels in
interpret mode on the CPU; the port runs its plain PyTorch versions of
the member-axis kernels, which its wrappers take for CPU tensors. Both
sides get the same weights (snsde_torch.convert), the same control paths
and the same Brownian increments: the JAX side draws each member's from
its key inside the packed solve, and the test draws the same ones with
the JAX package's own sampler and injects them into the port. The CUDA
kernels' member axis is held to the solo launch, bit for bit, by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: trajectories within 5e-6 of max|ys|, every gradient within
1e-4 of its largest entry.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.fields import DiffusionField as JaxField
from snsde.nn.core import filter_value_and_grad
from snsde.ops.brownian import brownian_increments as jax_dw
from snsde.ops.brownian import space_time_levy_area as jax_levy
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.ops.solve import make_grid as jax_make_grid

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels import fused_srk as fs
from snsde_torch.kernels import multi
from snsde_torch.models.neuralcde import FinalTanh
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs

K, B, L, C, H = 3, 8, 6, 3, 8
TOL_YS, TOL_GRAD = 5e-6, 1e-4


def jax_arrays(tree):
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


def _data(n_paths):
    rng = np.random.default_rng(3)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    xs = [rng.normal(size=(B, L, C)).astype(np.float32)
          for _ in range(n_paths)]
    y0s = (0.5 * rng.normal(size=(K, B, H))).astype(np.float32)
    return times, xs, y0s


def _noise(keys, grid, srk):
    """Each member's increments as the JAX packed solve draws them."""
    dws, i10s = [], []
    for k in keys:
        kw, ku = jax.random.split(k)
        dw = jax_dw(kw, grid, (B, H), jnp.float32)
        dws.append(np.asarray(dw))
        if srk:
            i10s.append(np.asarray(jax_levy(ku, grid, (B, H), dw,
                                            jnp.float32)))
    return np.stack(dws), (np.stack(i10s) if srk else None)


def _check(srk, io, no, per_member_paths):
    from snsde.kernels.multi import (fused_em_solve_packed as jax_em,
                                     fused_srk_solve_packed as jax_srk)

    times, xs, y0s = _data(K if per_member_paths else 1)
    jpaths = [JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
              for x in xs]
    jfields = [JaxField.create(jax.random.PRNGKey(10 * k + io), C, H, H, 2,
                               input_option=io, noise_option=no)
               for k in range(K)]
    keys = list(jax.random.split(jax.random.PRNGKey(7), K))
    dt = resolve_dt(times)
    grid, _ = jax_make_grid(times, dt)
    dW, I10 = _noise(keys, grid, srk)
    member_paths = jpaths if per_member_paths else None

    def jax_loss(tree):
        flds, yy = tree
        fn = jax_srk if srk else jax_em
        ys = fn(list(flds), jpaths[0], times, yy, keys, dt=dt,
                paths=member_paths)
        return jnp.mean(ys ** 2), ys

    (_, ys_j), g_j = filter_value_and_grad(jax_loss, has_aux=True)(
        (tuple(jfields), jnp.asarray(y0s)))

    fields = []
    for jf in jfields:
        f = DiffusionField(C, H, H, 2, input_option=io, noise_option=no)
        load_jax_arrays(f, jax_arrays(jf))
        fields.append(f)
    paths = [CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                            torch.as_tensor(x)), times)
             for x in xs]
    y0_t = torch.as_tensor(y0s).requires_grad_(True)
    noise = ((torch.as_tensor(dW), torch.as_tensor(I10)) if srk
             else torch.as_tensor(dW))
    solve = (multi.fused_srk_solve_packed if srk
             else multi.fused_em_solve_packed)
    ys_t = solve(fields, paths[0], times, y0_t, noise, dt=dt,
                 paths=paths if per_member_paths else None)
    (ys_t ** 2).mean().backward()

    ref = np.asarray(ys_j)
    err = np.abs(ys_t.detach().numpy() - ref).max() / np.abs(ref).max()
    assert err < TOL_YS, f"ys: {err:.2e} of max|ys|"
    for k in range(K):
        ours = grads_to_jax_layout(fields[k])
        for name, g in jax_arrays(g_j[0][k]).items():
            rel = (np.abs(ours[name] - g).max()
                   / max(np.abs(g).max(), 1e-6))
            assert rel < TOL_GRAD, f"member {k} {name}: {rel:.2e}"
    g_y0 = np.asarray(g_j[1])
    rel = np.abs(y0_t.grad.numpy() - g_y0).max() / np.abs(g_y0).max()
    assert rel < TOL_GRAD, f"y0s: {rel:.2e}"
    return fields, paths, times, y0s, noise, ys_t.detach()


@pytest.mark.parametrize("per_member_paths", [False, True])
@pytest.mark.parametrize("io,no", [(4, 17), (1, 18)])
def test_em_packed_matches_jax_packed_solve(io, no, per_member_paths):
    """fused_em_solve_packed's plain versions against JAX's lane-packed
    solve: one shared control path and one path a member."""
    _check(False, io, no, per_member_paths)


@pytest.mark.parametrize("per_member_paths", [False, True])
@pytest.mark.parametrize("io,no", [(4, 17), (3, 15)])
def test_srk_packed_matches_jax_packed_solve(io, no, per_member_paths):
    """fused_srk_solve_packed's plain versions against JAX's lane-packed
    SRIW1 solve: one shared control path and one path a member."""
    _check(True, io, no, per_member_paths)


@pytest.mark.parametrize("srk", [False, True])
def test_member_equals_the_solo_solve_exactly(srk):
    """Member k of a packed solve is the solo solve of member k's field on
    its path with the same increments, bit for bit (on the CPU the plain
    versions run member by member), and drawing from K generators gives
    each member what its solo solve draws from that generator."""
    times, xs, y0s = _data(K)
    fields = [DiffusionField(C, H, H, 2, input_option=4, noise_option=17,
                             generator=torch.Generator().manual_seed(k))
              for k in range(K)]
    paths = [CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                            torch.as_tensor(x)), times)
             for x in xs]
    y0 = torch.as_tensor(y0s)
    packed = (multi.fused_srk_solve_packed if srk
              else multi.fused_em_solve_packed)
    solo = fs.fused_srk_solve if srk else fe.fused_em_solve
    gens = [torch.Generator().manual_seed(100 + k) for k in range(K)]
    ys = packed(fields, paths[0], times, y0, gens, paths=paths)
    for k in range(K):
        ref = solo(fields[k].bind(paths[k]), paths[k], times, y0[k],
                   generator=torch.Generator().manual_seed(100 + k),
                   dt=resolve_dt(times))
        assert torch.equal(ys[k], ref), k


@pytest.mark.parametrize("srk", [False, True])
def test_control_streams_take_the_member_axis(srk):
    """Every member's control streams are its own (made from its own
    weights): a packed launch's xh and a (the SRK's xh0, xh1, a0, a1) take
    the member axis, and a stream given without it is refused by the
    kernels' input checks, as every other tensor of the wrong shape."""
    mod = fs if srk else fe
    rng = np.random.default_rng(0)
    M = 4
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    per = dict(y0=t(K, B, H), dw=t(K, M, B, H), theta=t(K, 1),
               wy=t(K, H, H), w_inner=t(K, 1, H, H), b_inner=t(K, 1, H),
               wout=t(K, H, H), bo=t(K, H), dts=torch.full((M,), 0.5))
    if srk:
        per.update(i10=t(K, M, B, H), gk0=t(K, M, H), gk1=t(K, M, H),
                   gk2=t(K, M, H))
        control = dict(xh0=t(K, M, B, H), xh1=t(K, M, B, H), a0=t(K, M, H),
                       a1=t(K, M, H))
    else:
        per.update(gk=t(K, M, H))
        control = dict(xh=t(K, M, B, H), a=t(K, M, H))
    assert mod.check_kernel_inputs(**per, **control) == (M, B, H, H, 1)
    for name, v in control.items():
        with pytest.raises(ValueError, match=f"{name} has shape"):
            mod.check_kernel_inputs(**per, **{**control, name: v[0]})


def test_packing_needs_one_configuration():
    """Members of different configurations raise, as pack_fields does."""
    a = DiffusionField(C, H, H, 2, input_option=4, noise_option=17)
    b = DiffusionField(C, H, H, 2, input_option=4, noise_option=16)
    c = DiffusionField(C, H, H, 1, input_option=4, noise_option=17)
    for other in (b, c):
        with pytest.raises(ValueError, match="identically-configured"):
            multi.check_same_config([a, other])


def test_cde_packed_solve_is_each_member_solved_alone():
    """fused_cde_solve_packed: one solo CDE solve a member, stacked."""
    from snsde_torch.kernels.fused_cde import fused_cde_solve

    times, xs, _ = _data(K)
    funcs = [FinalTanh(C, H, H, 2, generator=torch.Generator().manual_seed(k))
             for k in range(K)]
    paths = [CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                            torch.as_tensor(x)), times)
             for x in xs]
    z0s = torch.randn(K, B, H, generator=torch.Generator().manual_seed(1))
    dt = resolve_dt(times, floor=0.0)
    zs = multi.fused_cde_solve_packed(funcs, paths[0], times, z0s, dt=dt,
                                      paths=paths)
    for k in range(K):
        assert torch.equal(zs[k], fused_cde_solve(funcs[k], paths[k], times,
                                                  z0s[k], dt=dt))
