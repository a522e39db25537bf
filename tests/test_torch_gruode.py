"""The GRU-ODE field on the CDE kernels, the CDE pair's member axis and
the packed latent solve, port against the JAX package, on the CPU.

The port's plain versions of the CDE kernels' gruode kind (what its
wrappers take for CPU tensors) against JAX `fused_cde_solve` on a
GRUODEField in Pallas interpret mode, on every tableau, on the same
control-derivative stream: the trajectory, dz0, ddx and the six gate
gradients; the plain backward against autograd of the plain forward;
`GRUODEField` through the port's `fused_cde_solve` against JAX `cdeint`
and the port's eager `cdeint`; a `gru-ode` ISTSClassifier carried from
JAX by snsde_torch.convert (logits, loss and every gradient, through the
eager solve and through the fused solve's autograd.Function);
`fused_cde_solve_packed` (FinalTanh and GRU-ODE members, one control path
each) against JAX's lane-packed `fused_cde_solve_packed` in interpret
mode and each member against its solo solve; and
`fused_latent_em_solve_packed` against each member's solo
`fused_latent_em_solve` and against the JAX package's augmented sdeint on
the same injected increments. The CUDA instances themselves are held to
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: the GRU-ODE field's trajectories 3e-5 and its gradients 2e-4
relative with 2e-5 absolute (the JAX package's own bar for this kind,
tests/test_fused_cde.py: its z feedback through three gates amplifies
float32 rounding), each absolute bar taken of max(1, the largest entry)
(its states reach O(100) and its gradients O(1000) on these controls);
FinalTanh members 1e-5 and their gradients 1e-4 relative with 1e-6
absolute, on the same scale; the
classifier's
loss 1e-5 relative and its gradients 1e-4 of their largest entry; a packed
member on the CPU is its solo solve exactly (the same plain operations);
the latent solves 1e-4 of the largest entry (the EM bar).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.harness import robustness as jrob
from snsde.models import latent_sde as jlat
from snsde.models.neuralcde import FinalTanh as JaxFinalTanh
from snsde.models.neuralcde import GRUODEField as JaxGRUODE
from snsde.models.neuralsde import resolve_dt as jax_resolve_dt
from snsde.nn.core import filter_value_and_grad
from snsde.ops import solve as jsolve
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import loop as jloop

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import synthetic_uea
from snsde_torch.harness import robustness as trob
from snsde_torch.kernels import fused_cde as fc
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels.multi import (fused_cde_solve_packed,
                                       fused_latent_em_solve_packed)
from snsde_torch.models import neuralcde as tcde
from snsde_torch.models.latent_sde import LatentSDE
from snsde_torch.models.neuralcde import FinalTanh, GRUODEField
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import CubicPath, cdeint, hermite_cubic_coeffs, make_grid
from snsde_torch.train import loop as tloop

B, L, C, H = 8, 6, 3, 5
TOL_YS, RTOL, ATOL = 3e-5, 2e-4, 2e-5
METHODS = ["euler", "midpoint", "heun", "rk4"]


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path (buffers without
    their `.value`), the key format of snsde_torch.convert."""
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


def _gru(seed=3):
    """(JAX GRUODEField, port GRUODEField) with the same weights."""
    jf = JaxGRUODE.create(jax.random.PRNGKey(seed), C, H)
    tf = GRUODEField(C, H)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


def _final_tanh(seed=3, HH=7):
    jf = JaxFinalTanh.create(jax.random.PRNGKey(seed), C, H, HH, 2)
    tf = FinalTanh(C, H, HH, 2)
    load_jax_arrays(tf, jax_arrays(jf))
    return jf, tf


def _path(seed):
    """(times, numpy series, the port's and JAX's Hermite cubic paths)."""
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    return times, x, path, jpath


def _close(ours, ref, name, rtol=RTOL, atol=ATOL):
    """ours within rtol of ref entry by entry, plus atol of max(1, ref's
    largest entry) (gradients through a state that grows to O(100) span
    four decades)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=rtol, err_msg=name,
        atol=atol * max(1.0, float(np.abs(ref).max())))


def _close_ys(ours, ref, tol=TOL_YS):
    """A trajectory within tol of max(1, its largest entry): a GRU-ODE
    state on a rough control grows to O(100) here, where float32 holds
    3e-5 absolute no better than the two packages' summation orders do."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("method", METHODS)
def test_plain_gruode_matches_jax_kernel(method):
    """The trajectory, dz0, ddx and the six gate gradients of the plain
    forward and backward against JAX `fused_cde_solve` (the gruode kind of
    its Pallas kernel and custom VJP) on the same dx stream."""
    from snsde.kernels.fused_cde import fused_cde_solve as jax_solve

    times, _, path, _ = _path(0)
    jf, tf = _gru()
    rng = np.random.default_rng(1)
    z0 = rng.normal(size=(B, H)).astype(np.float32)
    dt = 0.1
    grid, out_idx = make_grid(times, dt)
    dx = fc.fused_cde_inputs(tf, path, grid, torch.as_tensor(z0),
                             method)["dx"].detach().numpy()
    G = rng.normal(size=(L, B, H)).astype(np.float32)

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
    assert inp["act"] == "gruode" and inp["win"] is None
    ys = fc.FusedCDE.apply(z0_t, dx_t, *(inp[k] for k in fc._ARG_ORDER[2:]),
                           method, "gruode")
    zs_t = torch.cat([z0_t[None], ys])[torch.as_tensor(out_idx)]
    (zs_t * torch.as_tensor(G)).sum().backward()
    _close_ys(zs_t.detach().numpy(), zs_j)
    ours = grads_to_jax_layout(tf)
    ours["z0"], ours["dx"] = z0_t.grad.numpy(), dx_t.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["z0"], theirs["dx"] = np.asarray(g_j[1]), np.asarray(g_j[2])
    assert set(theirs) == set(ours) and len(ours) == 8
    for name, ref in theirs.items():
        _close(ours[name], ref, f"{method} {name}")


@pytest.mark.parametrize("method", METHODS)
def test_gruode_backward_reference_is_autograd_of_forward(method):
    """The plain reverse loop of the gruode kind (the backward kernel's
    twin) equals autograd of the plain forward, in float64 to 1e-10 of
    each cotangent's largest entry; the MLP's gradients are None."""
    rng = np.random.default_rng(2)
    t = lambda *s: torch.as_tensor(rng.normal(size=s))
    NT = len(fc._stage_times(method)[0])
    M = 4
    inputs = dict(z0=t(6, H), dx=t(M, 6, NT * C),
                  dts=torch.full((M,), 0.3, dtype=torch.float64),
                  win=None, bin=None, w_inner=None, b_inner=None, wout=None,
                  bout=None, wg=0.5 * t(3, H, H * C), bg=t(3, H * C))
    gys = t(M, 6, H)
    leaves = {k: v if v is None else v.clone().requires_grad_(k != "dts")
              for k, v in inputs.items()}
    ys = fc.fused_cde_forward_reference(**leaves, method=method,
                                        act="gruode")
    (ys * gys).sum().backward()
    g = fc.fused_cde_backward_reference(ys=ys.detach(), gys=gys, **inputs,
                                        method=method, act="gruode")
    for name in fc.FusedCDEGrads._fields:
        leaf, ours = leaves.get(name[1:]), getattr(g, name)
        if leaf is None:
            assert ours is None, name
            continue
        denom = max(float(leaf.grad.abs().max()), 1e-12)
        assert float((ours - leaf.grad).abs().max()) / denom < 1e-10, name


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_gruode_field_fused_solve_matches_cdeint(method):
    """GRUODEField through the port's fused_cde_solve (the autograd
    Function over the plain versions) against JAX `cdeint` and the port's
    eager `cdeint` on the same path: the trajectory to 3e-5, and the
    gradients of the fused and eager solves against each other. The
    setting of the JAX package's own test (tests/test_fused_cde.py:354:
    its path and z0 from seed 0, the field from key 4, dt = 0.09)."""
    rng = np.random.default_rng(0)
    times = np.linspace(0.0, 1.0, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    z0 = rng.normal(size=(B, H)).astype(np.float32)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jf, tf = _gru(4)
    dt = 0.09
    zs_j = jsolve.cdeint(jpath, jf, jnp.asarray(z0), times, dt=dt,
                         method=method)
    grads = []
    for fused in (True, False):
        tf.zero_grad()
        z = torch.as_tensor(z0).requires_grad_(True)
        if fused:
            zs = fc.fused_cde_solve(tf, path, times, z, dt=dt, method=method)
        else:
            zs = cdeint(path, tf, z, times, dt=dt, method=method)
        _close_ys(zs.detach().numpy(), zs_j)
        (zs ** 2).sum().backward()
        grads.append([z.grad.clone()] + [p.grad.clone()
                                         for p in tf.parameters()])
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), "fused vs eager gradient")


# the classifier: the sweep cell's shape, cut
CB, CL, CD, CHID, CK = 8, 6, 2, 5, 3


@pytest.fixture(scope="module")
def classifier_setup():
    X, y, _ = synthetic_uea(n=CB, length=CL, channels=CD, num_classes=CK,
                            seed=2)
    data = trob.preprocess_ists(X, 0.3, interpolation="natural", seed=0)
    batch = {"seq": data["seq"], "coeffs": data["coeffs"], "y": y}
    jm = jrob.ISTSClassifier.create(jax.random.PRNGKey(0), "gru-ode", CD,
                                    CL, CHID, CK)
    return jm, batch


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_gruode_classifier_matches_jax(classifier_setup, route, monkeypatch):
    """A `gru-ode` ISTSClassifier carried from JAX: the logits, the train
    loss and every gradient, through the eager cdeint (a CPU tensor's
    route) and through the fused solve's autograd.Function (the route a
    CUDA tensor takes to the gruode instances)."""
    jm, batch = classifier_setup

    def jloss(m):
        logits, _, _ = m(jnp.asarray(batch["seq"]),
                         jnp.asarray(batch["coeffs"]),
                         key=jax.random.PRNGKey(0), train=True)
        return (jloop.softmax_cross_entropy(logits, jnp.asarray(batch["y"])),
                logits)

    (loss_j, logits_j), g_j = filter_value_and_grad(jloss, has_aux=True)(jm)
    if route == "fused":
        def dispatch(path, func, z0, ts, *, dt, method, use_fused=True):
            assert isinstance(func, GRUODEField)
            return fc.fused_cde_solve(func, path, ts, z0, dt=dt,
                                      method=method)

        monkeypatch.setattr(tcde, "cde_solve_dispatch", dispatch)
    model = trob.ISTSClassifier("gru-ode", CD, CL, CHID, CK)
    load_jax_arrays(model, jax_arrays(jm))
    model.train()
    logits = model(torch.as_tensor(batch["seq"]),
                   torch.as_tensor(batch["coeffs"]))
    loss = tloop.softmax_cross_entropy(logits,
                                       torch.as_tensor(batch["y"]).long())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
    assert set(ours) == set(theirs)
    assert any(k.endswith("W_r.weight") for k in ours)
    for name, ref in theirs.items():
        floor = 1e-7 if name == "layer.inner.linear.bias" else 0.0
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + floor, (
            f"{route} grad {name}: abs err {err:.2e}")


@pytest.mark.parametrize("kind", ["final_tanh", "gruode"])
def test_packed_cde_solve_matches_jax_and_each_solo_solve(kind):
    """Three members, each with its own weights, z0 and control path:
    `fused_cde_solve_packed` against JAX's lane-packed
    `fused_cde_solve_packed` (interpret mode) — the trajectories and the
    gradients of every member's weights and of z0s — and each member
    exactly its solo `fused_cde_solve`."""
    from snsde.kernels.multi import fused_cde_solve_packed as jax_packed

    K, method = 3, "rk4"
    make = _gru if kind == "gruode" else _final_tanh
    pairs = [make(seed=10 + k) for k in range(K)]
    paths = [_path(20 + k) for k in range(K)]
    times = paths[0][0]
    rng = np.random.default_rng(7)
    z0s = rng.normal(size=(K, B, H)).astype(np.float32)
    G = rng.normal(size=(K, L, B, H)).astype(np.float32)
    dt = float(jax_resolve_dt(times, floor=0.0))

    def jloss(tree):
        funcs, zz = tree
        zs = jax_packed(list(funcs), paths[0][3], times, zz, dt=dt,
                        method=method, paths=[p[3] for p in paths])
        return jnp.sum(zs * G), zs

    (_, zs_j), g_j = filter_value_and_grad(jloss, has_aux=True)(
        (tuple(p[0] for p in pairs), jnp.asarray(z0s)))
    funcs = [p[1] for p in pairs]
    z = torch.as_tensor(z0s).requires_grad_(True)
    zs = fused_cde_solve_packed(funcs, None, times, z, dt=dt, method=method,
                                paths=[p[2] for p in paths])
    (zs * torch.as_tensor(G)).sum().backward()
    ys_tol, rtol, atol = ((TOL_YS, RTOL, ATOL) if kind == "gruode"
                          else (1e-5, 1e-4, 1e-6))
    _close_ys(zs.detach().numpy(), zs_j, ys_tol)
    _close(z.grad.numpy(), np.asarray(g_j[1]), "z0s", rtol, atol)
    for k, f in enumerate(funcs):
        theirs = jax_arrays(g_j[0][k])
        ours = grads_to_jax_layout(f)
        assert set(ours) == set(theirs)
        for name, ref in theirs.items():
            _close(ours[name], ref, f"member {k} {name}", rtol, atol)
    with torch.no_grad():
        for k, f in enumerate(funcs):
            solo = fc.fused_cde_solve(f, paths[k][2], times, z[k], dt=dt,
                                      method=method)
            assert torch.equal(zs[k], solo), k


def test_packed_cde_solve_takes_one_configuration():
    times, _, path, _ = _path(0)
    z0s = torch.zeros(2, B, H)
    with pytest.raises(ValueError, match="identically"):
        fused_cde_solve_packed([GRUODEField(C, H), FinalTanh(C, H, 7, 2)],
                               path, times, z0s)
    with pytest.raises(ValueError, match="identically"):
        fused_cde_solve_packed([FinalTanh(C, H, 7, 2), FinalTanh(C, H, 7, 3)],
                               path, times, z0s)
    with pytest.raises(ValueError, match="one z0"):
        fused_cde_solve_packed([GRUODEField(C, H)] * 3, path, times, z0s)


# the latent members: the sweep's latent classifier, cut
LB, LL, LC, LH, LHH = 8, 7, 3, 6, 5


def _latent(seed):
    jm = jlat.LatentSDE.create(jax.random.PRNGKey(seed), LC, LH, LHH, 2,
                               sigma=0.5, method="euler")
    tm = LatentSDE(LC, LH, LHH, 2, sigma=0.5, method="euler")
    load_jax_arrays(tm, jax_arrays(jm))
    return jm, tm


def test_packed_latent_solve_matches_solo_solves_and_jax():
    """Three LatentSDE members on injected increments: every member of
    `fused_latent_em_solve_packed` exactly its solo
    `fused_latent_em_solve` (trajectory, KL lane included, and the
    gradients of its parameters and aug0), and within 1e-4 of the JAX
    package's augmented sdeint(f_aug, g_aug) on the same increments."""
    K = 3
    times = np.linspace(0.0, 1.0, LL).astype(np.float32)
    grid, _ = make_grid(times, resolve_dt(times))
    rng = np.random.default_rng(11)
    dW = (rng.normal(size=(K, len(grid) - 1, LB, LH))
          * np.sqrt(np.diff(grid))[None, :, None, None]).astype(np.float32)
    aug0 = np.concatenate([rng.normal(size=(K, LB, LH - 1)),
                           np.zeros((K, LB, 1))], -1).astype(np.float32)
    pairs = [_latent(30 + k) for k in range(K)]
    models = [p[1] for p in pairs]
    dt = float(resolve_dt(times))
    a0 = torch.as_tensor(aug0).requires_grad_(True)
    ys = fused_latent_em_solve_packed(models, times, a0,
                                      torch.as_tensor(dW), dt=dt)
    loss = lambda y: (y[..., -1, :, :-1] ** 2).sum() + y[..., -1].sum()
    loss(ys).backward()
    packed_grads = [[p.grad.clone() for p in m.parameters()
                     if p.grad is not None] for m in models]
    for k, (jm, tm) in enumerate(pairs):
        tm.zero_grad()
        a0k = torch.as_tensor(aug0[k]).requires_grad_(True)
        solo = fe.fused_latent_em_solve(tm, times, a0k, dt=dt,
                                        dW=torch.as_tensor(dW[k]))
        loss(solo).backward()
        assert torch.equal(ys[k].detach(), solo.detach()), k
        assert torch.equal(a0.grad[k], a0k.grad), k
        solo_grads = [p.grad for p in tm.parameters() if p.grad is not None]
        assert len(solo_grads) == len(packed_grads[k]) > 0
        for a, b in zip(packed_grads[k], solo_grads):
            assert torch.equal(a, b), k
        jbm = JaxBrownianGrid(grid=jnp.asarray(grid), dW=jnp.asarray(dW[k]),
                              U=None)
        ys_j = jsolve.sdeint(jm.f_aug, jm.g_aug, jnp.asarray(aug0[k]), times,
                             bm=jbm, dt=dt, method="euler")
        ref = np.asarray(ys_j)
        err = float(np.abs(ys[k].detach().numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), (k, err)


def test_packed_latent_solve_draws_each_members_increments():
    """With generators, member i draws exactly what the solo solve draws
    from generator i (and the packed solve checks its members)."""
    K = 2
    times = np.linspace(0.0, 1.0, LL).astype(np.float32)
    models = [_latent(40 + k)[1] for k in range(K)]
    aug0 = torch.zeros(K, LB, LH)
    aug0[..., :-1] = torch.randn(K, LB, LH - 1,
                                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ys = fused_latent_em_solve_packed(
            models, times, aug0,
            [torch.Generator().manual_seed(5 + k) for k in range(K)])
        for k in range(K):
            solo = fe.fused_latent_em_solve(
                models[k], times, aug0[k],
                generator=torch.Generator().manual_seed(5 + k))
            assert torch.equal(ys[k], solo), k
    with pytest.raises(ValueError, match="one aug0"):
        fused_latent_em_solve_packed(models, times, aug0,
                                     [torch.Generator()])
    other = LatentSDE(LC, LH, LHH, 3, sigma=0.5, method="euler")
    with pytest.raises(ValueError, match="identically"):
        fused_latent_em_solve_packed([models[0], other], times, aug0,
                                     [torch.Generator()] * 2)
