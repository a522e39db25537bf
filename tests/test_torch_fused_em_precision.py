"""The fused EM pair's reduced-precision modes, port against the JAX package
on the CPU: bf16 streams (SNSDE_FUSED_STREAM, `stream_dtype=`) and bf16 or
bf16x3 operands of the in-kernel products (SNSDE_FUSED_MATMUL, `matmul=`).

The JAX kernels run in Pallas interpret mode (SNSDE_FUSED_INTERPRET=1, as
tests/test_torch_fused_em.py runs them) with the modes set through the
environment; the port runs its plain versions (what its wrappers take for
CPU tensors, and what chip_smoke.py holds the CUDA kernels against) with the
same weights (snsde_torch.convert), control path and Brownian increments,
drawn with numpy. Under bf16x3 a solve moves from exact fp32 by ~1e-5 of a
gradient's scale, below any bar a solve can hold, so the split is also held
at the level of one product. The SRK, CDE, GRU and LSTM entries resolve a
request as JAX's do (their modes: tests/test_torch_fused_{srk,cde,rnn}_
precision.py).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.fields import DiffusionField as JaxField
from snsde.models import latent_sde as jlat
from snsde.nn.core import filter_value_and_grad
from snsde.ops.interp import CubicPath as JaxPath
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.fields import DiffusionField
from snsde_torch.kernels import _solver
from snsde_torch.kernels import fused_em as fe
from snsde_torch.kernels import multi
from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan
from snsde_torch.kernels.fused_srk import fused_srk_solve
from snsde_torch.models.latent_sde import LatentSDE
from snsde_torch.models.neuralcde import FinalTanh, GRUODEField
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.nn.layers import GRUCell, LSTMCell
from snsde_torch.ops import CubicPath, hermite_cubic_coeffs, make_grid

B, L, C, W = 13, 6, 3, 16
# (operand mode, stream dtype): every reduced-precision combination
COMBOS = [("f32", "bf16"), ("bf16x3", "f32"), ("bf16x3", "bf16"),
          ("bf16", "f32"), ("bf16", "bf16")]
# (input_option, noise_option): the sepsis flagship's LNSDE, naivesde's
# noise net (net2), drift 'xt' with sqrt noise, net1, and the geometric
# drift with net2 and mult_y
MODES = [(4, 17), (1, 18), (0, 7), (2, 14), (6, 19)]
# the bars: a trajectory entry within one bf16 ulp of |ys| (2^-7 |ys|)
# plus 1e-6, every gradient within 2e-3 of its leaf's largest entry
ULP, YS_ATOL, GRAD_TOL = 2.0 ** -7, 1e-6, 2e-3


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


def _dtype(stream):
    return torch.bfloat16 if stream == "bf16" else torch.float32


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.delenv("SNSDE_FUSED_STREAM", raising=False)
    monkeypatch.delenv("SNSDE_FUSED_MATMUL", raising=False)


def _jax_modes(monkeypatch, matmul, stream):
    monkeypatch.setenv("SNSDE_FUSED_MATMUL", matmul)
    monkeypatch.setenv("SNSDE_FUSED_STREAM", stream)


def _setting(seed=0, Bn=B, Ln=L, width=W, channels=C, latent=False):
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, 1.0, Ln).astype(np.float32)
    x = rng.normal(size=(Bn, Ln, channels)).astype(np.float32)
    y0 = rng.normal(size=(Bn, width)).astype(np.float32)
    if latent:
        y0[:, -1] = 0.0                     # the KL lane starts at 0
    grid, _ = make_grid(times, resolve_dt(times))
    dW = (rng.normal(size=(len(grid) - 1, Bn, width))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    return times, x, y0, dW


def _check(ys, ys_j, ours, theirs, label):
    """The bars; the number of gradients compared."""
    ys, ys_j = np.asarray(ys, np.float64), np.asarray(ys_j, np.float64)
    over = np.abs(ys - ys_j) - (ULP * np.abs(ys_j) + YS_ATOL)
    assert over.max() <= 0, f"{label}: ys off by {over.max():.3e} past 1 ulp"
    n = 0
    for name, ref in theirs.items():
        if name not in ours or not np.abs(ref).max():
            continue
        err = float(np.abs(ours[name] - ref).max() / np.abs(ref).max())
        assert err < GRAD_TOL, f"{label} grad {name}: {err:.2e} of its max"
        n += 1
    return n


_JAX_F32 = {}


def _jax_solve(monkeypatch, io, no, matmul, stream, setting, layers=2):
    from snsde.kernels.fused_em import fused_em_solve as jax_solve

    _jax_modes(monkeypatch, matmul, stream)
    times, x, y0, dW = setting
    jpath = JaxPath(jax_hermite(jnp.asarray(times), jnp.asarray(x)), times)
    jfield = JaxField.create(jax.random.PRNGKey(io * 20 + no), C, W, W,
                             layers, input_option=io, noise_option=no)

    def loss(tree):
        fld, yy = tree
        ys = jax_solve(fld.bind(jpath), jpath, times, yy,
                       jax.random.PRNGKey(0), dt=resolve_dt(times),
                       dW_override=jnp.asarray(dW))
        return jnp.mean(ys ** 2), ys

    (_, ys), g = filter_value_and_grad(loss, has_aux=True)(
        (jfield, jnp.asarray(y0)))
    grads = jax_arrays(g[0])
    grads["y0"] = np.asarray(g[1])
    return jfield, np.asarray(ys), grads


def _port_solve(jfield, io, no, matmul, stream, setting, layers=2):
    times, x, y0, dW = setting
    field = DiffusionField(C, W, W, layers, input_option=io, noise_option=no)
    load_jax_arrays(field, jax_arrays(jfield))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    y0t = torch.as_tensor(y0).requires_grad_(True)
    ys = fe.fused_em_solve(field.bind(path), path, times, y0t,
                           dt=resolve_dt(times),
                           dW_override=torch.as_tensor(dW),
                           stream_dtype=_dtype(stream), matmul=matmul)
    (ys ** 2).mean().backward()
    grads = grads_to_jax_layout(field)
    grads["y0"] = y0t.grad.numpy()
    return ys.detach().numpy(), grads


@pytest.mark.parametrize("io,no", MODES)
@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_solve_matches_jax_kernel_in_reduced_precision(monkeypatch, matmul,
                                                       stream, io, no):
    """fused_em_solve's plain versions in the mode against the JAX kernel
    in the same mode, at B=13, 5 steps, H=HH=16, two inner layers: every
    trajectory entry within one bf16 ulp of |ys| plus 1e-6, every
    gradient (y0's too) within 2e-3 of its leaf's largest entry. Why these
    bars: both sides round the same values the same way, but their fp32
    sums differ in order, and a 1-ulp fp32 difference can flip one bf16
    rounding of a stream or an operand (a trajectory entry then moves by
    an ulp). The bars still see the mode: apart from bf16x3 operands with
    fp32 streams (~1e-5 from exact, held by the product test below), JAX's
    own result in the mode moves some gradient past the bar from its exact
    fp32 result."""
    setting = _setting()
    key = (io, no)
    if key not in _JAX_F32:
        _JAX_F32[key] = _jax_solve(monkeypatch, io, no, "f32", "f32",
                                   setting)[2]
    jfield, ys_j, g_j = _jax_solve(monkeypatch, io, no, matmul, stream,
                                   setting)
    monkeypatch.delenv("SNSDE_FUSED_STREAM")
    monkeypatch.delenv("SNSDE_FUSED_MATMUL")
    ys, g = _port_solve(jfield, io, no, matmul, stream, setting)
    assert _check(ys, ys_j, g, g_j, f"({io},{no}) {matmul} {stream}") >= 6
    if (matmul, stream) != ("bf16x3", "f32"):
        gap = max(float(np.abs(g_j[k] - _JAX_F32[key][k]).max()
                        / np.abs(g_j[k]).max())
                  for k in g_j if np.abs(g_j[k]).max())
        assert gap > GRAD_TOL, f"the mode moves JAX only {gap:.2e}"


def test_environment_sets_the_modes_as_in_jax(monkeypatch):
    """With no argument the port's solve takes SNSDE_FUSED_STREAM and
    SNSDE_FUSED_MATMUL, as the JAX entry does: the same result as the
    explicit arguments, bit for bit."""
    setting = _setting(seed=3, Bn=5, Ln=4)
    times, x, y0, dW = setting
    field = DiffusionField(C, W, W, 1, input_option=4, noise_option=17,
                           generator=torch.Generator().manual_seed(0))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)

    def run(**kw):
        return fe.fused_em_solve(field.bind(path), path, times,
                                 torch.as_tensor(y0),
                                 dW_override=torch.as_tensor(dW), **kw)

    with torch.no_grad():
        explicit = run(stream_dtype=torch.bfloat16, matmul="bf16")
        exact = run()
        _jax_modes(monkeypatch, "bf16", "bf16")
        from_env = run()
    assert torch.equal(explicit, from_env)
    assert not torch.equal(exact, from_env)
    assert exact.dtype == from_env.dtype == torch.float32


@pytest.mark.parametrize("env", [None, "f32", "bf16", "bf16x3", "fp16"])
def test_resolution_is_the_jax_entrys(monkeypatch, env):
    """resolve_precision maps each value of the two variables as
    fused_em.py's _mm_mode and stream default do (anything unknown is
    exact fp32); an explicit argument wins, and an unknown one raises."""
    from snsde.kernels.fused_em import _mm_mode

    for var in ("SNSDE_FUSED_MATMUL", "SNSDE_FUSED_STREAM"):
        if env is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, env)
    sd, mm = _solver.resolve_precision()
    assert mm == {False: "f32", "x3": "bf16x3", True: "bf16"}[_mm_mode()]
    assert sd == (torch.bfloat16 if env == "bf16" else torch.float32)
    assert _solver.resolve_precision(torch.float32, "bf16x3") == (
        torch.float32, "bf16x3")
    with pytest.raises(ValueError, match="stream_dtype"):
        _solver.resolve_precision(torch.float16)
    with pytest.raises(ValueError, match="matmul"):
        _solver.resolve_precision(None, "tf32")


@pytest.mark.parametrize("matmul", ["f32", "bf16x3", "bf16"])
def test_product_matches_jax_dot(matmul):
    """The plain versions' product (mm_op) against JAX's _dot on N(0,1)
    [64 x 64] operands in each operand mode: their difference is below a
    tenth of the gap from this mode's JAX product to the nearest other
    mode's, so bf16x3 is the split xh wh + xh wl + xl wh and not exact fp32
    or a single bf16 pass."""
    from snsde.kernels.fused_em import _dot

    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    w = rng.normal(size=(64, 64)).astype(np.float32)
    modes = {"f32": False, "bf16x3": "x3", "bf16": True}
    jax_out = {m: np.asarray(_dot(jnp.asarray(x), jnp.asarray(w), v),
                             np.float64) for m, v in modes.items()}
    ours = _solver.mm_op(torch.as_tensor(x), torch.as_tensor(w),
                         matmul).double().numpy()
    err = np.abs(ours - jax_out[matmul]).max()
    gap = min(np.abs(jax_out[matmul] - jax_out[m]).max()
              for m in modes if m != matmul)
    assert err < 0.1 * gap, f"{matmul}: {err:.2e} against a gap {gap:.2e}"


LATENT_H, LATENT_HH = 6, 5


@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_latent_solve_matches_jax_kernel(monkeypatch, matmul, stream):
    """fused_latent_em_solve in the mode against JAX's latent kernel in the
    same mode, at the tutorial's `*-kld` model (LatentSDE on 2 channels,
    one inner layer; here H=6 with the KL lane, HH=5, B=13): the KL rate's
    product with klm in the operand mode, the bars of the solve test, the
    loss the tutorial's ELBO shape (terminal latent squares + the KL
    lane)."""
    from snsde.kernels.fused_em import fused_latent_em_solve as jax_solve

    times, _, aug0, dW = _setting(seed=5, width=LATENT_H, latent=True)
    jm = jlat.LatentSDE.create(jax.random.PRNGKey(2), 2, LATENT_H,
                               LATENT_HH, 1, sigma=0.5, method="euler")
    tm = LatentSDE(2, LATENT_H, LATENT_HH, 1, sigma=0.5, method="euler")
    load_jax_arrays(tm, jax_arrays(jm))
    dt = resolve_dt(times)
    _jax_modes(monkeypatch, matmul, stream)

    def jloss(tree):
        m, a0 = tree
        ys = jax_solve(m, times, a0, jax.random.PRNGKey(0), dt=dt,
                       dW_override=jnp.asarray(dW))
        return jnp.sum(ys[-1, :, :-1] ** 2) + jnp.sum(ys[:, :, -1]), ys

    (_, ys_j), g_j = filter_value_and_grad(jloss, has_aux=True)(
        (jm, jnp.asarray(aug0)))
    monkeypatch.delenv("SNSDE_FUSED_STREAM")
    monkeypatch.delenv("SNSDE_FUSED_MATMUL")
    a0 = torch.as_tensor(aug0).requires_grad_(True)
    ys = fe.fused_latent_em_solve(tm, times, a0, dt=dt,
                                  dW=torch.as_tensor(dW),
                                  stream_dtype=_dtype(stream), matmul=matmul)
    (torch.sum(ys[-1, :, :-1] ** 2) + torch.sum(ys[:, :, -1])).backward()
    assert float(np.abs(np.asarray(ys_j[-1, :, -1])).max()) > 1e-3
    ours = grads_to_jax_layout(tm)
    ours["aug0"] = a0.grad.numpy()
    theirs = jax_arrays(g_j[0])
    theirs["aug0"] = np.asarray(g_j[1])
    assert _check(ys.detach().numpy(), ys_j, ours, theirs,
                  f"latent {matmul} {stream}") >= 5


def _members(K, layers=1, io=4, no=17):
    fields = [DiffusionField(C, W, W, layers, input_option=io,
                             noise_option=no,
                             generator=torch.Generator().manual_seed(k))
              for k in range(K)]
    return fields


@pytest.mark.parametrize("io,no", [(4, 17), (6, 19)])
@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_packed_members_are_their_solo_solves(matmul, stream, io, no):
    """A packed K=2 solve (fused_em_solve_packed) in the mode: each
    member's trajectory and every gradient bit for bit its solo solve's
    with the same increments."""
    times, x, y0, dW = _setting(seed=11, Bn=7)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    K = 2
    y0s = torch.as_tensor(np.stack([y0, -0.5 * y0]))
    dWs = torch.as_tensor(np.stack([dW, dW[::-1].copy()]))
    prec = dict(stream_dtype=_dtype(stream), matmul=matmul)
    fields = _members(K, io=io, no=no)
    packed = multi.fused_em_solve_packed(fields, path, times, y0s, dWs,
                                         **prec)
    (packed ** 2).sum().backward()
    got = [[p.grad.clone() for p in f.parameters() if p.grad is not None]
           for f in fields]
    for k, f in enumerate(fields):
        f.zero_grad()
        solo = fe.fused_em_solve(f.bind(path), path, times, y0s[k],
                                 dW_override=dWs[k], **prec)
        assert torch.equal(solo, packed[k].detach()), k
        (solo ** 2).sum().backward()
        want = [p.grad for p in f.parameters() if p.grad is not None]
        assert len(want) == len(got[k]) > 0
        for a, b in zip(got[k], want):
            assert torch.equal(a, b), k


def test_packed_latent_members_are_their_solo_solves():
    """fused_latent_em_solve_packed at K=2 with bf16 streams and bf16x3
    operands: each member bit for bit its solo latent solve."""
    times, _, aug0, dW = _setting(seed=12, Bn=7, width=LATENT_H, latent=True)
    models = [LatentSDE(2, LATENT_H, LATENT_HH, 1, sigma=0.5,
                        method="euler",
                        generator=torch.Generator().manual_seed(k))
              for k in range(2)]
    a0 = torch.as_tensor(np.stack([aug0, 0.5 * aug0]))
    dWs = torch.as_tensor(np.stack([dW, -dW]))
    prec = dict(stream_dtype=torch.bfloat16, matmul="bf16x3")
    with torch.no_grad():
        packed = multi.fused_latent_em_solve_packed(models, times, a0, dWs,
                                                    **prec)
        for k, m in enumerate(models):
            solo = fe.fused_latent_em_solve(m, times, a0[k], dW=dWs[k],
                                            **prec)
            assert torch.equal(solo, packed[k]), k


def test_plain_versions_keep_the_forward_carry_and_round_the_trajectory():
    """With bf16 streams the forward's carry stays float32 (only the
    written trajectory is rounded): rounding the fp32-stream run's
    trajectory (with the streams rounded beforehand) gives the bf16 run's
    bit for bit; and the backward's nets read the rounded state's
    activations, not those of the carry."""
    rng = np.random.default_rng(4)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    M, Bk, Hk = 5, 6, 8
    inputs = dict(y0=t(Bk, Hk), xh=None, dw=0.3 * t(M, Bk, Hk), a=t(M, Hk),
                  gk=t(M, Hk), dts=torch.full((M,), 0.5), theta=t(1),
                  wy=0.5 * t(Hk, Hk), w_inner=0.5 * t(1, Hk, Hk),
                  b_inner=t(1, Hk), wout=0.5 * t(Hk, Hk), bo=t(Hk),
                  wn1=0.5 * t(Hk, Hk), wn2=0.5 * t(Hk, Hk), bn2=t(Hk))
    flags = dict(mult_y=False, geometric=False, drift="yy", noise="net2")
    dw16 = inputs["dw"].to(torch.bfloat16)
    ys16, ns16 = fe.fused_em_forward_reference(
        **{**inputs, "dw": dw16}, **flags, stream="bf16")
    ys32, ns32 = fe.fused_em_forward_reference(
        **{**inputs, "dw": dw16.float()}, **flags)
    assert ys16.dtype == torch.bfloat16
    assert torch.equal(ys16, ys32.to(torch.bfloat16))
    states = torch.cat([inputs["y0"][None], ys32[:-1]])
    nb, nh = _solver.noise_base(_solver.bf16_round(states), inputs["gk"][:, None],
                                "net2", 0, inputs["wn1"], inputs["wn2"],
                                inputs["bn2"], torch.relu)
    assert torch.equal(ns16.nh, nh) and torch.equal(ns16.nb, nb)
    assert not torch.equal(ns16.nb, ns32.nb)


def _asked(monkeypatch, how):
    """A reduced precision asked as a user asks it, and the mode JAX's
    entry resolves from the same request (fused_srk.py:661-666, :703;
    fused_cde.py:650-655, :697): by the environment, SNSDE_FUSED_STREAM=
    bf16 and SNSDE_FUSED_MATMUL=bf16x3; by argument, stream_dtype=bf16 over
    SNSDE_FUSED_STREAM=f32 (the argument wins), the operands from
    SNSDE_FUSED_MATMUL=bf16 (JAX's entries take no operand argument).
    (keyword arguments of the port's call, (stream, matmul) resolved)."""
    from snsde.kernels.fused_em import _mm_mode

    if how == "argument":
        _jax_modes(monkeypatch, "bf16", "f32")
        kw, stream = dict(stream_dtype=torch.bfloat16), "bf16"
    else:
        _jax_modes(monkeypatch, "bf16x3", "bf16")
        kw, stream = {}, "bf16"
    return kw, (stream, {False: "f32", "x3": "bf16x3",
                         True: "bf16"}[_mm_mode()])


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_srk_solve_selects_the_mode_as_jax(monkeypatch, how):
    """fused_srk_solve and its packed form take a reduced precision asked
    by argument or by the environment as JAX's entry resolves it: the
    result is the explicit solve in that mode bit for bit (and parts from
    exact fp32)."""
    times, x, y0, _ = _setting(Bn=3, width=4)
    field = DiffusionField(C, 4, 4, 1, input_option=4, noise_option=17,
                           generator=torch.Generator().manual_seed(0))
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)

    def run(**kw):
        return fused_srk_solve(field.bind(path), path, times,
                               torch.as_tensor(y0),
                               generator=torch.Generator().manual_seed(0),
                               **kw)

    def packed(**kw):
        return multi.fused_srk_solve_packed(
            [field], path, times, torch.as_tensor(y0)[None],
            [torch.Generator().manual_seed(0)], **kw)[0]

    with torch.no_grad():
        kw, (stream, matmul) = _asked(monkeypatch, how)
        asked = run(**kw), packed(**kw)
        monkeypatch.delenv("SNSDE_FUSED_STREAM")
        monkeypatch.delenv("SNSDE_FUSED_MATMUL")
        want = run(stream_dtype=_dtype(stream), matmul=matmul)
        exact = run()
    assert torch.equal(asked[0], want) and torch.equal(asked[1], want)
    assert not torch.equal(want, exact)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_cde_solve_selects_the_mode_as_jax(monkeypatch, how):
    """fused_cde_solve and its packed form likewise, for an MLP field (the
    mode as JAX resolves it) and for the GRU-ODE field, whose operands stay
    exact fp32 whatever is asked (fused_cde.py:691-697): its result is the
    solve with the asked streams and fp32 operands bit for bit."""
    times, x, _, _ = _setting(Bn=3, width=4)
    path = CubicPath(hermite_cubic_coeffs(torch.as_tensor(times),
                                          torch.as_tensor(x)), times)
    z0 = torch.linspace(-1.0, 1.0, 12).reshape(3, 4)
    mlp = FinalTanh(C, 4, 4, 1, generator=torch.Generator().manual_seed(0))
    gru = GRUODEField(C, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        kw, (stream, matmul) = _asked(monkeypatch, how)
        kw["dt"] = 0.1
        asked = {f: (fused_cde_solve(f, path, times, z0, **kw),
                     multi.fused_cde_solve_packed([f], path, times, z0[None],
                                                  **kw)[0])
                 for f in (mlp, gru)}
        monkeypatch.delenv("SNSDE_FUSED_STREAM")
        monkeypatch.delenv("SNSDE_FUSED_MATMUL")
        for f, mm in ((mlp, matmul), (gru, "f32")):
            want = fused_cde_solve(f, path, times, z0, dt=0.1,
                                   stream_dtype=_dtype(stream), matmul=mm)
            assert torch.equal(asked[f][0], want)
            assert torch.equal(asked[f][1], want)
            assert not torch.equal(want, fused_cde_solve(f, path, times, z0,
                                                         dt=0.1))


@pytest.mark.parametrize("kind,item", [("gru", "K6"), ("lstm", "K7")])
def test_recurrences_raise_naming_k6_and_k7(monkeypatch, kind, item):
    """The GRU and LSTM scans, whose reduced precisions (ROADMAP Queue 2 K6
    and K7) once raised, run in bf16 streams (the argument or
    SNSDE_FUSED_STREAM) and in bf16 or bf16x3 operands (SNSDE_FUSED_MATMUL),
    as the JAX scans read both: finite hs and gradients, each apart from
    exact fp32's (their values against the JAX kernels:
    tests/test_torch_fused_rnn_precision.py)."""
    cell = (GRUCell if kind == "gru" else LSTMCell)(
        3, 4, generator=torch.Generator().manual_seed(0))
    scan = fused_gru_scan if kind == "gru" else fused_lstm_scan
    xs = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 2, 3)),
                         dtype=torch.float32)

    def run(**kw):
        cell.w_hh.grad = None
        hs = scan(cell, xs, **kw)
        hs.square().sum().backward()
        assert torch.isfinite(hs).all() and torch.isfinite(cell.w_hh.grad).all()
        return hs.detach(), cell.w_hh.grad.clone()

    exact = run()
    asked = [run(stream_dtype=torch.bfloat16)]
    for var, value in (("SNSDE_FUSED_STREAM", "bf16"),
                       ("SNSDE_FUSED_MATMUL", "bf16x3")):
        with monkeypatch.context() as m:
            m.setenv(var, value)
            asked.append(run())
    assert torch.equal(asked[0][0], asked[1][0])
    for hs, grad in asked:
        assert not torch.equal(hs, exact[0])
        assert not torch.equal(grad, exact[1])


@pytest.mark.parametrize("matmul,stream", COMBOS)
def test_chip_forward_bar_fails_another_operand_mode(monkeypatch, matmul,
                                                     stream):
    """chip_smoke.py's bar for the reduced forward kernel (forward_bar: one
    bf16 ulp plus the larger of TOL_YS of max|ys| and PREC_SPREAD times a
    nudged plain run's move an entry, PREC_SPREAD times the nudged move's
    rms plus TOL_YS of the trajectory's in rms) tells the operand modes
    apart at the sepsis width over 71 steps (B=128): the plain version in
    the mode's control (PREC_CONTROL) fails it against this mode's plain
    version, as the kernel in that mode must on the card, and by at least
    twice the rms bar."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    main = chip_smoke.MAIN
    inp, gys = chip_smoke.kernel_inputs(main["model"], 128, main["L"],
                                        main["C"], main["H"], main["layers"])
    fwd, flags, _ = chip_smoke.prec_args(*chip_smoke._split(inp), gys,
                                         matmul, stream)
    p = fe.fused_em_forward_reference(*fwd, **flags)[0].float()
    dn = (fe.fused_em_forward_reference(*fwd, **flags,
                                        relu=chip_smoke.nudged_relu)[0]
          .float() - p).abs()
    wrong = chip_smoke.PREC_CONTROL[matmul]
    assert wrong != matmul
    control = fe.fused_em_forward_reference(*fwd,
                                            **dict(flags, matmul=wrong))[0]
    _, rms, bar, over = chip_smoke.forward_bar(control, p, dn)
    assert over > 0 or rms > 2 * bar, (rms, bar, over)
    # the nudged run itself is inside the bar
    _, rms_n, bar_n, over_n = chip_smoke.forward_bar(p + dn, p, dn)
    assert over_n <= 0 and rms_n <= bar_n


def test_chip_split_shape_tells_bf16x3_from_fp32(monkeypatch):
    """At chip_smoke.py's PREC_SPLIT shape (the sepsis width, 2 steps of 16
    rows) the plain weight gradient in bf16x3 parts from exact fp32 by more
    than 20 times fp32's own rounding (float32 against float64 sums) on
    every product's output, so that the card's bar (the kernel within a
    tenth of that gap of the plain bf16x3 product, split_check) holds a
    kernel whose sums differ from the plain version's only in their order,
    and fails one that computes exact fp32."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    main, sh = chip_smoke.MAIN, chip_smoke.PREC_SPLIT
    inp, gys = chip_smoke.kernel_inputs(main["model"], sh["B"], sh["L"],
                                        main["C"], main["H"], main["layers"])
    fwd, flags = chip_smoke._split(inp)
    ys, ns = fe.fused_em_forward_reference(*fwd, **flags)
    st = fe.fused_em_backward_recurrence_reference(fwd[0], ys, gys, *fwd[1:],
                                                   **flags, ns=ns)
    modes = dict(drift=flags["drift"], noise=flags["noise"])
    streams = (fwd[0], ys, st.dxh, st.hs, st.es, st.dz3, st.q)
    w = {m: fe.fused_em_weight_grads_reference(*streams, **modes, matmul=m)
         for m in ("f32", "bf16x3")}
    w64 = fe.fused_em_weight_grads_reference(*(t.double() for t in streams),
                                             **modes)
    products = 0
    for i, name in enumerate(w["f32"]._fields):
        if w["f32"][i] is None:
            continue
        gap = float((w["bf16x3"][i] - w["f32"][i]).abs().max())
        if not gap:
            continue            # a column or bias sum: no operand split
        products += 1
        err = float((w["f32"][i].double() - w64[i]).abs().max())
        assert gap > 20 * err, (name, gap, err)
    assert products >= 3
