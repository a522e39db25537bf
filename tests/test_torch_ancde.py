"""ANCDE, EXIT, LEAP and NeuralRDE (snsde_torch/models/ancde.py) against
the JAX package on the CPU: `hard_sigmoid_ste`; each model's outputs and
every parameter gradient, each CDE solve through the eager `cdeint` and
through the fused solve's plain versions (the route a CUDA tensor takes to
the kernels: the control stream's cotangent ddx from the backward's plain
version), EXIT's and LEAP's probes passed in from JAX's own key; that
ANCDE's gate gets its gradient through the top solve's control stream;
and the registry layers `ancde`, `exit`, `leap` and `neuralrde-1/2/3`,
`neuralrde`'s streams re-expanded to L and `leap`'s aux.

Tolerances (tests/torch_zoo.py): outputs 1e-5 absolute, gradients 1e-4
of their largest entry. JAX's CDE solves take their scan paths on the CPU.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.models import ancde as jancde
from snsde.nn.core import filter_value_and_grad
from snsde.registry import make_seq_layer as jax_make_seq_layer

from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.models import ancde as tancde
from snsde_torch.ops import hermite_cubic_coeffs
from snsde_torch.registry import make_seq_layer

from test_torch_fused_em import jax_arrays
from torch_zoo import (assert_close, assert_grads_match, carry,
                       grad_errors, jax_value_and_grads, probe_noise)

B, L, C, H = 4, 9, 3, 5
TIMES = np.linspace(0.0, 1.0, L).astype(np.float32)


def _control(seed=0):
    """The raw (time ‖ values) series and its Hermite coefficients [B, L-1,
    4C] (the port's, which tests/test_torch_cde.py holds to JAX's)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(B, L, C - 1)).astype(np.float32)
    x = np.concatenate([np.broadcast_to(TIMES[None, :, None], (B, L, 1)),
                        vals], axis=-1).astype(np.float32)
    coeffs = hermite_cubic_coeffs(torch.as_tensor(TIMES), torch.as_tensor(x))
    return x, coeffs.numpy()


def test_hard_sigmoid_ste_matches_jax():
    """Forward round(clip(0.2x + 0.5)) with halves to even (x = 0 gives
    0.5 -> 0), and the straight-through gradient of the clipped line."""
    x = np.array([-4.0, -2.5, -1.0, 0.0, 0.3, 2.5, 2.6, 7.0], np.float32)
    w = np.arange(1, 9, dtype=np.float32)
    y_j, g_j = jax.value_and_grad(
        lambda v: jnp.sum(jnp.asarray(w) * jancde.hard_sigmoid_ste(v)))(
        jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y_t = tancde.hard_sigmoid_ste(xt)
    np.testing.assert_array_equal(y_t.detach().numpy(),
                                  np.asarray(jancde.hard_sigmoid_ste(x)))
    assert y_t[3] == 0.0 and y_t[2] == 0.0 and y_t[5] == 1.0
    (torch.as_tensor(w) * y_t).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_j))
    assert float(y_j) == float((torch.as_tensor(w) * y_t.detach()).sum())


def _loss(res):
    out, hn = res[0], res[1]
    loss = (out ** 2).mean() + hn.mean()
    return loss + res[2] if len(res) == 3 else loss


def _fused_route(monkeypatch, calls):
    """Every CDE solve of the models through the fused solve's
    autograd.Function (its plain versions on the CPU): the route of a CUDA
    tensor."""
    def dispatch(path, func, z0, ts, *, dt, method, use_fused=True):
        calls.append(path.channels)
        return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)

    monkeypatch.setattr(tancde, "cde_solve_dispatch", dispatch)


def test_exit_regulariser_matches_jax(monkeypatch):
    """EXIT with return_reg (two inner field layers), the fused route: out,
    hn and mean(kinetic + jac) at the last time, and every parameter
    gradient of their sum, the Hutchinson probe JAX's own draw."""
    x, coeffs = _control(1)
    key = jax.random.PRNGKey(4)
    jm = jancde.EXIT.create(key, C, H, 2, hidden_hidden=6,
                            num_hidden_layers=2)
    tm = carry(jm, tancde.EXIT(C, H, 2, hidden_hidden=6,
                               num_hidden_layers=2))
    pkey, eps = probe_noise(5, (B, C))

    def loss(m):
        res = m(TIMES, jnp.asarray(coeffs), key=pkey, return_reg=True)
        return _loss(res), res

    ref, ref_g = jax_value_and_grads(loss, jm)
    calls = []
    _fused_route(monkeypatch, calls)
    res = tm(TIMES, torch.as_tensor(coeffs), eps=eps, return_reg=True)
    assert calls == [C] and float(res[2]) > 0
    for i, (a, b) in enumerate(zip(res, ref)):
        assert_close(a, b, name=f"exit output {i}")
    _loss(res).backward()
    assert_grads_match(tm, ref_g)
    assert float(tm.ode_f1.weight.grad.abs().max()) > 0


def _seq(seed, D, Ls):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, Ls, D)).astype(np.float32)
    mask = (rng.random(x.shape) > 0.3).astype(np.float32)
    delta = rng.uniform(0.0, 0.3, size=x.shape).astype(np.float32)
    return np.stack([x * mask, mask, delta], axis=1)


MODELS = ["ancde", "exit", "leap", "neuralrde-1", "neuralrde-2",
          "neuralrde-3"]
D, LS, HD = 2, 10, 5
LKEY = 13


@functools.lru_cache(maxsize=None)
def _jax_layers():
    """Each name's seq and coefficients (the harness's coeff_family of
    them), JAX layer (two inner field layers of width 6), outputs and
    gradients, and the probe JAX's layer key draws: every name in one JAX
    compile, shared by the routes."""
    from snsde_torch.harness.robustness import coeff_family, preprocess_ists

    seqs, coeffs, jls = {}, {}, {}
    for i, name in enumerate(MODELS):
        seqs[name] = _seq(i, D, LS)
        coeffs[name] = preprocess_ists(
            np.where(seqs[name][:, 1] > 0, seqs[name][:, 0], np.nan),
            interpolation=coeff_family(name))["coeffs"]
        jls[name] = jax_make_seq_layer(jax.random.PRNGKey(12), name, D, LS,
                                       HD, hidden_hidden_dim=6,
                                       num_hidden_layers=2)
    lkey = jax.random.PRNGKey(LKEY)

    def loss(ms):
        res = {n: m(jnp.asarray(seqs[n]), jnp.asarray(coeffs[n]), key=lkey)
               for n, m in ms.items()}
        return sum(_loss(r) for r in res.values()), res

    (_, res), g = jax.jit(filter_value_and_grad(loss, has_aux=True))(jls)
    out = {}
    for name in MODELS:
        eps = None
        if name in ("exit", "leap"):
            shape = (B, D + 1) if name == "exit" else (B, LS, D + 1)
            eps = probe_noise(LKEY, shape)[1]
        out[name] = (seqs[name], coeffs[name], jls[name],
                     [np.asarray(r) for r in res[name]],
                     jax_arrays(g[name]), eps)
    return out


def _port_layer(name, jl):
    return carry(jl, make_seq_layer(name, D, LS, HD, hidden_hidden_dim=6,
                                    num_hidden_layers=2))


@pytest.mark.parametrize("route", ["eager", "fused"])
@pytest.mark.parametrize("name", MODELS)
def test_registry_layer_matches_jax(name, route, monkeypatch):
    """The registry layer (ANCDE, EXIT, LEAP, NeuralRDE of depth 1-3)
    carried from JAX, over the seq and its natural or Hermite coefficients
    (the harness's coeff_family), L = 10: out and hn [B, L, H] (NeuralRDE's
    3 steps repeated to L), LEAP's divergence term, and every parameter
    gradient of mean(out²) + mean(hn) (+ the term); the probe of EXIT and
    LEAP JAX's own draw from the layer's key, passed through `eps`.
    Through the eager cdeint, and through the fused solve's plain versions
    (ANCDE two solves of C channels, NeuralRDE one of the log-signature's
    3, 6 or 14)."""
    seq, coeffs, jl, ref, ref_g, eps = _jax_layers()[name]
    tl = _port_layer(name, jl)
    calls = []
    if route == "fused":
        _fused_route(monkeypatch, calls)
    res = tl(torch.as_tensor(seq), torch.as_tensor(coeffs), eps=eps)
    assert len(res) == len(ref) == (3 if name == "leap" else 2)
    assert res[0].shape == res[1].shape == (B, LS, HD)
    for i, (a, b) in enumerate(zip(res, ref)):
        assert_close(a, b, name=f"{name} output {i}")
    _loss(res).backward()
    assert_grads_match(tl, ref_g)
    if route == "fused":
        C3 = D + 1
        want = {"ancde": [C3, C3], "exit": [C3], "leap": [C3],
                "neuralrde-1": [3], "neuralrde-2": [6], "neuralrde-3": [14]}
        assert calls == want[name]
    if name.startswith("neuralrde"):
        # 3 log-signature steps (windows of 4 over 9 of the 10 points),
        # each repeated ceil(10 / 3) = 4 times
        hn = res[1].detach()
        assert torch.equal(hn[:, 0], hn[:, 3])
        assert torch.equal(hn[:, 4], hn[:, 7])


def test_ancde_gate_gradient_goes_through_the_top_control():
    """The gate a(t) reaches the top solve through its re-fit control
    stream (and y0). With the stream detached from the gate,
    time_attention's gradient, held at 1e-4 above, misses JAX's by more
    than 1e-2 of its scale: the parity check would catch a control-stream
    cotangent (the fused backward's ddx) that never reached the gate."""
    seq, coeffs, jl, _, ref_g, _ = _jax_layers()["ancde"]
    tl = _port_layer("ancde", jl)
    real = tancde.hermite_cubic_coeffs
    mp = pytest.MonkeyPatch()
    mp.setattr(tancde, "hermite_cubic_coeffs",
               lambda t, s, **kw: real(t, s.detach(), **kw))
    try:
        _loss(tl(torch.as_tensor(seq), torch.as_tensor(coeffs))).backward()
    finally:
        mp.undo()
    errs = grad_errors(tl, ref_g)
    assert errs["inner.time_attention.weight"] > 1e-2, errs
    assert errs["inner.func_g.linear_out.weight"] <= 1e-4


def test_probe_defaults_to_a_generator_seeded_0():
    """Without a generator or eps, EXIT and LEAP draw their probe from a
    generator seeded 0 on the model's device: the regulariser equals the
    call given such a generator, and differs from another seed's."""
    _, coeffs = _control(9)
    ct = torch.as_tensor(coeffs)
    for cls, kw in ((tancde.EXIT, dict(return_reg=True)), (tancde.LEAP, {})):
        m = cls(C, H, 2, generator=torch.Generator().manual_seed(1))
        reg = lambda g=None: m(TIMES, ct, generator=g, **kw)[2]
        with torch.no_grad():
            default = reg()
            assert torch.equal(default, reg(torch.Generator().manual_seed(0)))
            assert not torch.equal(default,
                                   reg(torch.Generator().manual_seed(3)))
