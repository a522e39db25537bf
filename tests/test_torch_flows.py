"""The neural flows (snsde_torch/models/flows.py) against the JAX package
on the CPU: the coupling, ResNet and GRU flow layers are the identity at
t = 0 (tests/test_zoo_behavior.py:55-96), a coupling layer inverts; the
16 family × flow-option registry layers carried from JAX (the input option
rotating over x, y and z), their outputs and every parameter gradient, the
CDE families through the eager `cdeint` and through the fused solve's
plain versions (the route a CUDA tensor takes); and every one of the 48
flow names builds and runs a forward pass in the port alone.

Tolerances (tests/torch_zoo.py): outputs 1e-5 absolute, gradients 1e-4
of their largest entry; the identity at t = 0 exactly.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.nn.core import filter_value_and_grad
from snsde.registry import make_seq_layer as jax_make_seq_layer

from snsde_torch.harness.robustness import preprocess_ists
from snsde_torch.kernels.fused_cde import fused_cde_solve
from snsde_torch.models import flows as tflows
from snsde_torch.registry import MODEL_NAMES, make_seq_layer

from test_torch_fused_em import jax_arrays
from torch_zoo import assert_close, assert_grads_match, carry

B, L, D, H = 4, 8, 2, 5
FAMILIES = ("neuralflow", "neuralflowcde", "neuralmixture",
            "neuralcontrolledflow")
CASES = [f"{fam}_{'xyz'[(i + j) % 3]}_{fo}"
         for i, fam in enumerate(FAMILIES) for j, fo in enumerate("nrgc")]
FLOW_NAMES = [n for n in MODEL_NAMES if n.split("_")[0] in FAMILIES]


def _layer(kind):
    g = torch.Generator().manual_seed(3)
    if kind == "c":
        return tflows.CouplingFlowLayer(6, 16, parity=0, generator=g)
    if kind == "r":
        return tflows.ResNetFlowLayer(6, 16, generator=g)
    return tflows.GRUFlowBlock(6, generator=g)


@pytest.mark.parametrize("kind", ["c", "r", "g"])
def test_flow_layer_is_the_identity_at_t0(kind):
    """F(x, 0) = x exactly (φ(0) = tanh(0) = 0), and F(x, t) != x."""
    layer = _layer(kind)
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    assert torch.equal(layer(x, torch.zeros(4, 1)), x)
    assert not torch.allclose(layer(x, torch.full((4, 1), 0.7)), x)


def test_coupling_layer_inverts():
    """The masked half passes untouched, and the other half is recovered
    from it: x_b = (y_b - u) exp(-s)."""
    layer = _layer("c")
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    t = torch.full((4, 1), 0.7)
    with torch.no_grad():
        y = layer(x, t)
        mask = (torch.arange(6) % 2 == 0).float()
        assert torch.equal(y * mask, x * mask)
        h = torch.relu(layer.net1(torch.cat([y * mask, t], dim=-1)))
        su = layer.net2(h) * layer.time_net(t)
        s, u = su[..., :6], su[..., 6:]
        x_rec = (y - u * (1 - mask)) * torch.exp(-s * (1 - mask))
        x_rec = x_rec * (1 - mask) + y * mask
    np.testing.assert_allclose(x_rec.numpy(), x.numpy(), atol=1e-5)


def _data(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, L, D)).astype(np.float32)
    return preprocess_ists(X, 0.3, seed=seed)


def _loss(res):
    return (res[0] ** 2).mean() + res[1].mean()


@functools.lru_cache(maxsize=None)
def _jax_cases():
    """Each case's seq and Hermite coefficients, JAX layer, outputs and
    gradients: every case in one JAX compile, shared by the routes."""
    datas = {n: _data(i) for i, n in enumerate(CASES)}
    jls = {n: jax_make_seq_layer(jax.random.PRNGKey(i), n, D, L, H)
           for i, n in enumerate(CASES)}

    def loss(ms):
        res = {n: m(jnp.asarray(datas[n]["seq"]),
                    jnp.asarray(datas[n]["coeffs"])) for n, m in ms.items()}
        return sum(_loss(r) for r in res.values()), res

    (_, res), g = jax.jit(filter_value_and_grad(loss, has_aux=True))(jls)
    return {n: (datas[n], jls[n], [np.asarray(r) for r in res[n]],
                jax_arrays(g[n])) for n in CASES}


ROUTED = [(n, r) for n in CASES
          for r in (("eager", "fused") if not n.startswith("neuralflow_")
                    else ("eager",))]


@pytest.mark.parametrize("name,route", ROUTED)
def test_flow_layer_matches_jax(name, route, monkeypatch):
    """The registry layer carried from JAX: out and hn [B, L, H] to 1e-5,
    every parameter gradient of mean(out²) + mean(hn) to 1e-4 (the unused
    leaves of each option, NeuralControlledFlow's initial_flow among them,
    zero on both sides); a CDE family's one solve through the eager
    cdeint or the fused solve's plain versions."""
    data, jl, ref, ref_g = _jax_cases()[name]
    tl = carry(jl, make_seq_layer(name, D, L, H))
    calls = []
    if route == "fused":
        def dispatch(path, func, z0, ts, *, dt, method, use_fused=True):
            calls.append(method)
            return fused_cde_solve(func, path, ts, z0, dt=dt, method=method)

        monkeypatch.setattr(tflows, "cde_solve_dispatch", dispatch)
    res = tl(torch.as_tensor(data["seq"]), torch.as_tensor(data["coeffs"]))
    assert len(res) == 2 and res[0].shape == (B, L, H)
    for i, (a, b) in enumerate(zip(res, ref)):
        assert_close(a, b, name=f"{name} output {i}")
    _loss(res).backward()
    assert_grads_match(tl, ref_g)
    assert calls == (["rk4"] if route == "fused" else [])
    if name.startswith("neuralcontrolledflow"):
        assert all(p.grad is None or not p.grad.any()
                   for p in tl.inner.initial_flow.parameters())


@pytest.mark.parametrize("name", FLOW_NAMES)
def test_every_flow_name_builds_and_runs(name):
    """All 48 names: the port's layer alone, one forward pass, finite
    streams [B, L, H]."""
    data = _data(0)
    tl = make_seq_layer(name, D, L, H,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, hn = tl(torch.as_tensor(data["seq"]),
                     torch.as_tensor(data["coeffs"]))
    assert out.shape == (B, L, H) and hn.shape[:2] == (B, L)
    assert torch.isfinite(out).all() and torch.isfinite(hn).all()
