"""The modes of the port's fused GRU and LSTM kernels that the ODE-RNN
hybrids reach (the GRU's observation mask, time-only decay row and Euler
MLP evolve; the LSTM's evolve after the cell), against the JAX package's
fused kernels and against autograd of the port's own plain forwards.

The JAX kernels run in Pallas interpret mode on the CPU with float32
streams (as tests/test_fused_rnn.py runs them), through `fused_gru_scan` /
`fused_lstm_scan` and `jax.vjp`; the port runs its own scans, whose
autograd.Functions take the plain PyTorch versions for CPU tensors. Both
sides get the same input-projection stream gi (each scan is handed a cell
whose w_ih is the identity and b_ih zero), weights, h0, mask, decay row,
elapsed times and output cotangent, drawn with numpy. L = 7 and 11 take the
JAX kernel's valid-flag padding to its unroll of 4.

Tolerances, as tests/test_torch_fused_rnn.py: hs within 2e-6 absolute
(the same recurrence in float32, the sums in another order); every
cotangent (gi, W_hh, b_hh, h0, the decay row, each evolve layer's W and b)
within 1e-5 of its largest entry. The plain backward versions equal
autograd of the plain forwards in float64 to 1e-12.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde_torch.kernels import fused_rnn as fr

B, H = 6, 5
TOL_HS = 2e-6
TOL_GRAD = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("SNSDE_FUSED_INTERPRET", "1")
    monkeypatch.setenv("SNSDE_FUSED_STREAM", "f32")


def _mlp(rng, n, hh, H=H):
    """Weights [in, out] and biases of an n-layer MLP H -> hh .. -> H,
    keyed wf{i}/bf{i}."""
    out = {}
    for i in range(n):
        fi = H if i == 0 else hh
        fo = H if i == n - 1 else hh
        k = 1.0 / np.sqrt(fi)
        out[f"wf{i}"] = rng.uniform(-k, k, size=(fi, fo)).astype(np.float32)
        out[f"bf{i}"] = rng.uniform(-k, k, size=(fo,)).astype(np.float32)
    return out


def _obs(rng, L, density):
    """A sparse 0/1 pattern [L, B]: each step observed with `density`, the
    first row of every column observed."""
    o = (rng.uniform(size=(L, B)) < density).astype(np.float32)
    o[0] = 1.0
    return o


def _inputs(kind, L, *, obs=None, row=False, n=0, hh=4, steps=1, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    k = 1.0 / np.sqrt(H)
    f = lambda a: a.astype(np.float32)
    inp = {"gi": f(rng.normal(size=(L, B, G * H))),
           "whh": f(rng.uniform(-k, k, size=(H, G * H))),
           "bhh": f(rng.uniform(-k, k, size=(G * H,)))}
    data = {}
    if kind == "gru":
        inp["h0"] = f(0.5 * rng.normal(size=(B, H)))
        if obs is not None:
            data["obs"] = _obs(rng, L, obs)
        if row:
            inp["hrow"] = f(rng.uniform(0.2, 1.0, size=(L, H)))
        if n:
            data["tdif"] = f(rng.uniform(0.0, 0.4, size=(L,)))
    elif n:
        data["odt"] = f(rng.uniform(0.0, 0.4, size=(L, B)))
    if n:
        inp.update(_mlp(rng, n, hh))
    return inp, data, f(rng.normal(size=(L, B, H))), steps


def _jax_side(kind, inp, data, ghs, steps, reverse=False):
    """(hs, {name: cotangent}) of the JAX kernel through jax.vjp."""
    from snsde.kernels.fused_rnn import fused_gru_scan, fused_lstm_scan

    G = 3 if kind == "gru" else 4
    names = sorted(inp)

    def f(*args):
        a = dict(zip(names, args))
        cell = SimpleNamespace(w_ih=jnp.eye(G * H, dtype=jnp.float32),
                               b_ih=jnp.zeros((G * H,), jnp.float32),
                               w_hh=a["whh"], b_hh=a["bhh"], hidden_size=H)
        n = sum(k.startswith("wf") for k in a)
        layers = (tuple(SimpleNamespace(weight=a[f"wf{i}"], bias=a[f"bf{i}"])
                        for i in range(n)) if n else None)
        if kind == "lstm":
            return fused_lstm_scan(cell, a["gi"], reverse=reverse,
                                   ode_layers=layers,
                                   odt=jnp.asarray(data.get("odt")) if n
                                   else None, ode_steps=steps)
        obs = data.get("obs")
        return fused_gru_scan(
            cell, a["gi"], h0=a["h0"], reverse=reverse,
            obs=None if obs is None else jnp.asarray(obs),
            hdec=a.get("hrow"), ode_layers=layers,
            tdif=jnp.asarray(data["tdif"]) if n else None, ode_steps=steps)

    hs, vjp = jax.vjp(f, *(jnp.asarray(inp[k]) for k in names))
    grads = vjp(jnp.asarray(ghs))
    return np.asarray(hs), {k: np.asarray(g) for k, g in zip(names, grads)}


def _linears(t):
    """torch nn.Linears (weight [out, in]) of the wf{i}/bf{i} leaves."""
    n = sum(k.startswith("wf") for k in t)
    out = []
    for i in range(n):
        w = t[f"wf{i}"]
        lin = torch.nn.Linear(w.shape[0], w.shape[1])
        lin.weight = torch.nn.Parameter(w.detach().T.clone())
        lin.bias = torch.nn.Parameter(t[f"bf{i}"].detach().clone())
        out.append(lin)
    return out


def _port_side(kind, inp, data, ghs, steps, reverse=False):
    """(hs, {name: cotangent}) of the port's scan through autograd."""
    G = 3 if kind == "gru" else 4
    t = {k: torch.as_tensor(v).requires_grad_(True) for k, v in inp.items()}
    cell = SimpleNamespace(w_ih=torch.eye(G * H), b_ih=torch.zeros(G * H),
                           w_hh=t["whh"], b_hh=t["bhh"], hidden_size=H)
    layers = _linears(t) or None
    if kind == "lstm":
        hs = fr.fused_lstm_scan(cell, t["gi"], reverse=reverse,
                                ode_layers=layers, odt=data.get("odt"),
                                ode_steps=steps)
    else:
        obs = data.get("obs")
        hs = fr.fused_gru_scan(
            cell, t["gi"], h0=t["h0"], reverse=reverse,
            obs=None if obs is None else torch.as_tensor(obs),
            hdec=t.get("hrow"), ode_layers=layers, tdif=data.get("tdif"),
            ode_steps=steps)
    hs.backward(torch.as_tensor(ghs))
    grads = {k: v.grad.numpy() for k, v in t.items() if v.grad is not None}
    for i, lin in enumerate(layers or ()):
        grads[f"wf{i}"] = lin.weight.grad.T.numpy()
        grads[f"bf{i}"] = lin.bias.grad.numpy()
    return hs.detach().numpy(), grads


def _compare(kind, inp, data, ghs, steps, reverse=False):
    hs_j, g_j = _jax_side(kind, inp, data, ghs, steps, reverse)
    hs_t, g_t = _port_side(kind, inp, data, ghs, steps, reverse)
    np.testing.assert_allclose(hs_t, hs_j, atol=TOL_HS, rtol=0)
    assert set(g_j) == set(inp) and set(inp) <= set(g_t)
    for name, ref in g_j.items():
        err = float(np.abs(g_t[name] - ref).max())
        assert err <= TOL_GRAD * float(np.abs(ref).max()), (name, err)


# (L, observed share, reverse): the mask at several densities, a sparse
# pattern leaving runs of unobserved steps
@pytest.mark.parametrize("L,density,reverse", [(7, 0.5, False),
                                               (11, 0.2, False),
                                               (8, 0.8, True),
                                               (11, 0.0, False)])
def test_gru_obs_matches_jax_kernel(L, density, reverse):
    inp, data, ghs, steps = _inputs("gru", L, obs=density, seed=1)
    _compare("gru", inp, data, ghs, steps, reverse)


@pytest.mark.parametrize("L,density,reverse", [(7, 0.5, False),
                                               (11, 0.2, True),
                                               (8, 1.0, False)])
def test_gru_row_decay_matches_jax_kernel(L, density, reverse):
    """obs with the time-only decay row hdec [L, H] (GRU-D): its cotangent
    is summed over the batch."""
    inp, data, ghs, steps = _inputs("gru", L, obs=density, row=True, seed=2)
    _compare("gru", inp, data, ghs, steps, reverse)


@pytest.mark.parametrize("n,steps", [(2, 1), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("L", [7, 12])
def test_gru_evolve_matches_jax_kernel(n, steps, L):
    """obs with the ODE-RNN evolve: n = 2 and 3 layers (hh = 4 != H),
    one and two substeps."""
    inp, data, ghs, steps = _inputs("gru", L, obs=0.6, n=n, steps=steps,
                                    seed=3 + n)
    _compare("gru", inp, data, ghs, steps)


def test_gru_evolve_single_layer_and_reverse_match_jax_kernel():
    inp, data, ghs, steps = _inputs("gru", 8, obs=0.5, n=1, steps=2, seed=9)
    _compare("gru", inp, data, ghs, steps, reverse=True)


@pytest.mark.parametrize("n,steps", [(2, 1), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("L", [7, 12])
def test_lstm_evolve_matches_jax_kernel(n, steps, L):
    """The ODE-LSTM evolve of h after the cell with per-row elapsed times
    (the JAX model takes n = 2; the kernels any n)."""
    inp, data, ghs, steps = _inputs("lstm", L, n=n, steps=steps, seed=n)
    _compare("lstm", inp, data, ghs, steps)


def test_lstm_evolve_reverse_matches_jax_kernel():
    inp, data, ghs, steps = _inputs("lstm", 9, n=2, steps=2, seed=11)
    _compare("lstm", inp, data, ghs, steps, reverse=True)


def _f64(inp):
    return {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}


def _evolve64(t, data, key, steps):
    """The Evolve of float64 leaves (popped from t) over data[key]."""
    n = sum(k.startswith("wf") for k in t)
    layers = [(t.pop(f"wf{i}"), t.pop(f"bf{i}")) for i in range(n)]
    hh = layers[0][0].shape[1] if n > 1 else H
    mlp = torch.cat([x for w, b in layers for x in (w.reshape(-1), b)])
    dts = torch.as_tensor(data[key], dtype=torch.float64) / steps
    return fr.Evolve(mlp, dts, n, hh, steps)


@pytest.mark.parametrize("mode", ["obs", "row", "evolve"])
def test_gru_backward_reference_is_autograd_of_forward(mode):
    """In float64 the plain reverse loop of each mode equals autograd of
    the plain forward loop (every cotangent, the evolve's packed one
    included) to rounding."""
    inp, data, ghs, steps = _inputs(
        "gru", 7, obs=0.5, row=mode == "row", n=3 if mode == "evolve" else 0,
        steps=2, seed=12)
    t = _f64(inp)
    kw = {"obs": torch.as_tensor(data["obs"], dtype=torch.float64)}
    if mode == "evolve":
        ode = _evolve64(t, data, "tdif", steps)
        kw["ode"] = ode._replace(mlp=ode.mlp.requires_grad_(True))
    leaves = {k: v.requires_grad_(True) for k, v in t.items()}
    hs = fr.fused_gru_forward_reference(**leaves, **kw)
    g = torch.as_tensor(ghs, dtype=torch.float64)
    hs.backward(g)
    ours = fr.fused_gru_backward_reference(hs=hs.detach(), ghs=g, **t, **kw)
    want = {"dgi": "gi", "dh0": "h0", "dwhh": "whh", "dbhh": "bhh",
            "dhrow": "hrow"}
    for name, leaf in want.items():
        if leaf in leaves:
            torch.testing.assert_close(getattr(ours, name),
                                       leaves[leaf].grad, rtol=1e-12,
                                       atol=1e-12)
        else:
            assert getattr(ours, name) is None
    assert isinstance(ours, fr.FusedGRUGrads) and ours.dhdec is None
    if mode == "evolve":
        torch.testing.assert_close(ours.dmlp, kw["ode"].mlp.grad,
                                   rtol=1e-12, atol=1e-12)
    else:
        assert ours.dmlp is None


def test_lstm_backward_reference_is_autograd_of_forward():
    inp, data, ghs, steps = _inputs("lstm", 7, n=3, steps=2, seed=13)
    t = _f64(inp)
    ode = _evolve64(t, data, "odt", steps)
    ode = ode._replace(mlp=ode.mlp.requires_grad_(True))
    leaves = {k: v.requires_grad_(True) for k, v in t.items()}
    hs, cs, hcell = fr.fused_lstm_forward_reference(**leaves, ode=ode)
    g = torch.as_tensor(ghs, dtype=torch.float64)
    hs.backward(g)
    ours = fr.fused_lstm_backward_reference(
        hs=hs.detach(), cs=cs.detach(), ghs=g, ode=ode,
        hcell=hcell.detach(), **t)
    assert isinstance(ours, fr.FusedLSTMGrads)
    for name in ("dgi", "dwhh", "dbhh"):
        torch.testing.assert_close(getattr(ours, name), leaves[name[1:]].grad,
                                   rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ours.dmlp, ode.mlp.grad, rtol=1e-12,
                               atol=1e-12)


def test_mlp_weight_grads_reference_equals_per_step_sums():
    """The evolve's weight gradient as one product a layer over the
    backward's streams equals the sums over (step, substep) of each
    substep's own products, in float64."""
    rng = np.random.default_rng(14)
    L, S, hh, n = 4, 2, 3, 3
    ode = fr.Evolve(torch.zeros(0), torch.zeros(L), n, hh, S)
    dims = fr._mlp_dims(H, hh, n)
    K = L * S * B
    acts = torch.as_tensor(rng.normal(size=K * sum(i for i, _ in dims)))
    dzs = torch.as_tensor(rng.normal(size=K * sum(j for _, j in dims)))
    got = fr.fused_mlp_weight_grads(acts, dzs, L, B, H, ode)
    av = fr._stream_views(acts, K, [i for i, _ in dims])
    zv = fr._stream_views(dzs, K, [j for _, j in dims])
    want = []
    for a, z in zip(av, zv):
        dw = sum(a[r:r + B].T @ z[r:r + B] for r in range(0, K, B))
        want += [dw.reshape(-1), z.sum(0)]
    torch.testing.assert_close(got, torch.cat(want), rtol=1e-12, atol=1e-12)


def test_gru_mode_combinations_and_inputs_are_checked():
    """The GRU's modes on a tensor that is not on the CPU: the combinations
    no JAX caller reaches raise NotImplementedError saying so; a mode's
    inputs of the wrong shape raise ValueError; CPU tensors take the plain
    version in every combination."""
    inp, data, ghs, steps = _inputs("gru", 5, obs=0.5, row=True, n=2,
                                    seed=15)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    obs = torch.as_tensor(data["obs"])
    ode = _evolve64({k: v.double() for k, v in t.items()}, data, "tdif", 1)
    ode = ode._replace(mlp=ode.mlp.float(), dts=ode.dts.float())
    base = {k: t[k] for k in ("gi", "h0", "whh", "bhh")}
    meta = {k: v.to("meta") for k, v in base.items()}
    hdec = torch.ones(5, B, H)
    for kw in ({"hdec": hdec, "obs": obs}, {"hrow": t["hrow"], "ode": ode},
               {"hdec": hdec, "ode": ode}):
        with pytest.raises(NotImplementedError, match="no JAX caller"):
            fr.fused_gru_forward(**meta, **{k: v.to("meta")
                                            for k, v in kw.items()
                                            if torch.is_tensor(v)},
                                 **{k: v for k, v in kw.items()
                                    if not torch.is_tensor(v)})
        fr.fused_gru_forward(**base, **kw)
    with pytest.raises(ValueError, match="expected"):
        fr.check_gru_inputs(**base, obs=obs[:, :3])
    with pytest.raises(ValueError, match="expected"):
        fr.check_gru_inputs(**base, hrow=t["hrow"][:, :2])
    with pytest.raises(ValueError, match="expected"):
        fr.check_gru_inputs(**base, ode=ode._replace(dts=ode.dts[:2]))
    with pytest.raises(ValueError, match="evolve needs"):
        fr.check_gru_inputs(**base, ode=ode._replace(steps=0))
    assert fr.check_gru_inputs(**base, obs=obs, ode=ode) == (5, B, H)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_gru_forward(**meta, obs=obs.to("meta"))
    lmeta = {k: torch.zeros(5, B, 4 * H, device="meta") if k == "gi" else
             torch.zeros(H, 4 * H, device="meta") if k == "whh" else
             torch.zeros(4 * H, device="meta") for k in ("gi", "whh", "bhh")}
    odt = fr.Evolve(ode.mlp.to("meta"), torch.zeros(5, B, device="meta"), 2,
                    ode.hh, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fr.fused_lstm_forward(**lmeta, ode=odt)
    with pytest.raises(ValueError, match="expected"):
        fr.fused_lstm_forward(**lmeta, ode=odt._replace(dts=odt.dts[:, :2]))


def test_evolve_needs_layers_and_times():
    cell = SimpleNamespace(w_ih=torch.eye(3 * H), b_ih=torch.zeros(3 * H),
                           w_hh=torch.zeros(H, 3 * H),
                           b_hh=torch.zeros(3 * H), hidden_size=H)
    with pytest.raises(ValueError, match="tdif"):
        fr.fused_gru_scan(cell, torch.zeros(4, B, 3 * H),
                          ode_layers=[torch.nn.Linear(H, H)])
    with pytest.raises(ValueError, match="tdif"):
        fr.fused_gru_scan(cell, torch.zeros(4, B, 3 * H),
                          tdif=torch.ones(4))
