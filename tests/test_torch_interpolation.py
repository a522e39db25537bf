"""The interpolation harness (snsde_torch/harness/interpolation.py) and
the pieces it brings (data/physionet2012.py, train/checkpoint.py,
CosineAnnealingLR, padded_index_grid) against the JAX package on the CPU.

The JAX side is built from the JAX package's public pieces (its
`_Recognition`, `MTANDecoder`/`DecRNN3`, `hermite_cubic_coeffs`,
`_gaussian_logpdf`, and the scatter and loss of
snsde/harness/interpolation.py:149-215 written out here, since they are
closures of `run_interpolation`), one jitted call a case, and carried into
the port with snsde_torch.convert. The keep mask, the Brownian increments
(a BrownianGrid on both sides: the eager solvers) and the samples are
passed in.

Tolerances: forward values to TOL = 1e-5 of max(1, the reference's
largest entry) (logpx runs to 1e3-1e5 at std 0.01); every parameter
gradient to 1e-4 of its scale (tests/torch_zoo.py). At std 0.01 the k
samples' weights in the logsumexp differ by hundreds of nats, so the
gradient goes almost wholly through one sample, and a rounding difference
that moved the winning sample would move the gradient wholesale: the
gradients are held in float64 on both sides (JAX under enable_x64), where
rounding cannot, and in float32, where at these sizes the weights are
one-hot to float32 and the two packages agree to ~1e-6 of the scale.

The runs: the port's per-iteration index grids, KL weights and rates
against JAX's formulas, and a resumed run against the uninterrupted one
(tests/test_harnesses.py:139 at this size).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import io
import json
import math
import os
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.data import physionet2012 as jphys
from snsde.harness import interpolation as jinterp
from snsde.models.mtan import DecRNN3 as JDecRNN3
from snsde.models.mtan import MTANDecoder as JMTANDecoder
from snsde.nn.core import Module, module
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import checkpoint as jckpt
from snsde.train.loop import padded_index_grid as jax_padded_index_grid
from snsde.train.schedule import CosineAnnealingLR as JaxCosine

from snsde_torch.data import physionet2012 as tphys
from snsde_torch.harness import interpolation as tinterp
from snsde_torch.models.neuralsde import resolve_dt
from snsde_torch.ops import BrownianGrid, make_grid
from snsde_torch.train import checkpoint as tckpt
from snsde_torch.train import CosineAnnealingLR, padded_index_grid
from snsde_torch.convert import grads_to_jax_layout

from torch_zoo import assert_grads_match, carry, jax_value_and_grads

B, L, D, H, LAT, GEN, LREF, K = 8, 12, 3, 8, 4, 8, 10, 2
ENC = "neuralsde_2_16"
TOL = 1e-5
KL_COEF = 0.7


def _cfg(dec, **kw):
    return tinterp.InterpolationConfig(
        enc=ENC, dec=dec, latent_dim=LAT, rec_hidden=H, gen_hidden=GEN,
        num_ref_points=LREF, k_iwae=K, verbose=False, **kw)


def _data(n, seed=0):
    return tinterp.synthetic_physionet(n=n, length=L, dim=D, seed=seed)


@module
class JaxVAE(Module):
    rec: jinterp._Recognition
    dec: Module


def _jax_vae(dec):
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    rec = jinterp._Recognition.create(k1, ENC, D, H, LAT, LREF)
    query = jnp.linspace(0.0, 1.0, LREF)
    if dec == "mtan_rnn":
        d = JMTANDecoder.create(k2, D, query, LAT, GEN, embed_time=128,
                                learn_emb=True)
    else:
        d = JDecRNN3.create(k2, D, query, LAT, GEN)
    return JaxVAE(rec=rec, dec=d)


def _jax_scatter(x, m, tp, keep):
    """snsde/harness/interpolation.py:149-166 with the keep mask given."""
    m_sub = m * keep
    x_sub = x * m_sub
    idx = jnp.clip(jnp.round(tp * LREF).astype(jnp.int32) - 1, 0, LREF - 1)
    Bc = x.shape[0]
    bidx = jnp.arange(Bc)[:, None]
    fx = jnp.zeros((Bc, LREF, D), x.dtype).at[bidx, idx].set(x_sub)
    fm = jnp.zeros((Bc, LREF, D), x.dtype).at[bidx, idx].set(m_sub)
    return fx, fm


def _jax_elbo(model, x, m, tp, keep, bm, eps, smask, std):
    """snsde/harness/interpolation.py:169-215 on injected draws."""
    times_ref = np.linspace(0.0, 1.0, LREF, dtype=np.float32)
    Bc = x.shape[0]
    fx, _ = _jax_scatter(x, m, tp, keep)
    t = jnp.asarray(times_ref, x.dtype)
    vals = jnp.concatenate(
        [jnp.broadcast_to(t[None, :, None], (Bc, LREF, 1)), fx], axis=-1)
    coeffs = jax_hermite(t, vals)
    _, stream = model.rec.sde(times_ref, coeffs, key=jax.random.PRNGKey(0),
                              bm=bm)
    out = model.rec.head(stream)
    qz_mean, qz_logvar = out[..., :LAT], out[..., LAT:]
    z0 = qz_mean[None] + eps * jnp.exp(0.5 * qz_logvar[None])
    pred = model.dec(z0.reshape((-1,) + z0.shape[2:]), jnp.tile(tp, (K, 1)))
    pred = pred.reshape((K, Bc) + pred.shape[1:])
    logpx = jnp.sum(jinterp._gaussian_logpdf(x[None], pred, std) * m[None],
                    axis=(-1, -2))
    kl = 0.5 * jnp.sum(jnp.exp(qz_logvar) + qz_mean ** 2 - 1.0 - qz_logvar,
                       axis=(-1, -2))
    iwae = jax.nn.logsumexp(logpx - KL_COEF * kl[None], axis=0) \
        - math.log(K)
    nvalid = jnp.maximum(jnp.sum(smask), 1.0)
    loss = -jnp.sum(iwae * smask) / nvalid
    obs_w = m * smask[:, None, None]
    return loss, (jnp.sum(jnp.mean(logpx, axis=0) * smask) / nvalid,
                  jnp.sum(kl * smask) / nvalid,
                  jnp.sum((jnp.mean(pred, axis=0) - x) ** 2 * obs_w),
                  jnp.sum(obs_w))


def _inputs(seed=0):
    """A batch (one padded row), its keep mask, Brownian increments on the
    encoder's grid and the samples, in numpy float32."""
    rng = np.random.default_rng(seed)
    x, m, tp = _data(B, seed)
    keep = (rng.random(m.shape) < 0.5).astype(np.float32)
    times_ref = np.linspace(0.0, 1.0, LREF, dtype=np.float32)
    grid, _ = make_grid(times_ref, resolve_dt(times_ref))
    dW = (rng.normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    eps = rng.normal(size=(K, B, LREF, LAT)).astype(np.float32)
    smask = np.ones(B, np.float32)
    smask[-1] = 0.0
    return dict(x=x, m=m, tp=tp, keep=keep, grid=grid, dW=dW, eps=eps,
                smask=smask)


def _jax_case(jm, inp, dtype, std):
    cast = lambda a: jnp.asarray(a, dtype)
    jm = jax.tree_util.tree_map(cast, jm)
    bm = JaxBrownianGrid(grid=inp["grid"], dW=cast(inp["dW"]), U=None)
    args = [cast(inp[k]) for k in ("x", "m", "tp", "keep")]

    def loss(model):
        return _jax_elbo(model, *args, bm, cast(inp["eps"]),
                         cast(inp["smask"]), std)

    def value(model):
        out = loss(model)
        return out[0], out

    aux, g = jax_value_and_grads(value, jm)
    return jax.tree_util.tree_map(np.asarray, aux), g


@pytest.fixture(scope="module")
def jax_cases():
    """{(dec, dtype): (JAX model, (loss, (logpx, kl, mse_num, mse_den)),
    gradient leaves)} at std 0.01, in float32 and float64, for both
    decoders."""
    inp = _inputs()
    out = {}
    for dec in ("mtan_rnn", "rnn3"):
        jm = _jax_vae(dec)
        out[(dec, torch.float32)] = (jm,) + _jax_case(jm, inp, jnp.float32,
                                                      0.01)
        with jax.enable_x64(True):
            out[(dec, torch.float64)] = (jm,) + _jax_case(
                jm, inp, jnp.float64, 0.01)
    return inp, out


def _port(jm, dec, dtype):
    tm = tinterp.build_interpolation_model(_cfg(dec), D, "cpu")
    carry(jm, tm)
    return tm.to(dtype)


def _port_elbo(tm, inp, dec, dtype, std=0.01):
    t = lambda k: torch.as_tensor(inp[k], dtype=dtype)
    batch = {"x": t("x"), "m": t("m"), "tp": t("tp")}
    cfg = _cfg(dec, std=std)
    return tinterp.elbo_loss(tm, batch, cfg, KL_COEF, t("smask"),
                             keep=t("keep"),
                             bm=BrownianGrid(inp["grid"], t("dW")),
                             eps=t("eps"))


def _close(ours, ref, name):
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours.detach().double() if torch.is_tensor(ours)
                      else ours, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.isfinite(ours).all(), name
    assert float(np.abs(ours - ref).max()) <= TOL * scale, (name, ours, ref)


# ---------------------------------------------------------------------------
# data, scatter, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n=8, length=12, dim=3, seed=4),
                                dict(n=5, length=62, dim=36, seed=1)])
def test_synthetic_physionet_is_jax_bit_for_bit(kw):
    for a, b in zip(tinterp.synthetic_physionet(**kw),
                    jinterp.synthetic_physionet(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_scatter_matches_jax_on_repeated_buckets():
    """Bucket 0 holds the sources t = 0 and t = 1/(L-1) (and bucket 4 two
    more): the port's explicit winner (the highest source position) is
    JAX's `.at[].set` winner on the CPU, bit for bit, with the same keep
    mask; a bucket no source hits is 0."""
    inp = _inputs()
    idx = np.clip(np.round(inp["tp"][0] * LREF).astype(np.int64) - 1, 0,
                  LREF - 1)
    assert idx[0] == idx[1] == 0 and len(set(idx)) < L
    jfx, jfm = _jax_scatter(*(jnp.asarray(inp[k])
                              for k in ("x", "m", "tp", "keep")))
    fx, fm = tinterp.scatter_to_ref(
        *(torch.as_tensor(inp[k]) for k in ("x", "m", "tp")), LREF, 0.5,
        keep=torch.as_tensor(inp["keep"]))
    assert np.array_equal(fx.numpy(), np.asarray(jfx))
    assert np.array_equal(fm.numpy(), np.asarray(jfm))


def test_known_fault_t0_observation_lost_in_bucket_0():
    """A KNOWN FAULT of the reference, kept in the port and named here,
    not approved: on a grid where t = 0 and t = 1/(L-1) share bucket 0
    (every grid the flagship and the tests use), the later source
    overwrites the t = 0 observation, so the encoder never sees a t = 0
    value whose second point is unobserved, though the data always
    observes t = 0 (snsde/harness/interpolation.py:55, 158-166)."""
    x, m, tp = _data(B)
    assert (m[:, 0, 0] == 1.0).all()
    lost = m[:, 1, 0] == 0.0
    assert lost.any()
    fx, fm = tinterp.scatter_to_ref(torch.as_tensor(x), torch.as_tensor(m),
                                    torch.as_tensor(tp), LREF, 1.0)
    jfx, jfm = _jax_scatter(jnp.asarray(x), jnp.asarray(m), jnp.asarray(tp),
                            jnp.ones_like(jnp.asarray(m)))
    for f in (fm.numpy(), np.asarray(jfm)):
        assert (f[lost, 0, 0] == 0.0).all()
    assert (fx.numpy()[lost, 0, 0] == 0.0).all()


@pytest.mark.parametrize("dec", ["mtan_rnn", "rnn3"])
def test_elbo_pieces_match_jax(jax_cases, dec):
    """float32, std 0.01: the loss, logpx, KL and the masked-MSE pieces."""
    inp, cases = jax_cases
    jm, (loss, aux), _ = cases[(dec, torch.float32)]
    with torch.no_grad():
        t_loss, t_aux = _port_elbo(_port(jm, dec, torch.float32), inp, dec,
                                   torch.float32)
    _close(t_loss, loss, "loss")
    for name, a, b in zip(("logpx", "kl", "mse_num", "mse_den"), t_aux, aux):
        _close(a, b, name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dec", ["mtan_rnn", "rnn3"])
def test_elbo_gradients_match_jax(jax_cases, dec, dtype):
    """Every parameter gradient, dec.query's included, in float64 and in
    float32 (the trap: the IWAE weights are almost one-hot at std 0.01);
    the stream's unused `linear` has a zero gradient on both sides."""
    inp, cases = jax_cases
    jm, (loss, _), g = cases[(dec, dtype)]
    tm = _port(jm, dec, dtype)
    t_loss, _ = _port_elbo(tm, inp, dec, dtype)
    _close(t_loss, loss, "loss")
    t_loss.backward()
    assert_grads_match(tm, g)
    ours = grads_to_jax_layout(tm)
    for k in ("rec.sde.linear.weight", "rec.sde.linear.bias"):
        assert not np.any(ours[k]) and not np.any(g[k]), k
    assert np.any(g["dec.query"]) == (dec == "mtan_rnn")


def test_vae_carries_every_jax_leaf():
    """_Recognition and both decoders: no JAX leaf unused, no port
    parameter unfilled (carry raises or asserts otherwise)."""
    for dec in ("mtan_rnn", "rnn3"):
        carry(_jax_vae(dec), tinterp.build_interpolation_model(_cfg(dec), D,
                                                               "cpu"))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _record(monkeypatch):
    """Record each padded_index_grid call of the harness and the rate of
    each Adam step."""
    grids, rates = [], []
    real = tinterp.padded_index_grid

    def grid(idx, bs):
        out = real(idx, bs)
        grids.append((np.asarray(idx).copy(), bs, out))
        return out

    step = torch.optim.Adam.step

    def counted(self, *a, **k):
        rates.append(self.param_groups[0]["lr"])
        return step(self, *a, **k)

    monkeypatch.setattr(tinterp, "padded_index_grid", grid)
    monkeypatch.setattr(torch.optim.Adam, "step", counted)
    return grids, rates


@pytest.mark.parametrize("dec", ["mtan_rnn", "rnn3"])
def test_run_interpolation_follows_jax_schedules(monkeypatch, dec):
    n, niters, bs = 40, 3, 16
    grids, rates = _record(monkeypatch)
    res = tinterp.run_interpolation(
        _cfg(dec, niters=niters, batch_size=bs), n=n,
        data_fn=lambda n, seed: _data(n, seed), device="cpu")
    n_tr = int(0.8 * n)
    sched = JaxCosine(lr=1e-3, t_max=10, eta_min=1e-5)
    lr, want_rates = 1e-3, []
    for itr in range(1, niters + 1):
        want = jax_padded_index_grid(
            np.random.default_rng([0, itr]).permutation(n_tr), bs)
        got = grids[itr - 1][2]
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got[:2], want[:2])) and got[2] == want[2]
        want_rates += [lr] * want[2]
        lr = sched.step()
    assert rates == want_rates
    evalg = grids[-1][2]
    want = jax_padded_index_grid(np.arange(n - n_tr), bs)
    assert np.array_equal(evalg[0], want[0])
    assert [set(h) for h in res["history"]] == [
        {"iter", "elbo", "logpx", "kl", "kl_coef"}] * niters
    assert [h["kl_coef"] for h in res["history"]] == [0.0] * niters
    assert all(np.isfinite(h["elbo"]) for h in res["history"])
    assert np.isfinite(res["test_mse"]) and res["wall_time"] > 0


def test_kl_annealing_is_jax_formula():
    for itr in range(1, 40):
        want = 0.0 if itr < 10 else 1 - 0.99 ** (itr - 10)
        assert tinterp.kl_coefficient(itr) == want
        assert tinterp.kl_coefficient(itr, use_kl=False) == 1.0


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """22 iterations straight against 20 and then a resume to 22: the last
    two ELBOs and test_mse to 1e-4 relative; the history's KL weights
    past iteration 10 are JAX's."""
    base = dict(batch_size=16)
    fn = lambda n, seed: _data(n, seed)
    full = tinterp.run_interpolation(_cfg("rnn3", niters=22, **base), n=40,
                                     data_fn=fn, device="cpu")
    tinterp.run_interpolation(_cfg("rnn3", niters=20, save_dir=str(tmp_path),
                                   **base), n=40, data_fn=fn, device="cpu")
    assert tckpt.latest_step(str(tmp_path)) == 20
    resumed = tinterp.run_interpolation(
        _cfg("rnn3", niters=22, save_dir=str(tmp_path), resume=True, **base),
        n=40, data_fn=fn, device="cpu")
    assert [h["iter"] for h in resumed["history"]] == [21, 22]
    np.testing.assert_allclose([h["elbo"] for h in resumed["history"]],
                               [h["elbo"] for h in full["history"][-2:]],
                               rtol=1e-4)
    np.testing.assert_allclose(resumed["test_mse"], full["test_mse"],
                               rtol=1e-4)
    assert [h["kl_coef"] for h in full["history"]] == [
        0.0 if i < 10 else 1 - 0.99 ** (i - 10) for i in range(1, 23)]


# ---------------------------------------------------------------------------
# padded_index_grid, CosineAnnealingLR, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(10, 4), (3, 8), (16, 16), (1, 1)])
def test_padded_index_grid_is_jax(n, bs):
    idx = np.random.default_rng(n).permutation(n)
    ours, theirs = padded_index_grid(idx, bs), jax_padded_index_grid(idx, bs)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[2] == theirs[2]


def test_cosine_annealing_matches_jax():
    ours = CosineAnnealingLR(lr=1e-3, t_max=10, eta_min=1e-5)
    theirs = JaxCosine(lr=1e-3, t_max=10, eta_min=1e-5)
    assert [ours.step() for _ in range(25)] == [theirs.step()
                                                for _ in range(25)]


def test_checkpoint_round_trip(tmp_path):
    """A model and its Adam state saved at two steps, loaded in place into
    fresh objects from the latest: every tensor equal, JAX's layout
    (step_{n}/, meta.json with the step and the sorted names)."""
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Tanh(),
                                torch.nn.Linear(4, 2))
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    d = str(tmp_path / "ck")
    m, opt = make(0)
    for step in (1, 2):
        m(torch.ones(5, 3)).square().sum().backward()
        opt.step()
        tckpt.save_checkpoint(d, step * 10, model=m, opt_state=opt)
    assert tckpt.latest_step(d) == 20
    assert sorted(os.listdir(d)) == ["step_10", "step_20"]
    with open(os.path.join(d, "step_20", "meta.json")) as f:
        assert json.load(f) == {"step": 20, "names": ["model", "opt_state"]}
    m2, opt2 = make(1)
    loaded, step = tckpt.load_checkpoint(d, {"model": m2, "opt_state": opt2})
    assert step == 20 and loaded["model"] is m2 and loaded["opt_state"] is opt2
    for a, b in zip(m.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(a, b)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for k in s1:
        for name in s1[k]:
            assert torch.equal(torch.as_tensor(s1[k][name]),
                               torch.as_tensor(s2[k][name]))
    _, step = tckpt.load_checkpoint(d, {"model": m2}, step=10)
    assert step == 10


def test_checkpoint_missing_raises_as_jax(tmp_path):
    for mod in (tckpt, jckpt):
        assert mod.latest_step(str(tmp_path / "none")) is None
        (tmp_path / "empty").mkdir(exist_ok=True)
        assert mod.latest_step(str(tmp_path / "empty")) is None
        with pytest.raises(FileNotFoundError):
            mod.load_checkpoint(str(tmp_path / "empty"), {})


# ---------------------------------------------------------------------------
# physionet2012
# ---------------------------------------------------------------------------

def _record_text(rng, rid):
    lines = ["Time,Parameter,Value", "00:00,RecordID," + str(rid),
             "00:00,Age,54"]
    for _ in range(25):
        h, mnt = int(rng.integers(0, 48)), int(rng.integers(0, 60))
        p = jphys.PARAMS[int(rng.integers(0, len(jphys.PARAMS)))]
        lines.append(f"{h:02d}:{mnt:02d},{p},{rng.normal() * 10:.3f}")
    lines += ["12:xx,HR,80", "bad line", "47:59,HR,notanumber",
              "48:00,Temp,37.1"]
    return "\n".join(lines) + "\n"


def _write_archives(root):
    rng = np.random.default_rng(0)
    for a, url in enumerate(jphys.URLS):
        with tarfile.open(os.path.join(root, os.path.basename(url)),
                          "w:gz") as tf:
            for i in range(3):
                for name, text in ((f"set/{a}{i}.txt",
                                    _record_text(rng, 130000 + i)),
                                   (f"set/{a}{i}.csv", "not,a,record\n"),
                                   (f"set/{a}e{i}.txt",
                                    "Time,Parameter,Value\n")):
                    raw = text.encode()
                    info = tarfile.TarInfo(name)
                    info.size = len(raw)
                    tf.addfile(info, io.BytesIO(raw))


def test_physionet2012_matches_jax(tmp_path):
    assert tphys.PARAMS == jphys.PARAMS and tphys.QUANT == jphys.QUANT
    assert tphys.URLS == jphys.URLS
    text = _record_text(np.random.default_rng(1), 1)
    assert tphys.parse_record(text) == jphys.parse_record(text)
    for a, b in zip(tphys.record_to_grid(jphys.parse_record(text)),
                    jphys.record_to_grid(jphys.parse_record(text))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _write_archives(str(tmp_path))
    ours = tphys.load_from_archives(str(tmp_path))
    theirs = jphys.load_from_archives(str(tmp_path))
    assert ours[0].shape == (6, 62, 36)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tphys.get_data(str(tmp_path)), theirs):
        assert np.array_equal(a, b)


def test_physionet2012_fallback_is_synthetic_physionet(tmp_path):
    d = str(tmp_path / "missing")
    ours = tphys.get_data(d, n_synthetic=16, seed=3)
    for a, b, c in zip(ours, jphys.get_data(d, n_synthetic=16, seed=3),
                       tinterp.synthetic_physionet(n=16, seed=3)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    with pytest.raises(FileNotFoundError):
        tphys.get_data(d, synthetic_fallback=False)
