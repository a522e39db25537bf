"""Speech Commands, port against the JAX package, on the CPU.

The data: `mfcc` against the torch-frozen goldens (tests/goldens/mfcc.npz,
atol 1e-3 as tests/test_goldens.py holds the JAX one) and bit for bit
against the JAX package's (the same numpy arithmetic); `synthetic_speech`
bit for bit; `load_from_archive` on a .tar.gz of WAVs the test writes (two
keyword folders and a folder that is skipped) against the JAX loader;
`get_data`'s .npz cache and its missing-archive behaviour. The training
policy: the multiclass loss (masked softmax cross-entropy + 0.01 L2) and
every gradient of a tiny speech NeuralSDE, carried across by
snsde_torch.convert, against the JAX fit_classifier's loss (loop.py:
276-291) on the same injected increments, through the eager solver and the
EM kernels' plain route (loss 1e-5 relative, gradients 1e-4 of their
largest entry). And the three harness entry points end to end at a tiny
width and batch: run_speech, run_speech_ensemble (two members) and
run_all(task="speech") with its record names and resume.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import io
import json
import os
import tarfile
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snsde.data import speech_commands as jsc
from snsde.data.synthetic import synthetic_speech as jax_synthetic_speech
from snsde.harness.classification import make_sde_model as jax_make_sde
from snsde.nn.core import filter_value_and_grad
from snsde.nn.layers import Dropout as JaxDropout
from snsde.ops.brownian import BrownianGrid as JaxBrownianGrid
from snsde.ops.interp import hermite_cubic_coeffs as jax_hermite
from snsde.train import loop as jloop

from snsde_torch.convert import grads_to_jax_layout, load_jax_arrays
from snsde_torch.data import speech_commands as tsc
from snsde_torch.data import synthetic_speech
from snsde_torch.harness import classification as tcls
from snsde_torch.kernels.fused_em import fused_em_solve
from snsde_torch.models import neuralsde as tsde
from snsde_torch.ops import BrownianGrid, make_grid
from snsde_torch.train import loop as tloop

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "mfcc.npz")
B, L, C, H, K = 12, 8, 4, 6, 10


@pytest.mark.parametrize("name", ["harmonic", "noise", "chirp", "click"])
def test_mfcc_matches_goldens_and_jax(name):
    data = np.load(GOLDENS)
    ours = tsc.mfcc(data[f"wave_{name}"])
    assert ours.shape == (161, 20) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, data[f"mfcc_{name}"], atol=1e-3)
    np.testing.assert_array_equal(ours, jsc.mfcc(data[f"wave_{name}"]))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_speech_matches_jax(seed):
    ours = synthetic_speech(n=30, length=17, seed=seed)
    theirs = jax_synthetic_speech(n=30, length=17, seed=seed)
    assert ours[0].shape == (30, 17, 20)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _wav(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.astype(np.int16).tobytes())
    return buf.getvalue()


def _write_archive(data_dir):
    """speech_commands_v0.02.tar.gz with three clips under yes/, two under
    no/ (one short, zero-padded; one long, cut) and two under
    _background_noise_/ (not a keyword: skipped)."""
    rng = np.random.default_rng(0)
    clips = {"yes/a.wav": 16000, "yes/b.wav": 16000, "yes/c.wav": 16000,
             "no/a.wav": 9000, "no/b.wav": 17000,
             "_background_noise_/a.wav": 16000,
             "_background_noise_/b.wav": 4000}
    path = os.path.join(data_dir, tsc.ARCHIVE)
    with tarfile.open(path, "w:gz") as tf:
        for name, n in clips.items():
            blob = _wav(rng.integers(-8000, 8000, n))
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
        info = tarfile.TarInfo("yes/README.txt")
        info.size = 2
        tf.addfile(info, io.BytesIO(b"hi"))
    return path


def test_load_from_archive_matches_jax(tmp_path):
    _write_archive(str(tmp_path))
    X, y, lengths, times = tsc.load_from_archive(str(tmp_path))
    assert X.shape == (5, 161, 20)
    np.testing.assert_array_equal(y, [0, 0, 0, 1, 1])
    np.testing.assert_array_equal(lengths, np.full(5, 161))
    np.testing.assert_array_equal(times, np.arange(161, dtype=np.float32))
    for a, b in zip((X, y, lengths, times),
                    jsc.load_from_archive(str(tmp_path))):
        np.testing.assert_array_equal(a, b)


def test_get_data_caches_as_npz_and_falls_back(tmp_path):
    """The first call reads the archive and writes speech_mfcc.npz; the
    second reads the cache (the archive gone); with no archive, the
    synthetic data, or FileNotFoundError when told not to fall back."""
    archive = _write_archive(str(tmp_path))
    first = tsc.get_data(str(tmp_path))
    assert os.path.exists(os.path.join(str(tmp_path), "speech_mfcc.npz"))
    assert not list(tmp_path.glob("*.pkl"))
    os.remove(archive)
    for a, b in zip(tsc.get_data(str(tmp_path)), first):
        np.testing.assert_array_equal(a, b)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match=tsc.ARCHIVE):
        tsc.get_data(str(empty), synthetic_fallback=False)
    with pytest.raises(FileNotFoundError):
        tsc.get_data(None, synthetic_fallback=False)
    for a, b in zip(tsc.get_data(str(empty), n_synthetic=20, seed=2),
                    synthetic_speech(n=20, seed=2)):
        np.testing.assert_array_equal(a, b)


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


@pytest.fixture(scope="module")
def speech_setup():
    rng = np.random.default_rng(0)
    times = np.arange(L, dtype=np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    coeffs = np.array(jax_hermite(jnp.asarray(times), jnp.asarray(x)))
    y = rng.integers(0, K, B).astype(np.int64)
    final_index = np.full(B, L - 1, np.int64)
    mask = np.ones(B, np.float32)
    mask[-4:] = 0.0               # a padded final batch: 4 wrapped rows
    grid, _ = make_grid(times, 1.0)
    dW = (rng.normal(size=(len(grid) - 1, B, H))
          * np.sqrt(np.diff(grid))[:, None, None]).astype(np.float32)
    jm, _ = jax_make_sde(jax.random.PRNGKey(0), "neurallnsde", C, H, H, 2, K,
                         initial=True)
    jm = jm.replace(readout=jm.readout.replace(dropout=JaxDropout(rate=0.0)))
    return jm, dict(times=times, coeffs=coeffs, y=y, mask=mask,
                    final_index=final_index, grid=grid, dW=dW)


@pytest.mark.parametrize("route", ["eager", "fused"])
def test_multiclass_loss_and_every_grad_match_jax(speech_setup, route,
                                                  monkeypatch):
    """make_loss_fn with num_classes=10 (masked softmax cross-entropy +
    0.01 L2 on the field) in train mode against the JAX fit_classifier's
    loss on the same increments: through the eager solver, or through the
    EM kernels' autograd.Function on its plain versions (the route a CUDA
    tensor takes)."""
    jm, d = speech_setup
    jbm = JaxBrownianGrid(grid=jnp.asarray(d["grid"]), dW=jnp.asarray(d["dW"]),
                          U=None)

    def jloss(m):
        logits, _ = m(d["times"], jnp.asarray(d["coeffs"]),
                      jnp.asarray(d["final_index"]),
                      key=jax.random.PRNGKey(0), train=True, bm=jbm)
        per = jloop.softmax_cross_entropy_per_sample(logits,
                                                     jnp.asarray(d["y"]))
        mask = jnp.asarray(d["mask"])
        loss = jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0)
        return loss + jloop.weight_regularization(m.func, 0.01)

    loss_j, g_j = filter_value_and_grad(jloss)(jm)
    if route == "fused":
        def dispatch(func, path, times, y0, *, generator, dt, method, bm,
                     use_fused=True):
            return fused_em_solve(func, path, times, y0, dt=dt,
                                  dW_override=bm.dW)

        monkeypatch.setattr(tsde, "solve_dispatch", dispatch)
    model, reg_fn = tcls.make_sde_model("neurallnsde", C, H, H, 2, K)
    model.readout.dropout.rate = 0.0
    load_jax_arrays(model, jax_arrays(jm))
    model.train()
    bm = BrownianGrid(d["grid"], torch.as_tensor(d["dW"]))

    def apply_fn(m, batch, generator):
        return m(d["times"], batch["coeffs"], batch["final_index"],
                 generator=generator, bm=bm)

    loss_fn = tloop.make_loss_fn(apply_fn, reg_fn,
                                 tloop.TrainConfig(num_classes=K))
    batch = {"coeffs": torch.as_tensor(d["coeffs"]),
             "final_index": torch.as_tensor(d["final_index"]),
             "y": torch.as_tensor(d["y"]),
             "_mask": torch.as_tensor(d["mask"])}
    loss_t, logits = loss_fn(model, batch, None)
    assert logits.shape == (B, K)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    ours, theirs = grads_to_jax_layout(model), jax_arrays(g_j)
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        # readout.linear1.bias: 0 in truth (train-mode BatchNorm right
        # after it), float32 noise on both sides
        floor = 1e-7 if name == "readout.linear1.bias" else 0.0
        err = float(np.abs(ours[name] - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + floor, (
            f"{route} grad {name}: abs err {err:.2e}")


def _short(n, seed):
    """Speech-shaped data at 12 steps (the harness runs check training,
    not the 161-step shape)."""
    return synthetic_speech(n=n, length=12, seed=seed)


CFG = tcls.HarnessConfig(hidden_channels=5, hidden_hidden_channels=5,
                         num_hidden_layers=1, batch_size=16)


def test_run_speech_trains_on_the_cpu():
    res = tcls.run_speech(CFG, n=60, data_fn=_short, max_epochs=2,
                          device="cpu")
    assert len(res.history) == 2
    assert np.isfinite(res.test_metrics.loss)
    assert res.test_metrics.auroc is None
    assert len(res.test_metrics.confusion) == 10
    assert res.model.readout.linear2.out_features == 10
    # z0 from the initial network on 20 MFCC channels and time, no
    # intensity
    assert res.model.initial_network.in_features == 21


def test_run_speech_ensemble_trains_two_members(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(CFG, results_dir=str(tmp_path))
    results = tcls.run_speech_ensemble(cfg, repeats=2, n=60, data_fn=_short,
                                       max_epochs=2, device="cpu")
    assert len(results) == 2
    for res in results:
        assert np.isfinite(res.test_metrics.loss)
        assert len(res.history) == 2
    m = results[0].model
    assert m.readouts[0].linear2.out_features == 10
    assert not torch.equal(m.fields[0].linear_out.weight,
                           m.fields[1].linear_out.weight)
    recs = sorted((tmp_path / "speech-neurallnsde-packed").iterdir())
    assert [r.name for r in recs] == ["0", "1"]


def test_run_all_speech_names_records_and_resumes(tmp_path, monkeypatch):
    """run_all(task="speech") writes speech-<model>-h<H>-l<layers>-i<0|1>
    records, trains each repeat solo even with pack_repeats (as the JAX
    run_all), and resumes from its records."""
    import dataclasses

    calls = []
    real = tcls.run_speech

    def short_speech(cfg, n, device=None):
        calls.append((cfg.model_name, cfg.hidden_channels, cfg.seed,
                      cfg.data_seed))
        return real(dataclasses.replace(cfg, batch_size=16), n=n,
                    data_fn=_short, max_epochs=1, device=device)

    monkeypatch.setattr(tcls, "run_speech", short_speech)
    kw = dict(task="speech", models=("neurallsde",), hidden_list=(5,),
              layer_list=(1,), repeats=2, intensities=(False,), n=48,
              max_epochs=1, results_dir=str(tmp_path), pack_repeats=True,
              device="cpu")
    got = tcls.run_all(**kw)
    assert [name for name, _ in got] == ["speech-neurallsde-h5-l1-i0"] * 2
    assert calls == [("neurallsde", 5, 0, 0), ("neurallsde", 5, 1, 0)]
    recs = sorted((tmp_path / "speech-neurallsde-h5-l1-i0").iterdir())
    assert [r.name for r in recs] == ["0", "1"]
    assert "test_metrics" in json.loads(recs[0].read_text())
    assert tcls.run_all(**kw) == []
    with pytest.raises(ValueError, match="sepsis"):
        tcls.run_all(**{**kw, "task": "uea"})
