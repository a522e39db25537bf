"""The port's archive loaders against the JAX package, on the CPU, on
files the tests write (no archive is in the repository and nothing
downloads one): PhysioNet 2019's `.psv` records in the two training
zips, and UEA `.ts` files, loose and in `Multivariate2018_ts.zip`.
Every array must equal JAX's bit for bit (NaNs in the same places). Also
the `.npz` cache, the synthetic fallbacks and `run_sepsis` on a loader.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import os
import zipfile

import numpy as np
import pytest

from snsde.data import common as jcommon
from snsde.data import sepsis as jsepsis
from snsde.data import uea as juea

from snsde_torch.data import common as tcommon
from snsde_torch.data import sepsis as tsepsis
from snsde_torch.data import uea as tuea
from snsde_torch.data.synthetic import synthetic_sepsis, synthetic_uea

TS_NAMES = [f"V{i}" for i in range(34)]
HEADER = TS_NAMES + ["Age", "Gender", "Unit1", "Unit2", "HospAdmTime",
                     "ICULOS", "SepsisLabel"]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True)


def _psv(rng, rows, label, first_hour=1, drop=()):
    """One record: hourly ICULOS from first_hour, values with NaN and
    empty fields, demographics, the label switching on late."""
    header = [h for h in HEADER if h not in drop]
    lines = ["|".join(header)]
    for r in range(rows):
        vals = []
        for h in header:
            if h == "ICULOS":
                vals.append(str(first_hour + r))
            elif h == "SepsisLabel":
                vals.append(str(int(label and r >= rows // 2)))
            elif h in ("Age", "Gender", "Unit1", "Unit2", "HospAdmTime"):
                vals.append("NaN" if r == 0 and h == "Unit2"
                            else f"{rng.uniform(-50, 90):.2f}")
            else:
                u = rng.random()
                vals.append("NaN" if u < 0.5 else "" if u < 0.55
                            else f"{rng.normal(80, 20):.3f}")
        lines.append("|".join(vals))
    return ("\n".join(lines) + "\n").encode()


def _write_sepsis(tmp_path, n=24, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        rows = int(rng.integers(3, 90))               # past 72 h sometimes
        recs.append(_psv(rng, rows, label=i % 4 == 0,
                         first_hour=int(rng.integers(1, 4)),
                         drop=("Unit1",) if i == 5 else ()))
    recs.append(_psv(rng, 4, 0, first_hour=80))       # no hour in 1..72
    for k, name in enumerate(tsepsis.ARCHIVES):
        with zipfile.ZipFile(tmp_path / name, "w") as zf:
            for i, rec in enumerate(recs[k::2]):
                zf.writestr(f"training/p{k}{i:05d}.psv", rec)
            zf.writestr("training/README.txt", "not a record")
    return recs


def test_parse_psv_and_process_record_match_jax(tmp_path):
    from snsde.data.native import get_lib

    recs = _write_sepsis(tmp_path, n=10)
    if get_lib() is not None:
        # the native parser's edges (JAX's Python fallback rejects a short
        # row): no final newline, CRLF, a blank line, a short row, a field
        # strtof reads as 0
        recs += [b"A|B\n1|2", b"A|B|C\r\n1.5|NaN|2\r\n",
                 b"A|B\n1|\n\n3|x4\n", b"A|B|C\n1\n"]
    for rec in recs:
        got, header = tsepsis.parse_psv(rec)
        want, jheader = jsepsis.parse_psv(rec)
        assert header == jheader
        _same(got, want)
        if "ICULOS" in header:
            g = tsepsis._process_record(got, header)
            w = jsepsis._process_record(want, jheader)
            assert (g is None) == (w is None)
            if g is not None:
                _same(g[0], w[0])
                _same(g[1], w[1])
                assert g[2] == w[2]


def test_load_from_archives_matches_jax(tmp_path):
    _write_sepsis(tmp_path)
    got = tsepsis.load_from_archives(str(tmp_path))
    want = jsepsis.load_from_archives(str(tmp_path))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].shape == (24, 72, 34) and set(got[2]) == {0, 1}
    os.remove(tmp_path / tsepsis.ARCHIVES[1])
    with pytest.raises(FileNotFoundError):
        tsepsis.load_from_archives(str(tmp_path))


def test_sepsis_get_data_caches_and_falls_back(tmp_path):
    _write_sepsis(tmp_path)
    first = tsepsis.get_data(str(tmp_path))
    cache = tcommon.cache_path("sepsis_parsed", str(tmp_path))
    assert os.path.exists(cache) and cache.endswith(".npz")
    os.remove(tmp_path / tsepsis.ARCHIVES[0])          # the cache serves
    for g, w in zip(tsepsis.get_data(str(tmp_path)), first):
        _same(g, w)
    empty = tmp_path / "empty"
    empty.mkdir()
    for where in (None, str(empty)):
        for g, w in zip(tsepsis.get_data(where, n_synthetic=40, seed=3),
                        synthetic_sepsis(n=40, seed=3)):
            _same(g, w)
    with pytest.raises(FileNotFoundError):
        tsepsis.get_data(str(empty), synthetic_fallback=False)
    assert not os.listdir(empty)


def test_run_sepsis_takes_the_loader(tmp_path):
    """run_sepsis(data_fn=loader(dir)) trains on the parsed archives."""
    from snsde_torch.harness.classification import HarnessConfig, run_sepsis

    _write_sepsis(tmp_path, n=40)
    cfg = HarnessConfig(hidden_channels=4, hidden_hidden_channels=4,
                        num_hidden_layers=1, batch_size=16)
    res = run_sepsis(cfg, n=8, data_fn=tsepsis.loader(str(tmp_path)),
                     max_epochs=1, device="cpu")
    assert len(res.history) == 1
    assert np.isfinite(res.train_metrics.loss)
    assert res.model.linear1.in_features == 5          # the static width


def _ts(path, cases, labels, name="Toy"):
    lines = [f"@problemName {name}", "@timeStamps false",
             "@univariate false", f"@classLabel true {' '.join(labels)}",
             "# a comment", "@data"]
    for dims, lab in cases:
        lines.append(":".join(",".join(v for v in d) for d in dims)
                     + f":{lab}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n\n")


def _ts_cases(rng, n):
    cases = []
    for i in range(n):
        length = int(rng.integers(5, 12))
        d0 = [f"{v:.4f}" for v in rng.normal(size=length)]
        d1 = [f"{v:.3f}" if rng.random() > 0.2 else "?"
              for v in rng.normal(size=length + 2)]
        d2 = ["?"] * 3 + ["1.5"] if i == 1 else (["2.0"] if i == 2 else
                                                  [f"{v:.2f}" for v in
                                                   rng.normal(size=length)])
        cases.append(((d0, d1, d2), ["walk", "run", "jump"][i % 3]))
    return cases


def _write_uea(root, name="Toy", seed=0):
    rng = np.random.default_rng(seed)
    _ts(root / name / f"{name}_TRAIN.ts", _ts_cases(rng, 9), ["walk", "run",
                                                               "jump"], name)
    _ts(root / name / f"{name}_TEST.ts", _ts_cases(rng, 5), ["walk", "run",
                                                              "jump"], name)


def test_parse_ts_and_equal_length_match_jax(tmp_path):
    _write_uea(tmp_path)
    p = str(tmp_path / "Toy" / "Toy_TRAIN.ts")
    cases, labels = tuea.parse_ts_file(p)
    jcases, jlabels = juea.parse_ts_file(p)
    assert labels == jlabels and len(cases) == len(jcases) == 9
    for c, jc in zip(cases, jcases):
        for d, jd in zip(c, jc):
            _same(d, jd)
    for target in (None, 7, 15):
        _same(tuea.equal_length(cases, target),
              juea.equal_length(jcases, target))


def test_load_dataset_matches_jax_loose_and_from_the_zip(tmp_path):
    loose = tmp_path / "loose"
    _write_uea(loose)
    got, want = (tuea.load_dataset("Toy", str(loose)),
                 juea.load_dataset("Toy", str(loose)))
    _same(got[0], want[0])
    _same(got[1], want[1])
    # the archive: members under Multivariate_ts/<name>/, a member
    # climbing out with '..' and an absolute one skipped
    zdir = tmp_path / "zipped"
    zdir.mkdir()
    with zipfile.ZipFile(zdir / tuea.ARCHIVE, "w") as zf:
        for split in ("TRAIN", "TEST"):
            zf.write(loose / "Toy" / f"Toy_{split}.ts",
                     f"Multivariate_ts/Toy/Toy_{split}.ts")
        zf.writestr("Multivariate_ts/Toy/../../Toy/evil.ts", "x")
        zf.writestr("/Toy/abs.ts", "x")
        zf.writestr("Multivariate_ts/Other/Other_TRAIN.ts", "x")
    for label, mod in (("port", tuea), ("jax", juea)):
        d = tmp_path / label
        d.mkdir()
        os.link(zdir / tuea.ARCHIVE, d / tuea.ARCHIVE)
        X, y = mod.load_dataset("Toy", str(d))
        _same(X, want[0])
        _same(y, want[1])
        assert sorted(os.listdir(d / "Toy")) == ["Toy_TEST.ts",
                                                 "Toy_TRAIN.ts"]
        assert sorted(os.listdir(d)) == ["Multivariate2018_ts.zip", "Toy"]
    with pytest.raises(FileNotFoundError):
        tuea.load_dataset("Missing", str(tmp_path / "port"))


def test_uea_get_data_caches_and_falls_back(tmp_path):
    _write_uea(tmp_path)
    X, y, times = tuea.get_data("Toy", str(tmp_path))
    assert X.shape == (14, 13, 3) and times.dtype == np.float32
    _same(times, np.linspace(0.0, 1.0, 13, dtype=np.float32))
    cache = tcommon.cache_path("uea", str(tmp_path), dataset="Toy")
    assert os.path.exists(cache)
    os.remove(tmp_path / "Toy" / "Toy_TRAIN.ts")
    for g, w in zip(tuea.get_data("Toy", str(tmp_path)), (X, y, times)):
        _same(g, w)
    for where in (None, str(tmp_path / "nothing")):
        for g, w in zip(tuea.get_data("Toy", where, n_synthetic=30, seed=2),
                        synthetic_uea(n=30, seed=2)):
            _same(g, w)
    with pytest.raises(FileNotFoundError):
        tuea.get_data("Other", str(tmp_path), synthetic_fallback=False)


def test_npz_cache_round_trip(tmp_path):
    arrays = (np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([np.nan, 1.0]), np.array([3], np.int64))
    path = tcommon.cache_path("thing", str(tmp_path / "c"), a=1, b="x")
    assert tcommon.load_cached(path) is None
    tcommon.save_cached(path, arrays)
    back = tcommon.load_cached(path)
    assert isinstance(back, tuple) and len(back) == 3
    for g, w in zip(back, arrays):
        _same(g, w)
    # JAX's name and hash, with .npz for .pkl: the two never collide
    jname = os.path.basename(jcommon.cache_path("thing", a=1, b="x"))
    assert os.path.basename(path) == jname[:-len(".pkl")] + ".npz"
