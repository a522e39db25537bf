"""The port's native data library (snsde_torch/data/native.py and its own
copy of the C++ source, snsde_torch/_native/) on the CPU.

The port's library against the JAX package's snsde/data/native.py on the
same inputs, bit for bit (the source is the same), and against the port's
Python versions to 1e-5 (of max(1, the Python version's largest entry));
`parse_psv` takes the native parser first, as snsde/data/sepsis.py:37
does. The library is built with the host's g++: the tests skip only where
there is none.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import shutil

import numpy as np
import pytest
import torch

import snsde.data.native as jax_native
import snsde_torch.data.native as native
from snsde_torch.data import native_lib
from snsde_torch.data import sepsis as port_sepsis
from snsde_torch.harness.robustness import preprocess_ists
from snsde_torch.ops.interp import (CubicPath, hermite_cubic_coeffs,
                                    natural_cubic_coeffs)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler on this host")

PSV = (b"HR|O2Sat|Temp|ICULOS|SepsisLabel\n80|97|36.5|1|0\n|96||2|1\n"
       b"NaN|95|37.25|3|1\n81.5|1e2|-0.5e1|4\n7x|.5|+3|5|0\n")


def _series(seed=0, B=4, L=10, C=2, missing=0.25):
    rng = np.random.default_rng(seed)
    times = np.linspace(0, 1, L).astype(np.float32)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[rng.random((B, L, C)) < missing] = np.nan
    return times, x


def _close(a, ref, tol=1e-5):
    bound = tol * max(1.0, float(np.nanmax(np.abs(ref))))
    assert np.array_equal(np.isnan(a), np.isnan(ref))
    assert float(np.nanmax(np.abs(a - ref))) <= bound


def test_library_builds_and_loads():
    lib = native_lib()
    assert lib is not None
    assert native.get_lib() is lib
    assert native._lib_path().startswith(native._BUILD_DIR)


@pytest.mark.parametrize("entry", ["natural_cubic_coeffs_native",
                                   "hermite_coeffs_native"])
@pytest.mark.parametrize("missing", [0.0, 0.25])
def test_coefficients_bit_for_bit_jax_native(entry, missing):
    times, x = _series(missing=missing)
    a = getattr(native, entry)(times, x)
    b = getattr(jax_native, entry)(times, x)
    assert a is not None and b is not None
    np.testing.assert_array_equal(a, b)


def test_delta_missingness_and_psv_bit_for_bit_jax_native():
    times, x = _series()
    mask = np.isfinite(x).astype(np.float32)
    np.testing.assert_array_equal(native.compute_delta_native(times, mask),
                                  jax_native.compute_delta_native(times, mask))
    np.testing.assert_array_equal(
        native.inject_missingness_native(x, 0.3, 17),
        jax_native.inject_missingness_native(x, 0.3, 17))
    (a, na), (b, nb) = (native.parse_psv_native(PSV, 512, 64),
                        jax_native.parse_psv_native(PSV, 512, 64))
    assert na == nb == 5
    np.testing.assert_array_equal(a, b)


def test_hermite_matches_the_ports_python_version():
    times, x = _series()
    ref = hermite_cubic_coeffs(torch.as_tensor(times),
                               torch.as_tensor(x)).numpy()
    _close(native.hermite_coeffs_native(times, x), ref)


@pytest.mark.parametrize("missing", [0.0, 0.25])
def test_natural_cubic_matches_the_ports_python_version(missing):
    """The coefficients on a complete series; with missing values the
    splines they define, evaluated on a fine grid (the two fits solve the
    NaN-aware system in different orders, so a near-singular interval's
    coefficients differ in float32 while the curve does not)."""
    times, x = _series(missing=missing)
    got = native.natural_cubic_coeffs_native(times, x)
    ref = natural_cubic_coeffs(torch.as_tensor(times), torch.as_tensor(x),
                               pack=True).numpy()
    if missing == 0.0:
        _close(got, ref)
        return
    ts = torch.linspace(0.0, 1.0, 33)
    tt = torch.as_tensor(times)
    vals = [torch.stack([CubicPath(torch.as_tensor(c), tt).evaluate(t)
                         for t in ts]).numpy() for c in (got, ref)]
    _close(vals[0], vals[1], tol=1e-4)


def test_delta_matches_preprocess_ists():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 8, 2)).astype(np.float32)
    X[rng.random(X.shape) < 0.4] = np.nan
    d = preprocess_ists(X, missing_rate=0.0)
    times = np.linspace(0, 1, 8, dtype=np.float32)
    _close(native.compute_delta_native(times, d["seq"][:, 1]),
           d["seq"][:, 2])


def test_missingness_keeps_the_first_observation():
    _, x = _series(missing=0.0, B=5, L=20, C=3)
    out = native.inject_missingness_native(x, 0.5, 3)
    assert np.isfinite(out[:, 0]).all()
    np.testing.assert_array_equal(np.isnan(out).sum(axis=1), 10)
    np.testing.assert_array_equal(out[np.isfinite(out)], x[np.isfinite(out)])


def test_parse_psv_takes_the_native_parser(monkeypatch):
    calls = []

    def spy(text, max_rows, max_cols):
        calls.append((max_rows, max_cols))
        return native.parse_psv_native(text, max_rows, max_cols)

    monkeypatch.setattr(port_sepsis, "parse_psv_native", spy)
    values, header = port_sepsis.parse_psv(PSV)
    assert calls == [(512, 64)]
    assert header == ["HR", "O2Sat", "Temp", "ICULOS", "SepsisLabel"]
    monkeypatch.setattr(port_sepsis, "parse_psv_native", lambda *a, **k: None)
    py_values, py_header = port_sepsis.parse_psv(PSV)
    assert py_header == header
    _close(values, py_values)


def test_disabled_or_without_a_toolchain_is_none(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("SNSDE_NATIVE", "0")
    assert native.get_lib() is None
    assert native.hermite_coeffs_native(*_series()) is None
    assert native.parse_psv_native(PSV) is None
    monkeypatch.delenv("SNSDE_NATIVE")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: str(tmp_path / "libsnsde_data_x.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None
    values, _ = port_sepsis.parse_psv(PSV)       # the Python parser
    assert values.shape == (5, 5)
