"""The port's log-signatures (snsde_torch/ops/logsig.py) against the JAX
package on the CPU: the Lyndon basis and channel counts, `logsig_windows`
at depths 1-3 (a length whose last window is cut, and one that fills its
windows), and, without JAX, the Lévy areas of the depth-2 block against
their closed form on a piecewise-linear path in float64.

Tolerances: the features to 1e-5 of their largest entry (the same float32
einsums in another order); the Lévy areas to 1e-12 (float64).
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snsde.ops import logsig as jlogsig

from snsde_torch.ops import (logsig_windows, logsignature_channels,
                             lyndon_words)

TOL = 1e-5


def test_lyndon_words_and_channels_match_jax():
    for d in range(1, 5):
        for depth in (1, 2, 3):
            words = lyndon_words(d, depth)
            assert words == jlogsig.lyndon_words(d, depth), (d, depth)
            n = logsignature_channels(d, depth)
            assert n == jlogsig.logsignature_channels(d, depth) == len(words)
    with pytest.raises(ValueError, match="depth"):
        logsignature_channels(3, 4)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("L", [12, 9])
def test_logsig_windows_match_jax(depth, L):
    """L=12 uses 9 points (two windows of 4, the last 3 points cut), L=9
    all of them: new_times (host float32, every 4th knot) exactly, the
    features to 1e-5 of their largest entry."""
    rng = np.random.default_rng(depth * 10 + L)
    B, d = 4, 3
    path = rng.normal(size=(B, L, d)).astype(np.float32)
    times = np.sort(rng.uniform(0, 2, L)).astype(np.float32)
    t_j, f_j = jlogsig.logsig_windows(jnp.asarray(path), depth, 4,
                                      times=jnp.asarray(times))
    t_t, f_t = logsig_windows(torch.as_tensor(path), depth, 4, times=times)
    assert isinstance(t_t, np.ndarray) and t_t.dtype == np.float32
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_array_equal(t_t, times[:9][::4])
    C = logsignature_channels(d, depth)
    assert f_t.shape == (B, 3, C)
    f_j = np.asarray(f_j)
    err = float(np.abs(f_t.numpy() - f_j).max())
    assert err <= TOL * float(np.abs(f_j).max()), err
    # the basepoint and the cumulative depth-1 block
    np.testing.assert_allclose(f_t[:, 0, :d].numpy(), path[:, 0], atol=0)
    np.testing.assert_allclose(f_t[:, -1, :d].numpy(), path[:, 8],
                               atol=1e-5)
    # no times: the window index
    t_n, _ = logsig_windows(torch.as_tensor(path), depth, 4)
    np.testing.assert_array_equal(t_n, np.arange(3, dtype=np.float32))


def test_levy_area_block_is_the_closed_form():
    """At depth 2 a window's Lyndon coordinate (i, j), i < j, is the Lévy
    area ½ Σ_k (x_k Δy_k - y_k Δx_k) of channels x = i, y = j, each point
    taken about the window's start, on the piecewise-linear path through
    the window's 5 points (float64; the port alone). The JAX package's
    values agree with the port's (test_logsig_windows_match_jax)."""
    rng = np.random.default_rng(7)
    B, L, d = 3, 13, 4
    path = rng.normal(size=(B, L, d))
    _, feats = logsig_windows(torch.as_tensor(path), 2, 4)
    assert feats.dtype == torch.float64
    iu = np.triu_indices(d, k=1)
    for w in range(3):
        win = path[:, 4 * w:4 * w + 5] - path[:, 4 * w:4 * w + 1]
        inc = np.diff(win, axis=1)                     # [B, 4, d]
        start = win[:, :-1]
        area = 0.5 * (np.einsum("bki,bkj->bij", start, inc)
                      - np.einsum("bkj,bki->bij", start, inc))
        np.testing.assert_allclose(feats[:, w + 1, d:].numpy(),
                                   area[:, iu[0], iu[1]], atol=1e-12)
