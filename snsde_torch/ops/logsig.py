"""Truncated log-signatures over sliding windows (counterpart of
snsde/ops/logsig.py), the control stream of the Neural RDE.

For a piecewise-linear path the signature of each linear piece with
increment v is exp(v) in the truncated tensor algebra (1, v, v⊗v/2,
v⊗v⊗v/6); a window's signature combines its pieces by Chen's relation, and
log is the truncated tensor-series logarithm. Coordinates are reported in
the Lyndon-word basis, ordered by length, then lexicographically:
  depth 1: d channels (increments)
  depth 2: + d(d-1)/2   (Lévy areas, words ij with i<j)
  depth 3: + (d^3 - d)/3 (Lyndon words of length 3)
Every tensor operation is a batched einsum over [batch, windows]; only the
loop over a window's pieces is a Python loop, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["logsignature_channels", "logsig_windows", "lyndon_words"]


def lyndon_words(d: int, depth: int) -> List[Tuple[int, ...]]:
    """All Lyndon words over alphabet {0..d-1} of length <= depth (Duval),
    by length, then lexicographically."""
    words = []
    w = [-1]
    while w:
        w[-1] += 1
        m = len(w)
        if m <= depth:
            words.append(tuple(w))
        while len(w) < depth:
            w.append(w[len(w) - m])
        while w and w[-1] == d - 1:
            w.pop()
    return sorted(words, key=lambda x: (len(x), x))


def logsignature_channels(d: int, depth: int) -> int:
    if depth == 1:
        return d
    if depth == 2:
        return d + d * (d - 1) // 2
    if depth == 3:
        return d + d * (d - 1) // 2 + (d**3 - d) // 3
    raise ValueError("depth must be 1, 2 or 3")


def _chen_product(a, b, depth):
    """Truncated tensor-algebra product of signatures a, b, each a tuple
    (s1 [.., d], s2 [.., d, d], s3 [.., d, d, d]) up to depth."""
    a1, a2, a3 = a
    b1, b2, b3 = b
    c2 = c3 = None
    if depth >= 2:
        c2 = a2 + b2 + torch.einsum("...i,...j->...ij", a1, b1)
    if depth >= 3:
        c3 = (a3 + b3 + torch.einsum("...ij,...k->...ijk", a2, b1)
              + torch.einsum("...i,...jk->...ijk", a1, b2))
    return (a1 + b1, c2, c3)


def _exp_increment(v, depth):
    """Signature of a linear piece: exp(v) truncated."""
    s2 = s3 = None
    if depth >= 2:
        s2 = 0.5 * torch.einsum("...i,...j->...ij", v, v)
    if depth >= 3:
        s3 = torch.einsum("...i,...j,...k->...ijk", v, v, v) / 6.0
    return (v, s2, s3)


def _log_signature(s, depth):
    """Truncated log of a signature (1, s1, s2, s3):
    log(1+x) = x - x^2/2 + x^3/3 with x = (s1, s2, s3)."""
    s1, s2, s3 = s
    l2 = l3 = None
    if depth >= 2:
        l2 = s2 - 0.5 * torch.einsum("...i,...j->...ij", s1, s1)
    if depth >= 3:
        # (x^2)_3 = s1⊗s2 + s2⊗s1 ; (x^3)_3 = s1⊗s1⊗s1
        x2_3 = (torch.einsum("...i,...jk->...ijk", s1, s2)
                + torch.einsum("...ij,...k->...ijk", s2, s1))
        x3_3 = torch.einsum("...i,...j,...k->...ijk", s1, s1, s1)
        l3 = s3 - 0.5 * x2_3 + x3_3 / 3.0
    return (s1, l2, l3)


def _window_signature(path, depth):
    """path [..., W, d] -> the truncated signature over the window, Chen
    products across its W-1 linear pieces."""
    incs = path[..., 1:, :] - path[..., :-1, :]       # [..., W-1, d]
    d = path.shape[-1]
    batch_shape = path.shape[:-2]
    zeros = lambda *s: path.new_zeros(batch_shape + s)
    sig = (zeros(d), zeros(d, d) if depth >= 2 else None,
           zeros(d, d, d) if depth >= 3 else None)
    for k in range(incs.shape[-2]):
        sig = _chen_product(sig, _exp_increment(incs[..., k, :], depth),
                            depth)
    return sig


def logsig_windows(path, depth: int, window_length: int = 4, times=None):
    """Split the time axis into windows of `window_length` pieces with
    shared boundary points, and compute each window's log-signature.

    path: [B, L, d] -> (new_times [n_windows+1] host numpy float32,
    features [B, n_windows+1, channels]). The first row carries the initial
    point in its depth-1 block and the depth-1 block is cumulative, so the
    stream is itself a path (torchcde.logsig_windows' convention); only the
    first n_windows * window_length + 1 points are used."""
    path = torch.as_tensor(path)
    B, L, d = path.shape
    n_w = max((L - 1) // window_length, 1)
    usable = n_w * window_length + 1
    path = path[:, :usable]
    idx = (np.arange(n_w)[:, None] * window_length
           + np.arange(window_length + 1)[None, :])
    windows = path[:, torch.as_tensor(idx, device=path.device)]
    logs = _log_signature(_window_signature(windows, depth), depth)

    feats = [logs[0]]                                  # [B, n_w, d]
    if depth >= 2:
        iu = np.triu_indices(d, k=1)
        feats.append(logs[1][..., iu[0], iu[1]])
    if depth >= 3:
        words3 = np.array([w for w in lyndon_words(d, 3) if len(w) == 3],
                          np.int64).reshape(-1, 3)
        feats.append(logs[2][..., words3[:, 0], words3[:, 1], words3[:, 2]])
    feat = torch.cat(feats, dim=-1)                    # [B, n_w, C]
    C = feat.shape[-1]
    # the initial position in the first row's depth-1 block, and a
    # cumulative depth-1 block after it (cumsum of increments = position)
    first = torch.cat([path[:, :1, :], path.new_zeros((B, 1, C - d))],
                      dim=-1)
    rest = torch.cat([path[:, :1, :] + torch.cumsum(feat[..., :d], dim=1),
                      feat[..., d:]], dim=-1)
    out = torch.cat([first, rest], dim=1)              # [B, n_w+1, C]
    # the solver grid stays on the host
    if times is not None:
        if isinstance(times, torch.Tensor):
            times = times.detach().cpu().numpy()
        new_times = np.asarray(times)[:usable][::window_length].astype(
            np.float32)
    else:
        new_times = np.arange(n_w + 1, dtype=np.float32)
    return new_times, out
