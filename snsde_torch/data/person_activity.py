"""PersonActivity (UCI localization data) for the activity harness
(counterpart of snsde/data/person_activity.py).

Four sensor tags x three coordinates on an irregular union grid, seven
activity labels a time point, in numpy. `parse_raw` reads the raw UCI
file from a directory that holds it; nothing downloads it (`URL` names
the source). Without it `get_data` returns `synthetic_person_activity`,
shaped the same way ([N, L, 12] values and mask, [N, L] times and
labels).

`parse_raw` keeps a known fault of the reference: it numbers the labels
in the order they first appear in the file, not by the reference's
merged seven-class label dictionary.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["URL", "NUM_TAGS", "COORDS", "NUM_CLASSES",
           "synthetic_person_activity", "parse_raw", "get_data"]

URL = (
    "https://archive.ics.uci.edu/ml/machine-learning-databases/00196/"
    "ConfLongDemo_JSI.txt"
)
NUM_TAGS = 4
COORDS = 3
NUM_CLASSES = 7


def synthetic_person_activity(n: int = 512, length: int = 50,
                              observe_rate: float = 0.4, seed: int = 0):
    """(values [n, L, 12], mask [n, L, 12], tp [n, L], labels [n, L]):
    piecewise-constant label segments of 5-15 time points, each class a
    sinusoid signature over the twelve channels with per-(class, channel)
    phases, observed at `observe_rate` (the first time point always)."""
    rng = np.random.default_rng(seed)
    D = NUM_TAGS * COORDS
    t = np.linspace(0, 1, length, dtype=np.float32)
    labels = np.zeros((n, length), np.int64)
    for i in range(n):
        pos = 0
        while pos < length:
            seg = int(rng.integers(5, 16))
            labels[i, pos:pos + seg] = rng.integers(0, NUM_CLASSES)
            pos += seg
    vals = np.zeros((n, length, D), np.float32)
    phases = (2 * np.pi * np.arange(D) / D)[None, :] \
        + (2 * np.pi * np.arange(NUM_CLASSES) / NUM_CLASSES)[:, None]
    for c in range(NUM_CLASSES):
        pattern = np.sin(
            2 * np.pi * (c + 1) * t[:, None] + phases[c][None, :])[None]
        sel = labels == c
        vals += sel[..., None] * (
            pattern + 0.1 * rng.normal(size=(n, length, D)))
    mask = (rng.random((n, length, D)) < observe_rate).astype(np.float32)
    mask[:, 0] = 1.0
    tp = np.broadcast_to(t, (n, length)).copy()
    return (vals * mask).astype(np.float32), mask, tp, labels.astype(
        np.int64)


def parse_raw(path: str, length: int = 50):
    """The raw UCI file -> per-sequence union-grid arrays (values, mask,
    tp, labels), each sequence's span mapped onto `length` points."""
    tag_ids = [
        "010-000-024-033", "010-000-030-096", "020-000-033-111",
        "020-000-032-221",
    ]
    activities = {}
    seqs = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 8:
                continue
            seq_id, tag, ts = parts[0], parts[1], float(parts[2])
            xyz = [float(parts[4]), float(parts[5]), float(parts[6])]
            act = parts[7]
            if tag not in tag_ids:
                continue
            activities.setdefault(act, len(activities))
            rec = seqs.setdefault(seq_id, [])
            rec.append((ts, tag_ids.index(tag), xyz, activities[act]))
    out_x, out_m, out_tp, out_y = [], [], [], []
    D = NUM_TAGS * COORDS
    for events in seqs.values():
        events.sort()
        t0, t1 = events[0][0], events[-1][0]
        span = max(t1 - t0, 1e-9)
        x = np.zeros((length, D), np.float32)
        m = np.zeros((length, D), np.float32)
        y = np.zeros((length,), np.int64)
        for ts, tag_i, xyz, act in events:
            li = min(int((ts - t0) / span * (length - 1)), length - 1)
            x[li, tag_i * COORDS:(tag_i + 1) * COORDS] = xyz
            m[li, tag_i * COORDS:(tag_i + 1) * COORDS] = 1.0
            y[li] = act
        out_x.append(x)
        out_m.append(m)
        out_tp.append(np.linspace(0, 1, length, dtype=np.float32))
        out_y.append(y)
    return (np.stack(out_x), np.stack(out_m), np.stack(out_tp),
            np.stack(out_y))


def get_data(data_dir: Optional[str] = None, n_synthetic: int = 512,
             synthetic_fallback: bool = True, seed: int = 0):
    """parse_raw of the UCI file in data_dir (by default
    ~/.cache/snsde/person_activity), else
    synthetic_person_activity(n=n_synthetic, seed=seed) unless
    synthetic_fallback is False."""
    data_dir = data_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "snsde", "person_activity")
    raw = os.path.join(data_dir, os.path.basename(URL))
    if os.path.exists(raw):
        return parse_raw(raw)
    if synthetic_fallback:
        return synthetic_person_activity(n=n_synthetic, seed=seed)
    raise FileNotFoundError(raw)
