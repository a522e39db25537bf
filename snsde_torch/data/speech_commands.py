"""Speech Commands v0.02: 10 keywords, 16 kHz clips -> MFCC(20)
(counterpart of snsde/data/speech_commands.py:13-141, the port's own copy).

The ten target words, 1-second clips at 16 kHz, log-mel MFCC with 20
coefficients, n_fft=200, hop=100 -> [N, 161, 20], as the reference's
datasets/speech_commands.py:13-104 makes them with torchaudio. The MFCC is
numpy, as in the JAX package: frames with torchaudio's center/reflect
padding, a periodic Hann window, the FFT power, an htk mel filterbank
(128 triangles, no norm), the natural log with a 1e-6 floor and an
orthonormal DCT-II (held to tests/goldens/mfcc.npz, which froze torch.stft
in float64).

The archive is not part of this repository and nothing downloads it:
`get_data` reads `speech_commands_v0.02.tar.gz` only from an explicit
`data_dir`, caches the MFCC arrays there as `.npz` (no pickles), and,
when the archive is missing, returns `synthetic_speech` data of the same
shape unless told not to. That fallback is the JAX package's data
semantics (a dataset stand-in), not a device fallback.
"""

from __future__ import annotations

import io
import os
import tarfile
import wave
from typing import Optional

import numpy as np

from .synthetic import synthetic_speech

__all__ = ["WORDS", "mel_filterbank", "mfcc", "load_from_archive",
           "get_data"]

ARCHIVE = "speech_commands_v0.02.tar.gz"
CACHE = "speech_mfcc.npz"
WORDS = ["yes", "no", "up", "down", "left", "right", "on", "off", "stop",
         "go"]
SAMPLE_RATE = 16000
N_MFCC = 20
N_FFT = 200
HOP = 100
N_MELS = 128


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_mels=N_MELS, n_fft=N_FFT, sr=SAMPLE_RATE):
    """[n_fft // 2 + 1, n_mels] htk-scale triangles, no norm."""
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _dct_matrix(n_out, n_in):
    """Orthonormal DCT-II [n_out, n_in]."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi / n_in * (n + 0.5) * k)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return (mat * np.sqrt(2.0 / n_in)).astype(np.float32)


def mfcc(audio: np.ndarray, n_mfcc=N_MFCC, n_fft=N_FFT, hop=HOP):
    """audio [T] float32 -> [frames, n_mfcc]."""
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    # the periodic Hann window (torch.hann_window's default)
    window = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft)
                                  / n_fft))).astype(np.float32)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * window
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)) ** 2
    fb = mel_filterbank(n_fft=n_fft)
    logmel = np.log(spec @ fb + 1e-6)
    dct = _dct_matrix(n_mfcc, fb.shape[1])
    return (logmel @ dct.T).astype(np.float32)


def _read_wav(data: bytes) -> np.ndarray:
    """16-bit PCM WAV bytes -> float32 in [-1, 1), zero-padded or cut to
    one second."""
    with wave.open(io.BytesIO(data)) as w:
        raw = w.readframes(w.getnframes())
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if len(x) < SAMPLE_RATE:
        x = np.pad(x, (0, SAMPLE_RATE - len(x)))
    return x[:SAMPLE_RATE]


def load_from_archive(data_dir: str):
    """(X [N, 161, 20], y [N], lengths [N], times [161]) from the WAVs of
    the ten keywords' folders in data_dir/speech_commands_v0.02.tar.gz, in
    the archive's order; FileNotFoundError when it is missing."""
    tpath = os.path.join(data_dir, ARCHIVE)
    if not os.path.exists(tpath):
        raise FileNotFoundError(
            f"{tpath} missing: put {ARCHIVE} into {data_dir} (nothing "
            f"here downloads it)")
    Xs, ys = [], []
    with tarfile.open(tpath, "r:gz") as tf:
        for member in tf.getmembers():
            parts = member.name.split("/")
            if len(parts) < 2 or parts[-2] not in WORDS:
                continue
            if not member.name.endswith(".wav"):
                continue
            Xs.append(mfcc(_read_wav(tf.extractfile(member).read())))
            ys.append(WORDS.index(parts[-2]))
    X = np.stack(Xs)
    y = np.asarray(ys, np.int64)
    lengths = np.full((X.shape[0],), X.shape[1], np.int64)
    times = np.arange(X.shape[1], dtype=np.float32)
    return X, y, lengths, times


def get_data(data_dir: Optional[str] = None, n_synthetic: int = 2048,
             synthetic_fallback: bool = True, seed: int = 0):
    """(X, y, lengths, times): the MFCC arrays cached in
    data_dir/speech_mfcc.npz, else those of the archive in data_dir
    (then cached there), else, when there is no archive (or no data_dir),
    `synthetic_speech(n_synthetic, seed)`, or FileNotFoundError with
    synthetic_fallback=False."""
    if data_dir is not None:
        cpath = os.path.join(data_dir, CACHE)
        if os.path.exists(cpath):
            with np.load(cpath) as z:
                return z["X"], z["y"], z["lengths"], z["times"]
    try:
        if data_dir is None:
            raise FileNotFoundError(f"no data_dir holding {ARCHIVE} given")
        out = load_from_archive(data_dir)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        return synthetic_speech(n=n_synthetic, seed=seed)
    np.savez(cpath, **dict(zip(("X", "y", "lengths", "times"), out)))
    return out
