"""Build and load the port's CUDA kernels.

Each source in snsde_torch/csrc/ is compiled with nvcc for sm_90a into a
shared library with a plain C interface and loaded with ctypes — no
PyTorch headers, so a build takes seconds. Libraries go to
snsde_torch/_build/ (listed in .gitignore), named by a hash of the source,
the shared headers (csrc/*.cuh) and the flags, so an edited source or
header is rebuilt at first use and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

__all__ = ["build", "start", "stop", "load", "BUILD_LOG", "CSRC",
           "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -split-compile=0 for nvcc's optimizer and for ptxas: a source's functions
# compiled on every core. The SDE pairs' sources hold 48 kernel instances
# each (drift x noise mode x level x forward/backward); nvcc's flag alone
# leaves ptxas to compile them one after another (the SRK source ~270 s on
# the chip machine's 8 cores), with both the four sources build in ~214 s.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0", "-Xptxas", "-split-compile=0"]

# the niceness of every nvcc process: a caller that goes on working while
# they run keeps its core
BUILD_NICE = 10
# name -> nvcc's output (ptxas register/shared-memory report) and its own
# seconds from its start
BUILD_LOG: Dict[str, dict] = {}
# name -> a started nvcc process (proc, its log file, tmp output, library,
# start time) that build() has not waited for yet
_RUNNING: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels are "
                           "built on the machine with the card")
    return path


def _target(name: str, csrc: str = CSRC) -> str:
    """The library's path, named by a digest of csrc/<name>.cu, every
    header in csrc/ (a source may include any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(csrc, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def start(names: Iterable[str]) -> None:
    """Start nvcc, all processes together and at niceness BUILD_NICE, for
    every named source that has no up-to-date library and is not being
    built already; return at once. build() (load() for one source) waits
    for them."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        out = _target(name)
        if os.path.exists(out) or name in _RUNNING:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        log = open(f"{tmp}.log", "w+")
        proc = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(BUILD_NICE))
        _RUNNING[name] = (proc, log, tmp, out, time.perf_counter())


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no up-to-date library (start's
    processes, and any started before), each one's seconds from its start
    to its own end in BUILD_LOG. Raises with nvcc's output on a failed
    build."""
    names = list(names)
    start(names)
    failed = []
    while any(n in _RUNNING for n in names):
        for name in [n for n in names if n in _RUNNING
                     and _RUNNING[n][0].poll() is not None]:
            proc, log, tmp, out, t0 = _RUNNING.pop(name)
            with log:
                log.seek(0)
                text = log.read()
            os.remove(log.name)
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "log": text}
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{text}")
            else:
                os.replace(tmp, out)   # atomic: a reader never sees half
        if any(n in _RUNNING for n in names):
            time.sleep(0.1)
    if failed:
        raise RuntimeError("\n".join(failed))


def stop() -> None:
    """End every started nvcc process that build() has not waited for
    (a caller that fails before its build ends leaves none running)."""
    while _RUNNING:
        proc, log, tmp, _, _ = _RUNNING.popitem()[1]
        proc.kill()
        proc.wait()
        log.close()
        for path in (tmp, log.name):
            if os.path.exists(path):
                os.remove(path)


def load(name: str) -> ctypes.CDLL:
    """Load the library of csrc/<name>.cu, building it first if needed."""
    build([name])
    return ctypes.CDLL(_target(name))
