"""Dynamic time warping (port of ``etts/evalsuite/dtw.py``): the exact
O(nm) dynamic program, with fastdtw's (distance, path) output.

The accumulation and the backtrack run in ``csrc/dtw.cpp``, built with the
host C++ compiler into ``build/native/`` at the root of the checkout at
first use (plain C ABI, loaded through ctypes), with and without a band.
Where no library can be built this raises: etts falls back to numpy
quietly. The numpy version stays for the tests, behind
``backend="numpy"``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["dtw_path", "dtw_distance", "native_library"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dtw.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def native_library() -> ctypes.CDLL:
    """The DTW core, built from ``csrc/dtw.cpp`` on its first use (a
    library named by the source's hash, written under a temporary name and
    renamed into place, so that parallel processes share one build)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    target = BUILD_DIR / f"libdtw-{digest}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        errors = []
        for cxx in ("g++", "c++", "clang++"):
            if shutil.which(cxx) is None:
                continue
            proc = subprocess.run([cxx, "-O3", "-shared", "-fPIC", str(SOURCE),
                                   "-o", str(tmp)], capture_output=True,
                                  text=True)
            if proc.returncode == 0:
                os.replace(tmp, target)
                break
            errors.append(f"{cxx}: {proc.stderr.strip()}")
        else:
            raise RuntimeError("could not build the DTW library from "
                               f"{SOURCE}: " + ("; ".join(errors)
                                                or "no C++ compiler found"))
    lib = ctypes.CDLL(str(target))
    lib.dtw_accumulate.argtypes = [_DP, ctypes.c_int64, ctypes.c_int64, _DP]
    lib.dtw_accumulate.restype = None
    lib.dtw_backtrack.argtypes = [_DP, ctypes.c_int64, ctypes.c_int64, _IP,
                                  _IP]
    lib.dtw_backtrack.restype = ctypes.c_int64
    return lib


def _cost_matrix(x, y):
    """Pairwise euclidean distances (n, m)."""
    x2 = np.sum(x ** 2, axis=1)[:, None]
    y2 = np.sum(y ** 2, axis=1)[None, :]
    return np.sqrt(np.maximum(x2 + y2 - 2.0 * (x @ y.T), 0.0))


def _native(cost):
    n, m = cost.shape
    lib = native_library()
    cost = np.ascontiguousarray(cost, np.float64)
    acc = np.empty((n + 1, m + 1), np.float64)
    lib.dtw_accumulate(cost.ctypes.data_as(_DP), n, m, acc.ctypes.data_as(_DP))
    pi = np.empty(n + m, np.int64)
    pj = np.empty(n + m, np.int64)
    length = lib.dtw_backtrack(acc.ctypes.data_as(_DP), n, m,
                               pi.ctypes.data_as(_IP), pj.ctypes.data_as(_IP))
    path = list(zip(pi[:length][::-1].tolist(), pj[:length][::-1].tolist()))
    return float(acc[n, m]), path


def _numpy(cost):
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        prev, cur, c = acc[i - 1], acc[i], cost[i - 1]
        for j in range(1, m + 1):
            cur[j] = c[j - 1] + min(prev[j], prev[j - 1], cur[j - 1])
    path = []
    i, j = n, m
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        _, i, j = min((acc[i - 1, j - 1], i - 1, j - 1),
                      (acc[i - 1, j], i - 1, j), (acc[i, j - 1], i, j - 1))
    path.reverse()
    return float(acc[n, m]), path


def dtw_path(x, y, band: int | None = None, backend: str = "native"):
    """Align sequences x (n, d) and y (m, d) (1-D: d = 1); returns
    (distance, path), the path a list of (i, j) index pairs from (0, 0)
    to (n - 1, m - 1). ``band``: cells farther than ``band`` from the
    scaled diagonal cost +inf. ``backend``: "native" (the C++ core) or
    "numpy" (the same program in Python, for tests)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x = x[:, None] if x.ndim == 1 else x
    y = y[:, None] if y.ndim == 1 else y
    n, m = x.shape[0], y.shape[0]
    cost = _cost_matrix(x, y)
    if band is not None:
        mask = np.abs(np.arange(n)[:, None]
                      - np.arange(m)[None, :] * (n / m)) > band
        cost = np.where(mask, np.inf, cost)
    if backend == "native":
        return _native(cost)
    if backend == "numpy":
        return _numpy(cost)
    raise ValueError(f"backend must be native|numpy, got {backend!r}")


def dtw_distance(x, y, band: int | None = None,
                 backend: str = "native") -> float:
    return dtw_path(x, y, band, backend)[0]
