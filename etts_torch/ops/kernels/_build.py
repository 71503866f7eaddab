"""Build the CUDA sources under ``etts_torch/csrc`` with ``nvcc`` into shared
libraries with a plain C interface, and load them with ``ctypes``.

A library is built at its first use into ``build/kernels/`` at the root of
the checkout, named by a hash of its sources and of its ``-D`` defines, so
an edited source rebuilds and an unchanged one loads at once. A source can
be built in several variants side by side, each with its own defines (a
timer build, another compile-time size). Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _tag(defines) -> str:
    return "".join("-" + re.sub(r"\W", "_", d) for d in defines)


def _target(name: str, defines=()) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(repr(tuple(defines)).encode())
    return BUILD_DIR / f"{name}{_tag(defines)}-{h.hexdigest()[:12]}.so"


def _start(name: str, defines):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, process or None)."""
    target = _target(name, defines)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", *[f"-D{d}" for d in defines], "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, defines, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}{_tag(defines)}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu {list(defines)}:\n"
                           f"{log}")
    os.replace(tmp, target)


def build(*specs) -> None:
    """Compile the named sources, all nvcc processes at once. A spec is a
    source's name, or (name, defines) for a variant."""
    specs = [(s, ()) if isinstance(s, str) else (s[0], tuple(s[1]))
             for s in specs]
    jobs = [(n, d, *_start(n, d)) for n, d in specs]
    for n, d, target, job in jobs:
        _finish(n, d, target, job)


def build_log(name: str, defines=()) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of ``name`` (with ``defines``) in this checkout, or '' if it was
    not built here."""
    p = BUILD_DIR / f"{name}{_tag(defines)}.log"
    return p.read_text() if p.exists() else ""


@functools.cache
def load(name: str, defines=()) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu`` built with ``defines`` (a tuple
    of ``NAME`` or ``NAME=value``), built first if needed."""
    build((name, defines))
    return ctypes.CDLL(str(_target(name, defines)))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def ptr_array(tensors):
    """(c_void_p * n) of data pointers; None becomes a null pointer."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])


def int_array(values):
    return (ctypes.c_int * len(values))(*[int(v) for v in values])
