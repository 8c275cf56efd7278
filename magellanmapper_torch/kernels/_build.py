"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``magellanmapper_torch/csrc/*.cu`` for ``sm_90a``
(one process per source, all started together) and links the objects into
one shared library with a plain C interface, under ``build/kernels/`` at
the repository root, at first use. The library's name carries a hash
of the sources and flags, so an edited source builds anew and an unchanged
one is loaded as it is. The library is loaded with ``ctypes``; every
entry point launches on the stream it is given and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

``-fmad=false`` keeps nvcc from contracting ``a * b + c`` into FMAs, so
the kernels round each step as their plain PyTorch versions do (the
overlap test of K3 and the interpolation of K4 compare bit for bit).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never cuts a 64-bit address to an int)
_SIGNATURES = {
    # cube, S, Z, Y, X, thresh, vals, idx (int64), count, buf_cap, stream
    "mm_peak_candidates": (_P, _I, _I, _I, _I, _F, _P, _P, _P, _I, _P),
    # coords, sigmas, valid, K, sqrt_ndim, thresh, out, scratch, stream
    "mm_prune_overlap": (_P, _P, _P, _I, _F, _F, _P, _P, _P),
    # tiles, is_u16, T, V, k_lo, k_hi, frac_lo, frac_hi, out, chunk,
    # n_chunks, scratch, stream
    "mm_tile_percentiles": (_P, _I, _I, _I, _I, _I, _F, _F, _P, _I, _I, _P,
                            _P),
    # rows, R, out_vals, out_lanes, stream
    "mm_extract_candidates": (_P, _L, _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when a built library was reused) and
#: what the compiler printed (ptxas registers, shared memory, spills)
build_seconds = 0.0
build_log = ""


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels cannot be built on this machine")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libmm_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    objs = [Path(f"{stem}.{src.stem}.o") for src in _sources()]
    tmp = Path(f"{stem}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_sources(), objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        failed = [link.returncode] if link.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {failed[0]}:\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def on_device(device):
    """A context that makes ``device`` current, or none where it already
    is (entering ``torch.cuda.device`` costs host time on every launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
