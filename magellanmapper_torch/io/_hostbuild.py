"""Build the port's host C++ sources into shared libraries at first use.

``g++`` compiles a source under ``magellanmapper_torch/csrc/host/`` into
``build/host/`` at the repository root, named after the source's stem and
a hash of the source, flags and libraries, so an edited source builds
anew and an unchanged one is loaded as it is. A missing compiler or a
failed build raises with the compiler's output: no caller falls back to
another decoder. Used by :mod:`._tiffcodec` and :mod:`._jpegcodec`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")


def library_path(src: Path, build_dir: Path,
                 libs: Sequence[str] = ()) -> Path:
    """Where the library for ``src`` at the current flags lives."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(CXX_FLAGS + tuple(libs)).encode())
    return build_dir / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path, libs: Sequence[str] = (),
          needs: str = "") -> Path:
    """Compile ``src`` (linked with ``libs``) unless its library exists.

    ``needs`` names what the build needs besides a compiler (a system
    library and its header), for the error raised when it fails."""
    out = library_path(src, build_dir, libs)
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler (g++ or c++) on PATH: {src.name} cannot be "
            "built")
    build_dir.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: processes building at once each
    # write their own file and the last rename wins
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *libs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed with code {proc.returncode} building {src}"
            + (f" (it needs {needs})" if needs else "")
            + f":\n{proc.stdout}")
    os.replace(tmp, out)
    return out
