"""Compression helpers: zstd through its command where it is installed,
zip and gzip through Python's modules.

Copy of ``magellanmapper_tpu/io/subproc_io.py``: the same formats, file
names and fallbacks (``fmt="zstd"`` writes a zip when the ``zstd``
command is absent or the path is a directory).
"""

from __future__ import annotations

import gzip
import os
import shutil
import subprocess
import tarfile
import zipfile
from typing import Optional


def _has_cmd(name: str) -> bool:
    return shutil.which(name) is not None


def compress_file(
        path: str, out_path: Optional[str] = None,
        fmt: str = "zstd") -> str:
    """Compress a file or directory; returns the archive's path."""
    if fmt == "zstd" and _has_cmd("zstd") and os.path.isfile(path):
        out_path = out_path or path + ".zst"
        subprocess.run(["zstd", "-f", path, "-o", out_path], check=True)
        return out_path
    if fmt in ("zip", "zstd"):
        out_path = out_path or path + ".zip"
        with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
            if os.path.isdir(path):
                for root, _, files in os.walk(path):
                    for f in files:
                        full = os.path.join(root, f)
                        zf.write(full, os.path.relpath(full, path))
            else:
                zf.write(path, os.path.basename(path))
        return out_path
    if fmt == "gz":
        out_path = out_path or path + ".gz"
        with open(path, "rb") as fin, gzip.open(out_path, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        return out_path
    raise ValueError(f"unknown compression format: {fmt}")


def decompress_file(path: str, out_dir: Optional[str] = None) -> str:
    """Decompress an archive into ``out_dir`` (default: its directory);
    returns the output file, or the directory for a zip."""
    out_dir = out_dir or os.path.dirname(path) or "."
    os.makedirs(out_dir, exist_ok=True)
    if path.endswith(".zst") and _has_cmd("zstd"):
        out = os.path.join(out_dir, os.path.basename(path)[:-4])
        subprocess.run(["zstd", "-d", "-f", path, "-o", out], check=True)
        return out
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            zf.extractall(out_dir)
        return out_dir
    if path.endswith(".gz"):
        out = os.path.join(out_dir, os.path.basename(path)[:-3])
        with gzip.open(path, "rb") as fin, open(out, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        return out
    raise ValueError(f"unknown archive type: {path}")


def test_compression(path: str) -> bool:
    """Integrity check of a zstd file with ``pzstd -t`` or ``zstd -t``;
    without either command, whether a tar file lists or the file reads."""
    for cmd in (["pzstd", "-t", path], ["zstd", "-t", path]):
        if _has_cmd(cmd[0]):
            try:
                subprocess.check_call(
                    cmd, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)
                return True
            except subprocess.CalledProcessError:
                return False
    try:
        if tarfile.is_tarfile(path):
            with tarfile.open(path) as tf:
                tf.getmembers()
        else:
            with open(path, "rb") as f:
                f.read(1 << 16)
        return True
    except Exception:
        return False
