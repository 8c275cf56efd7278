"""Path and sequence helpers.

Copy of the helpers of ``magellanmapper_tpu/utils/libmag.py``
(``splitext :23``, ``insert_before_ext :32``, ``combine_paths :38``,
``backup_file :60``, ``is_seq :176``, ``match_ext :249``) that the
port's blob archive, database and image naming and its region metrics
use.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np

#: multi-part extensions treated as a single suffix.
EXTS_COMPOUND = (".nii.gz", ".ome.tif", ".ome.tiff", ".tar.gz")


def splitext(path: str) -> Tuple[str, str]:
    """Split extension, keeping compound extensions intact."""
    lower = path.lower()
    for ext in EXTS_COMPOUND:
        if lower.endswith(ext):
            return path[: len(path) - len(ext)], path[len(path) - len(ext):]
    return os.path.splitext(path)


def insert_before_ext(path: str, insert: str, sep: str = "") -> str:
    """Insert ``insert`` before the file extension of ``path``."""
    base, ext = splitext(path)
    return f"{base}{sep}{insert}{ext}"


def combine_paths(
        base: Optional[str], suffix: str, sep: str = "_",
        ext: Optional[str] = None, check_dir: bool = False) -> str:
    """Combine a base path with a suffix, optionally replacing extension."""
    if not base:
        return suffix
    root, _ = splitext(base)
    if suffix.startswith("."):
        out = root + suffix
    else:
        out = f"{root}{sep}{suffix}"
    if ext:
        out = splitext(out)[0] + (ext if ext.startswith(".") else "." + ext)
    if check_dir:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    return out


def match_ext(path: str, path_to_match: str) -> str:
    """Give ``path_to_match`` the extension of ``path``."""
    ext = splitext(path)[1]
    if not ext:
        return path_to_match
    return splitext(path_to_match)[0] + ext


def backup_file(path: str, modifier: str = "") -> Optional[str]:
    """Move an existing file aside as ``path(.N)`` before overwrite.

    Returns the backup path or None if ``path`` does not exist.
    """
    if not os.path.exists(path):
        return None
    i = 1
    while True:
        backup = insert_before_ext(path, f"{modifier}({i})")
        if not os.path.exists(backup):
            shutil.move(path, backup)
            return backup
        i += 1


def is_seq(val: Any) -> bool:
    """True for list/tuple/ndarray (not strings)."""
    return isinstance(val, (list, tuple, np.ndarray))
