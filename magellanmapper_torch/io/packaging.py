"""Package introspection for bundling.

Copy of ``magellanmapper_tpu/io/packaging.py`` (``get_pkg_egg``,
``get_pkg_path``): locate an installed package's metadata directory and
source directory, with output paths for copying into a frozen bundle.
"""

from __future__ import annotations

import importlib
import importlib.metadata
import os
from typing import Optional, Tuple


def get_pkg_egg(name: str, prefix: Optional[str] = None
                ) -> Tuple[Optional[str], Optional[str]]:
    """Path to a package's dist-info/egg-info directory and the
    matching output path (reference ``packaging.get_pkg_egg :9``)."""
    try:
        dist = importlib.metadata.distribution(name)
    except importlib.metadata.PackageNotFoundError:
        return None, None
    info_path = getattr(dist, "_path", None)
    if info_path is None:
        return None, None
    info_path = str(info_path)
    base = os.path.basename(info_path)
    out = os.path.join(prefix, base) if prefix else base
    return info_path, out


def get_pkg_path(name: str, prefix: Optional[str] = None
                 ) -> Tuple[Optional[str], Optional[str]]:
    """Path to an installed package's directory and output path
    (reference ``packaging.get_pkg_path :29``)."""
    try:
        mod = importlib.import_module(name)
    except ImportError:
        return None, None
    pkg_dir = os.path.dirname(mod.__file__)
    out = os.path.join(prefix, name) if prefix else name
    return pkg_dir, out
