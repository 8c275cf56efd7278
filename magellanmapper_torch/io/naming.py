"""File naming: copy of ``make_subimage_name`` from
``magellanmapper_tpu/io/naming.py``."""

from __future__ import annotations

from typing import Optional, Sequence

from magellanmapper_torch.utils import libmag


def make_subimage_name(
        base: str, offset: Optional[Sequence[int]] = None,
        shape: Optional[Sequence[int]] = None,
        suffix: Optional[str] = None) -> str:
    """Name a sub-image file for a z,y,x ``offset``/``shape``; the tuples
    appear x,y,z in the name, as ``base_(x,y,z)x(x,y,z).ext``."""
    name = base
    if offset is not None and shape is not None:
        roi_site = "{}x{}".format(
            tuple(offset[::-1]), tuple(shape[::-1])).replace(" ", "")
        name = libmag.insert_before_ext(base, roi_site, "_")
    if suffix:
        name = libmag.combine_paths(name, suffix)
    return name
