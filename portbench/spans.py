"""Shared arithmetic of the readers of the program's own spans and
counters (``magellanmapper_torch.utils.profiler``). The program keeps a
span only while a profiler session records, so in a run of the
benchmark its records are those of the traced calls alone. A program
that keeps no spans gives nothing to read, and these return None.
"""

from __future__ import annotations

from typing import List, Optional


def records() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from magellanmapper_torch.utils import profiler
    except ImportError:
        return None
    get = getattr(profiler, "spans", None)
    return None if get is None else get()


def under(recs: Optional[list], root: str) -> List:
    """The closed records whose root span is named ``root``."""
    return [r for r in recs or () if r.end_ns is not None
            and recs[r.root].name == root]


def named(recs: list, name: str) -> List:
    return [r for r in recs if r.name == name]


def wall_s(recs: list, name: str) -> float:
    """Seconds inside the spans ``name``, summed."""
    return sum(r.end_ns - r.start_ns for r in named(recs, name)) / 1e9


def share(root: str, name: str) -> Optional[float]:
    """Percent of the ``root`` spans' wall spent inside the spans
    ``name`` under them."""
    recs = under(records(), root)
    base = wall_s(recs, root)
    if not base or not named(recs, name):
        return None
    return 100.0 * wall_s(recs, name) / base


def per_root(root: str, name: str, counter: str) -> Optional[float]:
    """The counter ``counter`` of the spans ``name``, summed, over the
    number of ``root`` spans."""
    recs = under(records(), root)
    roots, inner = named(recs, root), named(recs, name)
    if not roots or not inner:
        return None
    return sum(r.counts.get(counter, 0) for r in inner) / len(roots)
