"""Published peaks of the cards the benchmark runs on, and roofline
shares.

A share is the least time the card could take for the counted work, the
larger of bytes over the memory bandwidth and operations over the
float32 rate outside the tensor cores (every kernel measured here works
in float32 or on integers), over the time the kernels took. The peaks
are NVIDIA's data sheet's for the full power limit; the result line
carries the card's own limit beside them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

#: card name as ``torch.cuda.get_device_name`` gives it -> peaks:
#: memory bytes/s, float32 FLOP/s (non-tensor), and the power limit (W)
#: the data sheet's rates assume
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_flop_s": 67e12,
                              "watts": 700.0},
    "NVIDIA H100 PCIe": {"bytes_s": 2.0e12, "f32_flop_s": 51e12,
                         "watts": 350.0},
}


def bound_s(counts: Iterable[Tuple[float, float]], peaks) -> Tuple[
        float, str]:
    """Least seconds for a list of ``(bytes, operations)`` counts, call by
    call, and which limit binds most of it (``bytes`` or ``operations``)."""
    total = by_bytes = by_ops = 0.0
    for nbytes, ops in counts:
        tb = nbytes / peaks["bytes_s"]
        to = ops / peaks["f32_flop_s"]
        total += max(tb, to)
        if tb >= to:
            by_bytes += tb
        else:
            by_ops += to
    return total, "bytes" if by_bytes >= by_ops else "operations"


def share(counts, device_s: float, card: str) -> Optional[float]:
    """Percent of the roofline that ``device_s`` seconds of kernel time
    reached for ``counts``; None without counts, time or known peaks."""
    peaks = PEAKS.get(card)
    counts = list(counts)
    if peaks is None or not counts or not device_s > 0:
        return None
    least, _ = bound_s(counts, peaks)
    return 100.0 * least / device_s
