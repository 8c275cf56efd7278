"""Traffic generator ``nuclei_volume``: one uint16 channel of nuclei on a
jittered grid over noise, made on the device and handed over in host
memory, as the memmapped image of a whole-specimen run is.

Parameters (the traffic file's ``params``): ``shape`` (z, y, x),
``spacing``, ``jitter``, ``sigma``, ``amp`` [low, high], ``noise`` [mean,
std].
"""

from __future__ import annotations

from portbench.traffic import nuclei


def make(params, seed: int, device) -> dict:
    """``{"volume": (Z, Y, X) uint16 host array, "centres": (N, 3)}``."""
    return nuclei.nuclei_volume(
        params["shape"], seed, spacing=int(params["spacing"]),
        sigma=float(params["sigma"]), jitter=int(params["jitter"]),
        amp=params["amp"], noise=params["noise"], device=device)
