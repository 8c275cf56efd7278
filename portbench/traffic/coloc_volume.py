"""Traffic generator ``coloc_volume``: two uint16 channels of nuclei, a
reporter over a nuclear stain, made on the device and handed over in host
memory as one interleaved ``(z, y, x, 2)`` array, as the memmapped image
of a two-channel specimen is.

Channel 0 is :func:`nuclei.nuclei_volume` of the seed, the volume a
``nuclei_volume`` traffic of the same parameters makes. Channel 1, from a
second generator derived from the seed: a half of channel 0's nuclei
(``N // 2`` of them, dealt by a permutation) co-express at the same
centres, and half of the lattice shifted by half a step on every axis
(between channel 0's nuclei) holds nuclei of channel 1 alone, jittered as
channel 0's; amplitudes and noise as channel 0's, over noise of its own.
So every seed makes the same numbers of nuclei of each kind, as
``nuclei.draw`` makes the same jitters and amplitudes (the design of the
port's ``testing.make_coloc_channel``, drawn on the device).

Parameters (the traffic file's ``params``): ``shape`` (z, y, x),
``spacing``, ``jitter``, ``sigma``, ``amp`` [low, high], ``noise`` [mean,
std].
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import nuclei

#: mixes the run's seed into channel 1's generator's (any whole number
#: up to 2^64 stays a valid seed)
_MIX = 0x9E3779B97F4A7C15


def _half(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """A mask of ``n // 2`` of ``n`` items, dealt by a permutation."""
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=gen, device=device)[:n // 2]] = True
    return mask


def second_channel(shape, centres: torch.Tensor, dims, seed: int,
                   spacing: int, jitter: int, sigma: float, amp, noise,
                   device) -> dict:
    """Channel 1 as int16 bits of uint16 on ``device``, with the mask of
    the co-expressing centres and the centres of channel 1's own nuclei.
    Each part is rendered over its whole lattice, the nuclei left out at
    amplitude 0, so that ``nuclei.render_nuclei``'s classes hold."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _MIX + 1) % 2 ** 63)
    co = _half(len(centres), gen, device)
    # amplitudes of channel 0's lattice drawn anew (its jitters unused)
    amps = nuclei.draw(shape, spacing, jitter, amp, gen, device)[1]
    vol = nuclei.render_nuclei(shape, centres, amps * co, dims, spacing,
                               jitter, sigma)
    # the shifted lattice: channel 0's grid of a volume one step smaller,
    # moved by half a step on every axis
    half = spacing // 2
    inner = [int(s) - spacing for s in shape]
    own, own_amps, own_dims = nuclei.draw(inner, spacing, jitter, amp, gen,
                                          device)
    own = own + half
    mine = _half(len(own), gen, device)
    vol += nuclei.render_nuclei(shape, own, own_amps * mine, own_dims,
                                spacing, jitter, sigma)
    out = torch.empty(tuple(shape), dtype=torch.int16, device=device)
    mean, std = float(noise[0]), float(noise[1])
    for z0 in range(0, shape[0], nuclei._Z_BLOCK):
        z1 = min(shape[0], z0 + nuclei._Z_BLOCK)
        plane = torch.randn((z1 - z0,) + tuple(shape[1:]), generator=gen,
                            device=device, dtype=torch.float32)
        plane = vol[z0:z1] + (plane * std + mean)
        # truncation toward zero, as nuclei_volume casts
        out[z0:z1] = torch.clamp(plane, 0, 65535).to(torch.int32).to(
            torch.int16)
        del plane
    return {"channel": out, "coexpressed": co, "own": own[mine]}


def make(params, seed: int, device) -> dict:
    """``{"volume": (Z, Y, X, 2) uint16 host array, "centres": (N, 3)
    channel 0's centres, "coexpressed": (N,) bool, "own": (M, 3) centres
    of channel 1 alone}``."""
    shape = tuple(int(s) for s in params["shape"])
    spacing, jitter = int(params["spacing"]), int(params["jitter"])
    sigma = float(params["sigma"])
    first = nuclei.nuclei_volume(
        shape, seed, spacing=spacing, sigma=sigma, jitter=jitter,
        amp=params["amp"], noise=params["noise"], device=device,
        as_float=True)
    ch0 = first["volume"].to(torch.int32).to(torch.int16)
    del first["volume"]
    centres = torch.from_numpy(first["centres"]).to(device)
    dims = tuple(len(a) for a in nuclei.grid(shape, spacing))
    second = second_channel(shape, centres, dims, seed, spacing, jitter,
                            sigma, params["amp"], params["noise"], device)
    both = torch.stack([ch0, second["channel"]], dim=-1)
    del ch0, second["channel"]
    return {"volume": both.cpu().numpy().view(np.uint16),
            "centres": first["centres"],
            "coexpressed": second["coexpressed"].cpu().numpy(),
            "own": second["own"].cpu().numpy()}
