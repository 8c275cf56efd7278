"""Seeded volumes of planted nuclei, drawn and rendered on the device.

A PyTorch form of the nuclei fixtures of the port's tests
(``frozen_numpy.py`` holds their NumPy form, whose loop renders the same
draws): Gaussian nuclei on a jittered grid over Gaussian noise, cast to
uint16. Unlike the fixture, every seed draws the same jitters and
amplitudes, in another order. Every random number comes from one ``torch.Generator`` seeded with the run's seed, on the
device the volume is made on, in a fixed order (the jitters' and the
amplitudes' permutations, then the noise block of planes by block), so
one seed gives one volume, and every seed the same sizes (:func:`draw`).

Nuclei are stamped in classes of grid indices equal modulo ``m`` on each
axis, with ``m`` large enough that two stamps of one class never overlap:
each class is one gather-add-scatter over distinct voxels, with no atomic
adds, so the sums, and the volume, do not change from run to run.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

#: nuclei stamped in one gather-add-scatter at most
_CHUNK = 4096
#: z planes of noise drawn and finished at a time
_Z_BLOCK = 64


def stamp(sigma: float) -> np.ndarray:
    """The float32 Gaussian stamp of one nucleus, ``(w, w, w)`` with
    ``w = 2 * (int(3 * sigma) + 1) + 1``, as the NumPy fixture makes it."""
    r = int(3 * sigma) + 1
    g = np.arange(-r, r + 1, dtype=np.float32)
    return np.exp(-(g[:, None, None] ** 2 + g[None, :, None] ** 2
                    + g[None, None, :] ** 2) / np.float32(2 * sigma ** 2))


def grid(shape: Sequence[int], spacing: int) -> Tuple[np.ndarray, ...]:
    """Per axis, the grid positions ``spacing // 2 + k * spacing``."""
    return tuple(np.arange(spacing // 2, s - spacing // 2 + 1, spacing)
                 for s in shape)


def num_nuclei(shape: Sequence[int], spacing: int) -> int:
    """Nuclei a volume of ``shape`` holds at ``spacing``."""
    return int(np.prod([len(g) for g in grid(shape, spacing)]))


def draw(shape: Sequence[int], spacing: int, jitter: int,
         amp: Sequence[float], gen: torch.Generator, device
         ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int, int]]:
    """Jittered centres ``(N, 3)`` int64 and float32 amplitudes ``(N,)``,
    and the grid's ``(nz, ny, nx)``; centres in grid order (z slowest).

    Every seed draws the same sizes in another order: the amplitudes are
    the ``N`` midpoints of equal steps over ``amp``, and each axis's
    jitters take every value in ``[-jitter, jitter]`` equally often (as
    near as ``N`` allows), each list dealt over the nuclei by a
    permutation drawn from ``gen``. So the work a volume makes (nuclei at
    each brightness, their spacings) does not change with the seed, only
    where each nucleus lies."""
    axes = grid(shape, spacing)
    mesh = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    n = len(mesh)
    steps = torch.arange(n, device=device)
    jit = []
    for _ in range(3):
        vals = steps % (2 * jitter + 1) - jitter
        jit.append(vals[torch.randperm(n, generator=gen, device=device)])
    centres = torch.from_numpy(mesh).to(device) + torch.stack(jit, dim=1)
    lo, hi = float(amp[0]), float(amp[1])
    mids = lo + (hi - lo) * (steps.to(torch.float64) + 0.5) / n
    amps = mids.to(torch.float32)[
        torch.randperm(n, generator=gen, device=device)]
    return centres, amps, tuple(len(a) for a in axes)


def render_nuclei(shape: Sequence[int], centres: torch.Tensor,
                  amps: torch.Tensor, dims: Tuple[int, int, int],
                  spacing: int, jitter: int, sigma: float) -> torch.Tensor:
    """Float32 sum of every nucleus's ``amp * stamp``, cropped to
    ``shape``."""
    device = centres.device
    st = torch.from_numpy(stamp(sigma)).to(device)
    w = st.shape[0]
    r = w // 2
    padded = [int(s) + 2 * r for s in shape]
    vol = torch.zeros(padded, dtype=torch.float32, device=device)
    flat = vol.view(-1)
    sy, sx = padded[1] * padded[2], padded[2]
    g = torch.arange(w, device=device)
    offsets = (g[:, None, None] * sy + g[None, :, None] * sx
               + g[None, None, :]).reshape(-1)
    # classes of grid indices equal modulo m: stamps of one class are at
    # least m * spacing - 2 * jitter >= w apart on some axis
    m = max(1, math.ceil((w + 2 * jitter) / spacing))
    nz, ny, nx = dims
    kz, ky, kx = torch.meshgrid(
        torch.arange(nz, device=device), torch.arange(ny, device=device),
        torch.arange(nx, device=device), indexing="ij")
    cls = ((kz % m) * m + (ky % m)) * m + (kx % m)
    cls = cls.reshape(-1)
    # a centre c lies at c + r in the padded volume; its stamp starts at c
    base = centres[:, 0] * sy + centres[:, 1] * sx + centres[:, 2]
    for c in range(m ** 3):
        members = torch.nonzero(cls == c).squeeze(1)
        for lo in range(0, len(members), _CHUNK):
            sel = members[lo:lo + _CHUNK]
            idx = (base[sel, None] + offsets[None, :]).reshape(-1)
            vals = (amps[sel, None] * st.reshape(1, -1)).reshape(-1)
            flat.index_put_((idx,), flat[idx] + vals)
    return vol[r:r + shape[0], r:r + shape[1], r:r + shape[2]]


def nuclei_volume(shape: Sequence[int], seed: int, spacing: int = 20,
                  sigma: float = 2.7, jitter: int = 4,
                  amp: Sequence[float] = (1500.0, 3000.0),
                  noise: Sequence[float] = (200.0, 30.0),
                  device="cuda", as_float: bool = False) -> Dict:
    """A uint16 volume of nuclei over noise, made on ``device`` from
    ``seed``: ``{"volume": host (Z, Y, X) uint16 array, "centres": host
    (N, 3) int64}``. With ``as_float``, ``"volume"`` is the clipped and
    truncated float32 tensor on ``device`` instead (the uint16 values,
    exactly)."""
    shape = tuple(int(s) for s in shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    centres, amps, dims = draw(shape, spacing, jitter, amp, gen, device)
    vol = render_nuclei(shape, centres, amps, dims, spacing, jitter, sigma)
    out = torch.empty(shape, dtype=torch.float32 if as_float
                      else torch.int16, device=device)
    mean, std = float(noise[0]), float(noise[1])
    for z0 in range(0, shape[0], _Z_BLOCK):
        z1 = min(shape[0], z0 + _Z_BLOCK)
        plane = torch.randn((z1 - z0,) + shape[1:], generator=gen,
                            device=device, dtype=torch.float32)
        plane = vol[z0:z1] + (plane * std + mean)
        # truncation toward zero, as NumPy's astype(uint16) of a clipped
        # float; the int16 cast keeps the low 16 bits, the uint16 bits
        val = torch.clamp(plane, 0, 65535).to(torch.int32)
        out[z0:z1] = val.to(torch.float32) if as_float else val.to(
            torch.int16)
        del plane, val
    del vol
    host_centres = centres.cpu().numpy()
    if as_float:
        return {"volume": out, "centres": host_centres}
    return {"volume": out.cpu().numpy().view(np.uint16),
            "centres": host_centres}
