"""Plain PyTorch filters of the benchmark's reference.

Written from the definitions, not from the program: ``scipy.ndimage``'s
sampled Gaussian kernels and boundary modes, a 1D correlation as a
product with a dense band matrix, the Laplacian of Gaussian as
``scipy.ndimage.gaussian_laplace`` composes it (each axis's second
derivative with order-0 passes on the others, axes in order z, y, x, the
terms summed in that order), a 3^n maximum filter with a zero border,
numpy's linear-interpolation percentile, and sphere-overlap pruning
(a frozen copy of the port's plain version, whose tie rule decides which
of two equal blobs stays). Every product runs in full float32:
:func:`full_float32` turns TF32 off for cuBLAS and cuDNN.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch


def full_float32() -> None:
    """No TF32 in float32 products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gaussian_kernel(sigma: float, order: int, truncate: float = 4.0
                    ) -> np.ndarray:
    """scipy's ``_gaussian_kernel1d`` at radius ``int(truncate * sigma +
    0.5)``, float64."""
    radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) ** 2
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi = phi / phi.sum()
    if order == 0:
        return phi
    exps = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    deriv = np.diag(exps[1:], 1) + np.diag(np.ones(order) / -sigma2, -1)
    for _ in range(order):
        q = deriv.dot(q)
    return (x[:, None] ** exps).dot(q) * phi


def _source(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    """The input sample that position ``i`` (possibly outside ``[0, n)``)
    reads under scipy's boundary ``mode``."""
    if mode == "reflect":        # d c b a | a b c d | d c b a, repeating
        k = np.mod(i, 2 * n)
        return np.where(k < n, k, 2 * n - 1 - k)
    if mode == "nearest":
        return np.clip(i, 0, n - 1)
    raise ValueError(f"mode {mode!r}")


def band(kernel: np.ndarray, n: int, mode: str) -> np.ndarray:
    """``(n, n)`` float32 matrix ``B`` with ``out[i] = sum_j in[j] *
    B[j, i]`` the correlation of ``in`` with the symmetric ``kernel``."""
    r = len(kernel) // 2
    b = np.zeros((n, n), np.float64)
    i = np.arange(n)
    for j in range(-r, r + 1):
        np.add.at(b, (_source(i + j, n, mode), i), kernel[j + r])
    return b.astype(np.float32)


def correlate(vol: torch.Tensor, mats: torch.Tensor, axis: int
              ) -> torch.Tensor:
    """Correlate along ``axis`` (of the last three) of ``vol`` by band
    matrices ``mats``: one ``(n, n)`` matrix for every leading index, or
    a ``(S, n, n)`` stack that a leading ``S`` axis of ``vol`` pairs
    with (or that a 3D ``vol`` is broadcast over)."""
    ax = vol.dim() - 3 + axis
    moved = torch.movedim(vol, ax, -1)
    if mats.dim() == 2:
        out = moved @ mats
    elif vol.dim() == 3:
        out = torch.einsum("abn,snm->sabm", moved, mats)
        return torch.movedim(out, -1, ax + 1)
    else:
        out = torch.einsum("sabn,snm->sabm", moved, mats)
    return torch.movedim(out, -1, ax)


@functools.lru_cache(maxsize=64)
def _stack(sigmas, order, n, mode, device):
    """``(S, n, n)`` band matrices on ``device``; callers do not write to
    them."""
    return torch.from_numpy(np.stack(
        [band(gaussian_kernel(s, order), n, mode) for s in sigmas])
    ).to(device)


def log_stack(vol: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """``(S, Z, Y, X)`` scale-normalised negated Laplacian of Gaussian of
    a float32 ``(Z, Y, X)`` volume, reflect border: ``-sigma^2 *
    (d2z + d2y + d2x)``, each term the three 1D passes of scipy's
    ``gaussian_filter`` in axis order."""
    dev = vol.device
    sigmas = tuple(float(s) for s in sigmas)
    n_z, n_y, n_x = vol.shape
    g0z, g2z = (_stack(sigmas, o, n_z, "reflect", dev) for o in (0, 2))
    g0y, g2y = (_stack(sigmas, o, n_y, "reflect", dev) for o in (0, 2))
    g0x, g2x = (_stack(sigmas, o, n_x, "reflect", dev) for o in (0, 2))
    z0 = correlate(vol, g0z, 0)            # G0z f, per sigma
    z2 = correlate(vol, g2z, 0)            # K2z f
    z0y0 = correlate(z0, g0y, 1)
    term_z = correlate(correlate(z2, g0y, 1), g0x, 2)
    term_y = correlate(correlate(z0, g2y, 1), g0x, 2)
    del z0, z2
    term_x = correlate(z0y0, g2x, 2)
    del z0y0
    scale = torch.tensor(
        [float(s) for s in sigmas], dtype=torch.float32, device=dev) ** 2
    return -((term_z + term_y) + term_x) * scale[:, None, None, None]


def gaussian_nearest(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """scipy ``gaussian_filter(vol, sigma, mode='nearest')`` over the
    last three axes (leading axes a batch), float32."""
    out = vol
    for axis in range(3):
        n = out.shape[out.dim() - 3 + axis]
        out = correlate(out, _stack((float(sigma),), 0, n, "nearest",
                                    vol.device)[0], axis)
    return out


def symmetric_index(n: int, before: int, after: int) -> np.ndarray:
    """Indices of numpy ``pad(mode='symmetric')`` along an axis of ``n``."""
    return _source(np.arange(-before, n + after), n, "reflect")


def pad_symmetric(vol: torch.Tensor, pads: Sequence[Tuple[int, int]]
                  ) -> torch.Tensor:
    """numpy ``symmetric`` padding of the last ``len(pads)`` axes."""
    out = vol
    first = vol.dim() - len(pads)
    for i, (before, after) in enumerate(pads):
        ax = first + i
        idx = torch.from_numpy(symmetric_index(
            out.shape[ax], int(before), int(after))).to(vol.device)
        out = torch.index_select(out, ax, idx)
    return out


def erosion_octahedron(vol: torch.Tensor) -> torch.Tensor:
    """Grayscale erosion of the last three axes by the radius-1
    octahedron (the voxel and its 6 face neighbours), symmetric border."""
    p = pad_symmetric(vol, [(1, 1)] * 3)
    z, y, x = vol.shape[-3:]
    out = p[..., 1:1 + z, 1:1 + y, 1:1 + x]
    for dz, dy, dx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1),
                       (1, 1, 0), (1, 1, 2)):
        out = torch.minimum(out, p[..., dz:dz + z, dy:dy + y, dx:dx + x])
    return out


def max_filter_zero(cube: torch.Tensor) -> torch.Tensor:
    """Maximum over the full 3^n neighbourhood, with 0 outside."""
    out = cube
    for ax in range(cube.dim()):
        n = out.shape[ax]
        z = torch.zeros_like(out.narrow(ax, 0, 1))
        p = torch.cat([z, out, z], dim=ax)
        out = torch.maximum(torch.maximum(
            p.narrow(ax, 0, n), p.narrow(ax, 1, n)), p.narrow(ax, 2, n))
    return out


def percentiles(rows: torch.Tensor, q_lo: float, q_hi: float
                ) -> torch.Tensor:
    """``np.percentile(row, (q_lo, q_hi))`` of each row of a float32
    ``(T, V)`` matrix, linear interpolation rounded in float32 (``v0 +
    f32(frac) * (v1 - v0)``). Returns ``(T, 2)``."""
    srt = torch.sort(rows, dim=1).values
    v = rows.shape[1]
    cols = []
    for q in (q_lo, q_hi):
        pos = q / 100.0 * (v - 1)
        lo = math.floor(pos)
        frac = float(np.float32(pos - lo))
        v0 = srt[:, lo]
        if frac > 0:
            v1 = srt[:, min(lo + 1, v - 1)]
            v0 = v0 + torch.tensor(frac, dtype=torch.float32,
                                   device=rows.device) * (v1 - v0)
        cols.append(v0)
    return torch.stack(cols, dim=1)


# --- sphere-overlap pruning: a frozen copy of the port's plain version ---

_SPHERE = 4.0 / 3.0 * math.pi


def _sqrt_ndim(ndim: int) -> float:
    return float(torch.sqrt(torch.tensor(float(ndim), dtype=torch.float32)))


def _overlap_fraction(d, r1, r2):
    rmin = torch.minimum(r1, r2)
    d_safe = torch.clamp_min(d, 1e-12)
    rsum = r1 + r2
    a = rsum - d_safe
    rdiff = r1 - r2
    b = d_safe * d_safe + 2.0 * d_safe * rsum - 3.0 * (rdiff * rdiff)
    lens = math.pi * (a * a) * b / (12.0 * d_safe)
    vol_min = _SPHERE * (rmin * (rmin * rmin))
    frac = lens / torch.clamp_min(vol_min, 1e-12)
    frac = torch.where(d <= torch.abs(rdiff), 1.0, frac)
    return torch.where(d >= rsum, 0.0, frac)


def prune_overlap(coords: torch.Tensor, sigmas: torch.Tensor,
                  overlap: float, rows_at_once: int = 4096) -> torch.Tensor:
    """Keep-mask of ``(K, 3)`` blobs in their order: a blob goes when
    another overlaps it by more than ``overlap`` (lens over the smaller
    sphere, radius ``sigma * sqrt(3)``) and has the larger radius, or the
    same radius and a later row."""
    pos = coords.to(torch.float32)
    r = sigmas.to(torch.float32) * _sqrt_ndim(3)
    idx = torch.arange(len(pos), device=pos.device)
    kept = []
    for lo in range(0, len(pos), rows_at_once):
        blk = slice(lo, lo + rows_at_once)
        diffs = [pos[blk, None, ax] - pos[None, :, ax] for ax in range(3)]
        d2 = diffs[0] * diffs[0]
        for diff in diffs[1:]:
            d2 = d2 + diff * diff
        frac = _overlap_fraction(torch.sqrt(d2), r[blk, None], r[None, :])
        over = (idx[blk, None] != idx) & (frac > overlap)
        loses = over & ((r[None, :] > r[blk, None]) | (
            (r[None, :] == r[blk, None]) & (idx[blk, None] < idx[None, :])))
        kept.append(~torch.any(loses, dim=1))
    if not kept:
        return torch.zeros(0, dtype=torch.bool, device=pos.device)
    return torch.cat(kept)
