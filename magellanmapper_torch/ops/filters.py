"""Separable filters and the scale-normalised LoG pyramid on PyTorch.

Port of ``magellanmapper_tpu/ops/filters.py``. A 1D correlation along an
axis is a product with a dense band matrix whose boundary handling is
folded in (``scipy.ndimage`` semantics), so the LoG pyramid is a handful
of batched fp32 GEMMs. Filters act on the LAST THREE axes of a tensor;
leading axes are a batch (a stack of denoise tiles, for instance).

Only the band-matrix route is ported: the reference switches to taps past
``_MATMUL_MAX_LEN`` samples, which no detection block reaches (blocks are
capped at 256 px a side), and this port raises there instead.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: longest axis the band-matrix route takes (the reference's taps
#: crossover, ``filters.py:26-27``)
_MATMUL_MAX_LEN = 768


def gaussian_kernel1d(
        sigma: float, order: int = 0, radius: Optional[int] = None,
        truncate: float = 4.0) -> np.ndarray:
    """Sampled-Gaussian 1D kernel matching ``scipy.ndimage`` semantics
    (copy of the reference's numpy version)."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    sigma2 = float(sigma) * float(sigma)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi = phi / phi.sum()
    if order == 0:
        return phi
    # polynomial q(x) with q0 = 1; derivative recurrence:
    # d/dx [q(x) phi(x)] = (q'(x) - q(x) x / sigma^2) phi(x)
    q = np.zeros(order + 1)
    q[0] = 1.0
    D = np.diag(np.arange(1, order + 1), 1)      # q -> q'
    P = np.diag(np.ones(order) / -sigma2, -1)    # q -> -x/sigma^2 q
    Q = D + P
    for _ in range(order):
        q = Q.dot(q)
    return (x[:, None] ** np.arange(order + 1)).dot(q) * phi


@functools.lru_cache(maxsize=256)
def _band_matrix(
        kernel_bytes: bytes, klen: int, n: int, mode: str,
        cval: float) -> np.ndarray:
    """Dense ``(n, n)`` band matrix B with boundary handling folded in:
    ``out[i] = sum_j B[j, i] * in[j]`` (copy of the reference's).
    """
    kernel = np.frombuffer(kernel_bytes, dtype=np.float64).copy()
    r = klen // 2
    b = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for j in range(-r, r + 1):
        w = kernel[j + r]
        src = idx + j
        if mode == "reflect":       # scipy 'reflect': (d c b a | a b c d)
            src = np.where(src < 0, -src - 1, src)
            src = np.where(src >= n, 2 * n - src - 1, src)
            # repeated reflection for kernels wider than the axis
            for _ in range(int(math.ceil(r / max(n, 1)))):
                src = np.where(src < 0, -src - 1, src)
                src = np.where(src >= n, 2 * n - src - 1, src)
        elif mode == "nearest":     # (a a a a | a b c d)
            src = np.clip(src, 0, n - 1)
        elif mode == "mirror":      # (d c b | a b c d)
            period = max(2 * n - 2, 1)
            src = np.abs(src) % period
            src = np.where(src >= n, period - src, src)
        elif mode == "constant":
            valid = (src >= 0) & (src < n)
            np.add.at(b, (src[valid], idx[valid]), w)
            continue
        elif mode == "wrap":
            src = src % n
        else:
            raise ValueError(f"unknown boundary mode: {mode}")
        np.add.at(b, (src, idx), w)
    return b.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _bands(sigmas: Tuple[float, ...], order: int, n: int, mode: str,
           truncate: float, device: torch.device) -> torch.Tensor:
    """``(len(sigmas), n, n)`` stack of band matrices on ``device``."""
    if n > _MATMUL_MAX_LEN:
        raise NotImplementedError(
            f"axis of {n} samples: the tap-based route past "
            f"{_MATMUL_MAX_LEN} samples is not ported yet")
    mats = []
    for s in sigmas:
        kernel = np.asarray(
            gaussian_kernel1d(s, order, truncate=truncate), np.float64)
        mats.append(_band_matrix(kernel.tobytes(), len(kernel), n, mode, 0.0))
    return torch.from_numpy(np.stack(mats)).to(device)


@functools.lru_cache(maxsize=64)
def sigma_tensor(sigmas: Tuple[float, ...],
                 device: torch.device) -> torch.Tensor:
    """``sigmas`` as a float32 tensor on ``device``, shipped once rather
    than once per block. Callers must not write to it."""
    return torch.tensor(sigmas, dtype=torch.float32, device=device)


def gaussian_filter(
        vol: torch.Tensor, sigma: float, order: int = 0,
        mode: str = "reflect", truncate: float = 4.0) -> torch.Tensor:
    """Gaussian filter over the last three axes (scipy
    ``gaussian_filter`` semantics, one sigma and order for every axis),
    one band-matrix product per axis."""
    if sigma <= 0:
        return vol
    out = vol
    for ax in (-3, -2, -1):
        band = _bands((float(sigma),), order, out.shape[ax], mode, truncate,
                      out.device)[0].to(out.dtype)
        out = torch.movedim(
            torch.tensordot(out, band, dims=([ax], [0])), -1, ax)
    return out


def log_pyramid(
        vol: torch.Tensor, sigmas: Sequence[float], mode: str = "reflect",
        truncate: float = 4.0) -> torch.Tensor:
    """Scale-normalised negated LoG pyramid ``(S, Z, Y, X)`` of a
    ``(Z, Y, X)`` float32 volume, as seven scale-batched fp32 einsums
    (``filters.py:213-270``): the z pass uses linearity,
    ``G0z K2y A + G0z G0y B = G0z (K2y A + G0y B)``."""
    if vol.dim() != 3:
        raise ValueError(f"log_pyramid takes a 3D volume, got {vol.dim()}D")
    sigmas = tuple(float(s) for s in sigmas)

    def bands(order, axis):
        return _bands(sigmas, order, vol.shape[axis], mode, truncate,
                      vol.device).to(vol.dtype)

    b0x, b2x = bands(0, 2), bands(2, 2)
    b0y, b2y = bands(0, 1), bands(2, 1)
    b0z, b2z = bands(0, 0), bands(2, 0)
    a = torch.einsum("zyx,sxu->szyu", vol, b0x)        # G0x f
    bx = torch.einsum("zyx,sxu->szyu", vol, b2x)       # K2x f
    u0 = torch.einsum("szyx,syu->szux", a, b0y)        # G0y A
    u2 = torch.einsum("szyx,syu->szux", a, b2y)        # K2y A
    w = torch.einsum("szyx,syu->szux", bx, b0y)        # G0y B
    t1 = torch.einsum("szyx,szu->suyx", u0, b2z)       # K2z G0y A
    t23 = torch.einsum("szyx,szu->suyx", u2 + w, b0z)  # G0z (K2y A + G0y B)
    scale = sigma_tensor(sigmas, vol.device).to(vol.dtype) ** 2
    return -(t1 + t23) * scale[:, None, None, None]


def pad_symmetric(
        vol: torch.Tensor, pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """numpy ``mode='symmetric'`` padding of the last ``len(pads)`` axes
    (``abc -> cba|abc|cba``) by flip and concatenate, for any dtype; a pad
    wider than the axis reflects again off the already-extended end
    (``stack_detect.py:246-267``)."""
    # PyTorch lacks flip for uint16; the int16 view moves the same bits
    out = vol.view(torch.int16) if vol.dtype == torch.uint16 else vol
    first = vol.dim() - len(pads)
    for i, (before, after) in enumerate(pads):
        ax = first + i
        before, after = int(before), int(after)
        while after > 0:
            n = out.shape[ax]
            take = min(after, n)
            out = torch.cat(
                [out, out.narrow(ax, n - take, take).flip(ax)], dim=ax)
            after -= take
        while before > 0:
            n = out.shape[ax]
            take = min(before, n)
            out = torch.cat(
                [out.narrow(ax, 0, take).flip(ax), out], dim=ax)
            before -= take
    return out.view(vol.dtype)


def erosion(vol: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Grayscale erosion of the last three axes by a boolean footprint,
    with a symmetric border."""
    footprint = np.asarray(footprint).astype(bool)
    r = [s // 2 for s in footprint.shape]
    padded = pad_symmetric(vol, [(ri, ri) for ri in r])
    spatial = vol.shape[-3:]
    out = None
    for offset in np.argwhere(footprint):
        term = padded[(...,) + tuple(
            slice(int(o), int(o) + s) for o, s in zip(offset, spatial))]
        out = term if out is None else torch.minimum(out, term)
    return out


def octahedron_footprint(radius: int = 1) -> np.ndarray:
    """Octahedron (L1 ball) structuring element (skimage ``octahedron``)."""
    n = 2 * radius + 1
    grid = np.abs(np.indices((n, n, n)) - radius).sum(axis=0)
    return grid <= radius
