"""Separable filters and the scale-normalised LoG pyramid on PyTorch.

Port of ``magellanmapper_tpu/ops/filters.py``. A 1D correlation along an
axis is a product with a dense band matrix whose boundary handling is
folded in (``scipy.ndimage`` semantics), so the LoG pyramid is a handful
of batched fp32 GEMMs. Filters act on the LAST THREE axes of a tensor;
leading axes are a batch (a stack of denoise tiles, for instance).

``precision="tf32"`` is the reference's ``fast`` route (its
``Precision.DEFAULT``, one bf16 pass on the TPU): on the card the band
products run as TF32 GEMMs with float32 output, allowed only for the
duration of those products (:func:`band_precision`); on the CPU they
stay float32, as the reference's DEFAULT is on the JAX CPU. The taps
route ignores it, as the reference's does.

Past ``_MATMUL_MAX_LEN`` samples an axis takes taps instead, as in the
reference: a padded ``F.conv1d`` over every 1D line of that axis
(:func:`conv1d`), and :func:`log_pyramid` becomes a per-sigma
:func:`gaussian_laplace` stack in which each axis picks its route.

Morphology: grayscale :func:`erosion`/:func:`dilation` with the
reference's symmetric border, and binary erosion, dilation, opening and
closing with ``scipy.ndimage``'s (a zero border, one iteration), which
the reference runs on the host per label: here a structuring element is
cut into rows along x, each row one ``max_pool1d`` window, and the rows
are combined shifted in z and y, so a ball of radius 8 costs ~200
elementwise passes on the card instead of 2,000 shifted copies.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from magellanmapper_torch import device as device_mod

#: longest axis the band-matrix route takes (the reference's taps
#: crossover, ``filters.py:26-27``)
_MATMUL_MAX_LEN = 768

#: the fast route's ``precision``: TF32 band products on the card
FAST_PRECISION = "tf32"


@contextlib.contextmanager
def band_precision(precision: Optional[str],
                   device: torch.device) -> Iterator[None]:
    """Run the enclosed band products at ``precision``: None (or
    ``"highest"``) leaves them in full float32; :data:`FAST_PRECISION`
    allows TF32 for cuBLAS float32 products on a CUDA ``device`` until
    the block exits, raising or not, counting the block in
    ``device.TF32_SCOPES``, and changes nothing on the CPU. ``device.py``
    keeps TF32 off everywhere else."""
    if precision in (None, "highest"):
        yield
        return
    if precision != FAST_PRECISION:
        raise ValueError(f"unknown precision: {precision!r}")
    if torch.device(device).type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    device_mod.TF32_SCOPES["band_products"] += 1
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


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


@functools.lru_cache(maxsize=256)
def _band_on(kernel_bytes: bytes, klen: int, n: int, mode: str,
             device: torch.device) -> torch.Tensor:
    """One band matrix on ``device``, shipped once. Callers must not
    write to it."""
    return torch.from_numpy(
        _band_matrix(kernel_bytes, klen, n, mode, 0.0)).to(device)


def _bands(sigmas: Tuple[float, ...], order: int, n: int, mode: str,
           truncate: float, device: torch.device) -> torch.Tensor:
    """``(len(sigmas), n, n)`` stack of band matrices on ``device``,
    stacked anew from the cached matrices of :func:`_band_on`."""
    mats = []
    for s in sigmas:
        kernel = np.asarray(
            gaussian_kernel1d(s, order, truncate=truncate), np.float64)
        mats.append(_band_on(kernel.tobytes(), len(kernel), n, mode, device))
    return torch.stack(mats)


@functools.lru_cache(maxsize=64)
def sigma_tensor(sigmas: Tuple[float, ...],
                 device: torch.device) -> torch.Tensor:
    """``sigmas`` as a float32 tensor on ``device``, shipped once rather
    than once per block. Callers must not write to it."""
    return torch.tensor(sigmas, dtype=torch.float32, device=device)


def conv1d(vol: torch.Tensor, kernel: np.ndarray, axis: int,
           mode: str = "reflect", cval: float = 0.0,
           precision: Optional[str] = None) -> torch.Tensor:
    """Correlate ``vol`` with a symmetric 1D ``kernel`` along ``axis``:
    a band-matrix product at ``precision`` (:func:`band_precision`) up
    to ``_MATMUL_MAX_LEN`` samples, float32 taps past it
    (``filters.py:101-124``)."""
    kernel = np.asarray(kernel, np.float64)
    n = vol.shape[axis]
    if n <= _MATMUL_MAX_LEN:
        band = _band_on(kernel.tobytes(), len(kernel), n, mode,
                        vol.device).to(vol.dtype)
        with band_precision(precision, vol.device):
            out = torch.tensordot(vol, band, dims=([axis], [0]))
        return torch.movedim(out, -1, axis)
    return _conv1d_taps(vol, kernel, axis, mode, cval)


#: numpy ``pad`` modes of the scipy boundary modes (``filters.py:145-147``)
_PAD_MODES = {"nearest": "replicate", "mirror": "reflect", "wrap": "circular"}


def _conv1d_taps(vol: torch.Tensor, kernel: np.ndarray, axis: int,
                 mode: str, cval: float) -> torch.Tensor:
    """Tap-based 1D correlation: pad every line of ``axis`` by the
    kernel radius under ``mode``, then one ``F.conv1d`` (``filters.py:
    135-154``). scipy's reflect is numpy's symmetric padding, nearest
    edge, mirror numpy's reflect."""
    axis = axis % vol.dim()
    r = len(kernel) // 2
    moved = torch.movedim(vol, axis, -1)
    batch_shape, n = moved.shape[:-1], moved.shape[-1]
    flat = moved.reshape(-1, 1, n)
    if mode == "reflect":
        flat = pad_symmetric(flat, [(r, r)])
    elif mode == "constant":
        flat = F.pad(flat, (r, r), value=float(cval))
    elif mode in _PAD_MODES:
        flat = F.pad(flat, (r, r), mode=_PAD_MODES[mode])
    else:
        raise ValueError(f"unknown boundary mode: {mode}")
    taps = torch.from_numpy(kernel.astype(np.float32)).to(
        device=vol.device, dtype=vol.dtype).reshape(1, 1, -1)
    out = F.conv1d(flat, taps)
    return torch.movedim(out.reshape(*batch_shape, n), -1, axis)


def gaussian_filter(
        vol: torch.Tensor, sigma: float, order: int = 0,
        mode: str = "reflect", truncate: float = 4.0) -> torch.Tensor:
    """Gaussian filter over the last three axes (scipy
    ``gaussian_filter`` semantics, one sigma and order for every axis),
    one :func:`conv1d` per axis."""
    if sigma <= 0:
        return vol
    kernel = gaussian_kernel1d(sigma, order, truncate=truncate)
    out = vol
    for ax in (-3, -2, -1):
        out = conv1d(out, kernel, ax, mode)
    return out


def gaussian_laplace(
        vol: torch.Tensor, sigma, mode: str = "reflect",
        truncate: float = 4.0,
        precision: Optional[str] = None) -> torch.Tensor:
    """Laplacian of Gaussian over every axis of ``vol`` (scipy
    ``gaussian_laplace`` semantics; ``sigma`` a scalar or one per axis),
    each pass a :func:`conv1d`. A 3D volume shares the order-0 passes
    across the three terms, 8 passes instead of 9, and only those take
    ``precision``, as in the reference (``filters.py:180-210``)."""
    ndim = vol.dim()
    sigmas = ((float(sigma),) * ndim if np.isscalar(sigma)
              else tuple(float(s) for s in sigma))
    if len(sigmas) != ndim:
        raise ValueError(f"{len(sigmas)} sigmas for {ndim} axes")
    k0 = [gaussian_kernel1d(s, 0, truncate=truncate) for s in sigmas]
    k2 = [gaussian_kernel1d(s, 2, truncate=truncate) for s in sigmas]

    if ndim != 3:
        out = None
        for d_ax in range(ndim):
            term = vol
            for ax in range(ndim):
                term = conv1d(term, k2[ax] if ax == d_ax else k0[ax], ax,
                              mode)
            out = term if out is None else out + term
        return out

    def c(v, k, ax):
        return conv1d(v, k, ax, mode, precision=precision)

    a = c(vol, k0[2], 2)                      # G0x f
    t1 = c(c(a, k0[1], 1), k2[0], 0)          # K2z G0y A
    t2 = c(c(a, k2[1], 1), k0[0], 0)          # G0z K2y A
    b = c(vol, k2[2], 2)                      # K2x f
    t3 = c(c(b, k0[1], 1), k0[0], 0)          # G0z G0y B
    return t1 + t2 + t3


def log_pyramid(
        vol: torch.Tensor, sigmas: Sequence[float], mode: str = "reflect",
        truncate: float = 4.0,
        precision: Optional[str] = None) -> torch.Tensor:
    """Scale-normalised negated LoG pyramid ``(S, Z, Y, X)`` of a
    ``(Z, Y, X)`` float32 volume, as seven scale-batched fp32 einsums
    (``filters.py:213-270``): the z pass uses linearity,
    ``G0z K2y A + G0z G0y B = G0z (K2y A + G0y B)``. Past
    ``_MATMUL_MAX_LEN`` samples on any axis, the dense ``(S, n, n)`` band
    stacks would cost O(n^2) per axis, so the pyramid is a per-sigma
    :func:`gaussian_laplace` stack instead, each axis taking band or taps
    on its own (``filters.py:230-240``). Every band product runs at
    ``precision`` (:func:`band_precision`)."""
    if vol.dim() != 3:
        raise ValueError(f"log_pyramid takes a 3D volume, got {vol.dim()}D")
    sigmas = tuple(float(s) for s in sigmas)
    scale = sigma_tensor(sigmas, vol.device).to(vol.dtype) ** 2
    if max(vol.shape) > _MATMUL_MAX_LEN:
        stacked = torch.stack([
            -gaussian_laplace(vol, s, mode=mode, truncate=truncate,
                              precision=precision)
            for s in sigmas])
        return stacked * scale[:, None, None, None]

    def bands(order, axis):
        return _bands(sigmas, order, vol.shape[axis], mode, truncate,
                      vol.device).to(vol.dtype)

    b0x, b2x = bands(0, 2), bands(2, 2)
    b0y, b2y = bands(0, 1), bands(2, 1)
    b0z, b2z = bands(0, 0), bands(2, 0)
    with band_precision(precision, vol.device):
        a = torch.einsum("zyx,sxu->szyu", vol, b0x)        # G0x f
        bx = torch.einsum("zyx,sxu->szyu", vol, b2x)       # K2x f
        u0 = torch.einsum("szyx,syu->szux", a, b0y)        # G0y A
        u2 = torch.einsum("szyx,syu->szux", a, b2y)        # K2y A
        w = torch.einsum("szyx,syu->szux", bx, b0y)        # G0y B
        t1 = torch.einsum("szyx,szu->suyx", u0, b2z)       # K2z G0y A
        # G0z (K2y A + G0y B)
        t23 = torch.einsum("szyx,szu->suyx", u2 + w, b0z)
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
    return _morph(vol, footprint, torch.minimum)


def dilation(vol: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Grayscale dilation of the last three axes by a boolean footprint
    (not reflected), with a symmetric border (``filters.py:283-287``)."""
    return _morph(vol, footprint, torch.maximum)


def _morph(vol: torch.Tensor, footprint: np.ndarray, reduce_fn):
    """``reduce_fn`` over the footprint's offsets of the symmetrically
    padded volume (``filters.py:290-308``)."""
    footprint = np.asarray(footprint).astype(bool)
    r = [s // 2 for s in footprint.shape]
    padded = pad_symmetric(vol, [(ri, ri) for ri in r])
    spatial = vol.shape[-3:]
    out = None
    for offset in np.argwhere(footprint):
        term = padded[(...,) + tuple(
            slice(int(o), int(o) + s) for o, s in zip(offset, spatial))]
        out = term if out is None else reduce_fn(out, term)
    return out


def ball_footprint(radius: int) -> np.ndarray:
    """Ball (L2) structuring element (skimage ``ball``)."""
    n = 2 * radius + 1
    grid = ((np.indices((n, n, n)) - radius) ** 2).sum(axis=0)
    return grid <= radius * radius


def cube_footprint(width: int) -> np.ndarray:
    """Cube structuring element (skimage ``cube``)."""
    return np.ones((width,) * 3, dtype=bool)


def _x_runs(structure: np.ndarray):
    """The structuring element ``(nz, ny, nx)`` as rows along x: ``{(lo,
    hi): [(dz, dy), ...]}``, each row's x offsets ``lo..hi`` about the
    centre; raises unless every row is one run."""
    structure = np.asarray(structure).astype(bool)
    c = [s // 2 for s in structure.shape]
    runs = {}
    for iz, iy in zip(*np.nonzero(structure.any(axis=2))):
        xs = np.flatnonzero(structure[iz, iy]) - c[2]
        if xs[-1] - xs[0] + 1 != len(xs):
            raise ValueError("each row of the structuring element along x "
                             "must be one run")
        runs.setdefault((int(xs[0]), int(xs[-1])), []).append(
            (int(iz - c[0]), int(iy - c[1])))
    return runs


def window_reduce(vol: torch.Tensor, structure: np.ndarray,
                  maximum: bool, fill: float = 0.0) -> torch.Tensor:
    """Minimum (or ``maximum``) of a 3D float volume over ``structure``'s
    offsets about each voxel, ``out[v] = reduce(vol[v + o])``, with
    ``fill`` outside the volume: one ``max_pool1d`` window a distinct row
    of the structure, then the rows shifted in z and y."""
    structure = np.asarray(structure).astype(bool)
    rz, ry, rx = (s // 2 for s in structure.shape)
    nz, ny, nx = vol.shape
    # a minimum is the negated maximum of the negated volume
    padded = F.pad(vol if maximum else -vol, (rx, rx, ry, ry, rz, rz),
                   value=fill if maximum else -fill)
    out = None
    for (lo, hi), rows in _x_runs(structure).items():
        lines = padded[..., rx + lo:rx + nx + hi]
        run = F.max_pool1d(lines.reshape(1, -1, lines.shape[-1]),
                           hi - lo + 1, stride=1).reshape(
            nz + 2 * rz, ny + 2 * ry, nx)
        for dz, dy in rows:
            term = run[rz + dz:rz + dz + nz, ry + dy:ry + dy + ny]
            out = term.clone() if out is None else torch.maximum(
                out, term, out=out)
    return out if maximum else -out


def _binary(mask: torch.Tensor, structure, maximum: bool) -> torch.Tensor:
    """``window_reduce`` of a 2D or 3D boolean mask with a zero border;
    a 2D mask takes a 2D structure."""
    structure = np.asarray(structure).astype(bool)
    flat = mask.dim() == 2
    vol = (mask[None] if flat else mask).to(torch.float32)
    if flat:
        structure = structure[None]
    out = window_reduce(vol, structure, maximum) > 0.5
    return out[0] if flat else out


def binary_erosion(mask: torch.Tensor, structure) -> torch.Tensor:
    """``scipy.ndimage.binary_erosion(mask, structure)`` (one iteration,
    ``border_value=0``): a voxel stays where every offset of the structure
    about it lies in the mask."""
    return _binary(mask, structure, maximum=False)


def binary_dilation(mask: torch.Tensor, structure) -> torch.Tensor:
    """``scipy.ndimage.binary_dilation(mask, structure)`` (one iteration,
    ``border_value=0``): the structure, reflected, placed on every mask
    voxel."""
    structure = np.asarray(structure).astype(bool)
    return _binary(mask, structure[(slice(None, None, -1),)
                                   * structure.ndim], maximum=True)


def binary_opening(mask: torch.Tensor, structure) -> torch.Tensor:
    """``scipy.ndimage.binary_opening``: dilation of the erosion."""
    return binary_dilation(binary_erosion(mask, structure), structure)


def binary_closing(mask: torch.Tensor, structure) -> torch.Tensor:
    """``scipy.ndimage.binary_closing``: erosion of the dilation, both
    with a zero border (so the border itself erodes, as in scipy)."""
    return binary_erosion(binary_dilation(mask, structure), structure)


def octahedron_footprint(radius: int = 1) -> np.ndarray:
    """Octahedron (L1 ball) structuring element (skimage ``octahedron``)."""
    n = 2 * radius + 1
    grid = np.abs(np.indices((n, n, n)) - radius).sum(axis=0)
    return grid <= radius
