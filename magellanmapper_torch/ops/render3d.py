"""3D rendering on PyTorch: ray casting and shear-warp.

Port of ``magellanmapper_tpu/ops/render3d.py``, the two engines behind the
3D views (``mlab.volume``, ``mlab.contour3d`` and ``mlab.points3d`` in the
reference's Mayavi scene), sharing one orthographic orbit camera:

- Gather ray casters (:func:`render_volume`, :func:`render_isosurface`):
  rays march front to back with trilinear samples. The sample is
  ``map_coordinates(order=1, mode="constant")`` written out (the eight
  corners in the reference's order, each out-of-range corner adding 0);
  ``F.grid_sample`` is not used, since its normalised coordinates round.
  The march samples a chunk of steps of the whole (H, W) ray front in one
  gather and composites its steps one by one, so each ray's compositing
  order is the reference's.
- Shear-warp engines (:func:`render_volume_sw`, :func:`render_isosurface_sw`,
  :func:`render_channels_sw`): the Lacroute-Levoy factorisation with the
  reference's arithmetic: each slice sheared by two 1D resamples, a
  composite along the principal axis, and a two-pass affine warp of the
  intermediate image onto the film. The reference applies each resample
  as a one-hot (B, n_out, n_in) band matrix; here each output is its two
  taps (the same indices and weights, zero outside), the product without
  its zeros. The volume is sheared and composited in slabs along the
  principal axis, carrying the transmittance (or the running maximum, or
  the first crossing), so a frame holds a few slabs, never the sheared
  volume.

The camera's basis is computed on the host in float32 as the reference
computes it under XLA on the CPU: the C library's ``sinf``/``cosf`` and a
fused multiply-add in each cross product and the norm. So both packages,
and the card and the CPU, orbit with the same bits, and
:func:`render_blobs_overlay` projects blobs exactly as the reference does.

Every renderer takes a numpy array or a tensor and ``device`` (``"cuda"``
by default; raises without a card); it returns tensors on that device.
The film-sharded renderers (``render_volume_sharded``,
``render_isosurface_sharded``) are not ported yet (ROADMAP queue item 10).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod

_F32 = np.float32
#: sample points a gather chunk holds (steps x film pixels)
CHUNK_POINTS = 1 << 22
#: voxels of one sheared slab (slices x intermediate image)
SLAB_VOXELS = 1 << 26


# -- the camera ---------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return lib


def _fma32(a, b, c):
    """``a * b + c`` of float32 values (or arrays) rounded once, as XLA
    contracts a product and the sum it feeds on the CPU (the product is
    exact in float64)."""
    return _F32(np.float64(a) * np.float64(b) + np.float64(c)) if np.ndim(
        a) == np.ndim(b) == np.ndim(c) == 0 else (
        np.asarray(a, np.float64) * np.asarray(b, np.float64)
        + np.asarray(c, np.float64)).astype(_F32)


def _cross32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 cross product, each component one fused multiply-add of
    a rounded product, as XLA evaluates ``jnp.cross`` on the CPU."""
    return np.array([
        _fma32(a[1], b[2], -_F32(a[2] * b[1])),
        _fma32(a[2], b[0], -_F32(a[0] * b[2])),
        _fma32(a[0], b[1], -_F32(a[1] * b[0]))], _F32)


def camera_basis(azim_deg: float, elev_deg: float, fused: bool = False):
    """Orthonormal float32 ``(view, right, up)`` of an orbit camera, numpy
    arrays in (z, y, x) order.

    Angles follow matplotlib's ``view_init`` (azimuth about the z axis,
    elevation above the xy plane); ``view`` points from the camera toward
    the centre, z (axis 0) is up, and at a pole ``right`` falls back to
    the x axis. ``fused`` gives the bits of the basis inside the
    reference's jitted renderers, where XLA contracts the other product
    of ``up``'s first component (the renderers use it); without it, the
    bits of the reference's ``camera_basis`` called alone.
    """
    libm = _libm()
    rad = _F32(np.pi / 180)
    az = _F32(_F32(azim_deg) * rad)
    el = _F32(_F32(elev_deg) * rad)
    s_el, c_el = _F32(libm.sinf(float(el))), _F32(libm.cosf(float(el)))
    s_az, c_az = _F32(libm.sinf(float(az))), _F32(libm.cosf(float(az)))
    view = -np.array([s_el, c_el * s_az, c_el * c_az], _F32)
    right = _cross32(view, np.array([1, 0, 0], _F32))
    nrm = np.sqrt(_fma32(right[2], right[2], _fma32(
        right[1], right[1], _F32(right[0] * right[0]))))
    right = (right / np.maximum(nrm, _F32(1e-6)) if nrm > _F32(1e-5)
             else np.array([0, 0, 1], _F32))
    up = _cross32(right, view)
    if fused:
        up[0] = _fma32(-right[2], view[1], _F32(right[1] * view[2]))
    return view, right, up


def _volume(vol, dev: torch.device) -> torch.Tensor:
    if isinstance(vol, torch.Tensor):
        return vol.to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(vol, _F32)).to(dev)


def _radius(shape) -> np.float32:
    return _F32(np.sqrt(np.sum(np.asarray(shape, _F32) ** 2)) / _F32(2))


def _ray_grid(shape, azim_deg, elev_deg, out_hw, zoom, perspective: bool,
              dev: torch.device):
    """Ray origins ``(H, W, 3)`` on the film, their unit directions (the
    shared ``(1, 1, 3)`` view direction, or per pixel from an eye at
    ``2.5 * radius / zoom`` with ``perspective``) and the bounding
    sphere's radius, in voxel (z, y, x) coordinates. Computed on the host
    in float32, so that the card and the CPU march the same rays (the
    card divides by a scalar through its reciprocal)."""
    h, w = out_hw
    center = (np.asarray(shape, _F32) - 1) / _F32(2)
    radius = _radius(shape)
    view, right, up = camera_basis(azim_deg, elev_deg, fused=True)
    span = _F32(_F32(2) * radius / _F32(zoom))
    ys = (np.arange(h, dtype=_F32) / _F32(max(h - 1, 1)) - _F32(0.5)) * span
    xs = (np.arange(w, dtype=_F32) / _F32(max(w - 1, 1)) - _F32(0.5)) * span
    film = (center - view * radius)[None, None] \
        - up * ys[:, None, None] + right * xs[None, :, None]
    if not perspective:
        dirs = view[None, None]
    else:
        eye = center - view * _F32(_F32(2.5) * radius / _F32(zoom))
        dirs = film - eye
        dirs = dirs / np.sqrt(np.sum(dirs * dirs, axis=-1, keepdims=True))
    return (torch.from_numpy(film).to(dev), torch.from_numpy(dirs).to(dev),
            radius)


# -- the gather ray casters ------------------------------------------------------

def _sample(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``vol`` at ``(..., 3)`` voxel coordinates, 0
    outside: ``map_coordinates(order=1, mode="constant", cval=0)``, its
    eight corners summed in its order."""
    flat = vol.reshape(-1)
    strides = (vol.shape[1] * vol.shape[2], vol.shape[2], 1)
    taps = []
    for ax in range(3):
        coord = pts[..., ax]
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        n = vol.shape[ax]
        taps.append([
            (torch.clamp(i, 0, n - 1) * strides[ax], (i >= 0) & (i < n), wt)
            for i, wt in ((index, 1 - upper_w), (index + 1, upper_w))])
    out = None
    for (iz, vz, wz) in taps[0]:
        for (iy, vy, wy) in taps[1]:
            zy, vzy, wzy = iz + iy, vz & vy, wz * wy
            for (ix, vx, wx) in taps[2]:
                val = torch.where(vzy & vx, flat.take(zy + ix), 0.0)
                term = wzy * wx * val
                out = term if out is None else out + term
    return out


def _gradient_at(vol: torch.Tensor, pts: torch.Tensor,
                 eps: float = 1.0) -> torch.Tensor:
    """Central-difference intensity gradient at sample points."""
    grads = []
    for ax in range(3):
        fwd, bwd = pts.clone(), pts.clone()
        fwd[..., ax] += eps
        bwd[..., ax] -= eps
        grads.append((_sample(vol, fwd) - _sample(vol, bwd)) / (2 * eps))
    return torch.stack(grads, dim=-1)


def _unit(vec) -> np.ndarray:
    vec = np.asarray(vec, _F32)
    return vec / np.maximum(np.sqrt(np.sum(vec * vec, dtype=_F32)),
                            _F32(1e-6))


def _chunks(n_steps: int, n_rays: int):
    step = max(1, CHUNK_POINTS // max(n_rays, 1))
    for k0 in range(0, n_steps, step):
        yield k0, min(n_steps, k0 + step)


def _march_points(origins, dirs, dt, k0, k1):
    """``(K, H, W, 3)`` sample points of steps ``k0..k1``: ``origins +
    dirs * (i * dt)``."""
    t = torch.arange(k0, k1, dtype=torch.float32,
                     device=origins.device) * float(dt)
    return origins[None] + dirs[None] * t[:, None, None, None]


def render_volume(
        vol, azim_deg, elev_deg, vmin=0.0, vmax=1.0,
        out_hw: Tuple[int, int] = (512, 512), n_steps: int = 256, zoom=1.0,
        opacity=0.05, gamma=1.0, color=(1.0, 1.0, 1.0), bg=(0.0, 0.0, 0.0),
        shaded: bool = False, light_dir: Optional[Sequence[float]] = None,
        perspective: bool = False, device="cuda") -> torch.Tensor:
    """Direct volume rendering (``mlab.volume``), front to back.

    Each step samples the (H, W) ray front, maps intensity through the
    window/gamma transfer function to opacity ``a`` and emission
    ``a * color`` (times ``0.35 + 0.65 |n . l|`` with ``shaded``, ``n``
    the central-difference normal and ``l`` the headlight or
    ``light_dir``), and composites ``C += T * a * c; T *= (1 - a)``.
    ``perspective`` diverges the rays from an eye point (the Mayavi
    camera). Returns an (H, W, 3) float32 image in [0, 1].
    """
    dev = device_mod.resolve(device)
    vol = _volume(vol, dev)
    view = camera_basis(azim_deg, elev_deg, fused=True)[0]
    origins, dirs, radius = _ray_grid(vol.shape, azim_deg, elev_deg, out_hw,
                                      zoom, perspective, dev)
    dt = _F32(_F32(2) * radius / _F32(n_steps))
    col = torch.tensor(color, dtype=torch.float32, device=dev)
    bgc = torch.tensor(bg, dtype=torch.float32, device=dev)
    span = float(max(_F32(vmax) - _F32(vmin), _F32(1e-6)))
    ldir = None
    if shaded:
        ldir = torch.from_numpy(_unit(
            -view if light_dir is None else light_dir)).to(dev)
    h, w = out_hw
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((h, w), dtype=torch.float32, device=dev)
    for k0, k1 in _chunks(n_steps, h * w):
        pts = _march_points(origins, dirs, dt, k0, k1)
        s = _sample(vol, pts)
        a = torch.clamp((s - float(vmin)) / span, 0.0, 1.0) ** gamma \
            * opacity
        emis = col.expand(k1 - k0, 1, 1, 3)
        if ldir is not None:
            g = _gradient_at(vol, pts)
            n = g / torch.clamp_min(
                torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-6)
            lam = torch.abs(torch.sum(n * ldir, dim=-1))
            emis = col * (0.35 + 0.65 * lam)[..., None]
        for j in range(k1 - k0):
            acc = acc + (trans * a[j])[..., None] * emis[j]
            trans = trans * (1.0 - a[j])
    return torch.clamp(acc + trans[..., None] * bgc, 0.0, 1.0)


def render_isosurface(
        vol, level, azim_deg, elev_deg,
        out_hw: Tuple[int, int] = (512, 512), n_steps: int = 256, zoom=1.0,
        color=(0.8, 0.8, 0.85), bg=(0.0, 0.0, 0.0),
        light_dir: Optional[Sequence[float]] = None, specular=0.4,
        shininess=24.0, perspective: bool = False, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shaded isosurface ray casting (``mlab.contour3d``).

    Marches each ray to its first sample at or above ``level``, refines
    the crossing linearly between the bracketing steps, then shades once
    a pixel with Blinn-Phong from the central-difference normal and the
    headlight (or ``light_dir``). Returns ``(rgb (H, W, 3), depth
    (H, W))``; depth is the ray parameter in voxels, ``inf`` on a miss.
    """
    dev = device_mod.resolve(device)
    vol = _volume(vol, dev)
    view = camera_basis(azim_deg, elev_deg, fused=True)[0]
    origins, dirs, radius = _ray_grid(vol.shape, azim_deg, elev_deg, out_hw,
                                      zoom, perspective, dev)
    dt = _F32(_F32(2) * radius / _F32(n_steps))
    lvl = float(_F32(level))
    h, w = out_hw
    t_hit = torch.full((h, w), float("inf"), device=dev)
    s_prev = torch.zeros((h, w), dtype=torch.float32, device=dev)
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k0, k1 in _chunks(n_steps, h * w):
        s = _sample(vol, _march_points(origins, dirs, dt, k0, k1))
        above = s >= lvl
        first = torch.argmax(above.to(torch.uint8), dim=0, keepdim=True)
        s_at = torch.gather(s, 0, first)[0]
        prev = torch.cat([s_prev[None], s[:-1]]).gather(0, first)[0]
        t = (first[0] + k0).to(torch.float32) * float(dt)
        frac = torch.where(torch.abs(s_at - prev) > 1e-9,
                           (lvl - prev) / (s_at - prev), 1.0)
        t_ref = torch.clamp_min(t - float(dt) + frac * float(dt), 0.0)
        crossing = ~hit & above.any(dim=0)
        t_hit = torch.where(crossing, t_ref, t_hit)
        hit = hit | crossing
        s_prev = s[-1]
    pts = origins + dirs * torch.where(hit, t_hit, 0.0)[..., None]
    g = _gradient_at(vol, pts)
    n = g / torch.clamp_min(
        torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-6)
    n = n * -torch.sign(torch.sum(n * dirs, dim=-1, keepdim=True))
    ldir = _unit(-view if light_dir is None else light_dir)
    rgb = _blinn_phong(n, view, ldir, specular, shininess, color)
    bgc = torch.tensor(bg, dtype=torch.float32, device=dev)
    rgb = torch.where(hit[..., None], torch.clamp(rgb, 0.0, 1.0), bgc)
    return rgb, torch.where(hit, t_hit, float("inf"))


def _blinn_phong(n: torch.Tensor, view: np.ndarray, ldir: np.ndarray,
                 specular, shininess, color) -> torch.Tensor:
    """Unclamped Blinn-Phong shade of unit normals ``n`` (..., 3) under
    the unit light ``ldir``, seen along ``view``."""
    dev = n.device
    half = torch.from_numpy(_unit(ldir - view)).to(dev)
    lam = torch.clamp(torch.sum(n * torch.from_numpy(ldir).to(dev), dim=-1),
                      0.0, 1.0)
    spec = torch.clamp(torch.sum(n * half, dim=-1), 0.0, 1.0) ** shininess
    col = torch.tensor(color, dtype=torch.float32, device=dev)
    return (0.15 + 0.85 * lam)[..., None] * col \
        + (specular * spec)[..., None]


def render_volume_sharded(*args, **kwargs):
    """Film-sharded :func:`render_volume`: not ported yet."""
    raise NotImplementedError(
        "render_volume_sharded: film-sharded rendering over a device mesh "
        "is not ported yet (ROADMAP queue item 10)")


def render_isosurface_sharded(*args, **kwargs):
    """Film-sharded :func:`render_isosurface`: not ported yet."""
    raise NotImplementedError(
        "render_isosurface_sharded: film-sharded rendering over a device "
        "mesh is not ported yet (ROADMAP queue item 10)")


# -- shear-warp ---------------------------------------------------------------

def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values rounded once, as XLA contracts a
    product and the sum it feeds on the CPU (the product is exact in
    float64)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _lerp_taps(n_in: int, n_out: int, scale, shifts: torch.Tensor):
    """The two taps of a family of 1D linear resamples: output ``u`` of
    row ``b`` samples ``in[scale * u + shifts[b]]``, 0 outside ``[0,
    n_in - 1]``. Returns ``(i0, i1, w0, w1)``, each (B, n_out)."""
    u = torch.arange(n_out, dtype=torch.float32, device=shifts.device)
    src = _fma(u[None, :], float(scale), shifts[:, None])
    i0 = torch.floor(src)
    f = src - i0
    valid = (src >= 0.0) & (src <= n_in - 1)
    return (torch.clamp(i0, 0, n_in - 1).to(torch.int64),
            torch.clamp(i0 + 1, 0, n_in - 1).to(torch.int64),
            torch.where(valid, 1.0 - f, 0.0), torch.where(valid, f, 0.0))


def _resample(t: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """Resample ``t`` along ``dim`` by two taps a row: ``w0 * t[i0] +
    w1 * t[i1]``, the taps' rows running along dimension 0 of ``t`` (or
    one row for all of it) and their outputs along ``dim``."""
    i0, i1, w0, w1 = taps
    shape = [1] * t.dim()
    shape[0], shape[dim] = i0.shape
    out_shape = list(t.shape)
    out_shape[dim] = i0.shape[1]
    terms = []
    for idx, wt in ((i0, w0), (i1, w1)):
        vals = torch.gather(t, dim, idx.reshape(shape).expand(out_shape))
        terms.append(wt.reshape(shape) * vals)
    return terms[0] + terms[1]


def _camera_basis_np(azim_deg: float, elev_deg: float):
    """float64 numpy camera basis for the host's static choices."""
    az, el = np.deg2rad(azim_deg), np.deg2rad(elev_deg)
    view = -np.asarray([np.sin(el), np.cos(el) * np.sin(az),
                        np.cos(el) * np.cos(az)])
    right = np.cross(view, [1.0, 0.0, 0.0])
    nrm = np.linalg.norm(right)
    right = (right / nrm if nrm > 1e-5
             else np.asarray([0.0, 0.0, 1.0]))
    return view, right, np.cross(right, view)


def _principal_setup(shape, azim_deg: float, elev_deg: float):
    """The principal axis (the largest ``|view|`` component, so every
    shear slope is at most 1) leads the permutation; ``flip`` reverses it
    when the view runs toward lower indices."""
    view = _camera_basis_np(float(azim_deg), float(elev_deg))[0]
    p = int(np.argmax(np.abs(view)))
    perm = (p,) + tuple(i for i in range(3) if i != p)
    return perm, bool(view[p] < 0)


def _film_variant_np(shape, perm, flip, azim_deg: float,
                     elev_deg: float) -> bool:
    """Whether to warp onto the transposed film: when a film column moves
    the intermediate image's x under half as much as a film row does
    (an in-plane rotation near 90 degrees, the two-pass warp's
    bottleneck). Probed in world units on the host."""
    view, right, up = _camera_basis_np(azim_deg, elev_deg)
    extent = np.asarray(shape, np.float64)
    center = (extent - 1) / 2.0
    radius = np.linalg.norm(extent) / 2.0

    def probe(r, c):
        o = center - view * radius - up * r + right * c
        op = np.asarray([o[perm[0]], o[perm[1]], o[perm[2]]])
        vp = np.asarray([view[perm[0]], view[perm[1]], view[perm[2]]])
        if flip:
            op[0] = shape[perm[0]] - 1 - op[0]
            vp[0] = -vp[0]
        t0 = -op[0] / vp[0]
        return np.asarray([op[1] + vp[1] * t0, op[2] + vp[2] * t0])

    p00 = probe(0.0, 0.0)
    dxdr = (probe(1.0, 0.0) - p00)[1]
    dxdc = (probe(0.0, 1.0) - p00)[1]
    return bool(abs(dxdc) < 0.5 * abs(dxdr))


def _view_permuted(view: np.ndarray, perm, flip: bool):
    """The view direction in the permuted (and flipped) volume's axes and
    the shear slopes ``d1``, ``d2`` of its two minor axes."""
    vp = np.array([view[perm[0]], view[perm[1]], view[perm[2]]], _F32)
    if flip:
        vp = vp * np.array([-1, 1, 1], _F32)
    return vp, _F32(vp[1] / vp[0]), _F32(vp[2] / vp[0])


def _film_affine(shape, perm, flip, azim_deg, elev_deg, out_hw, zoom):
    """Affine ``(g (3, 2), p00 (3,))``: film ``(r, c)`` to the intermediate
    image's ``(Y', X')`` (where the ray crosses slice 0 of the permuted
    volume, plus the shear's pad) and the ray parameter there, ``t0``;
    recovered exactly from three probes, in float32 on the host."""
    h, w = out_hw
    extent = np.asarray(shape, _F32)
    center = (extent - 1) / _F32(2)
    radius = _radius(shape)
    view, right, up = camera_basis(azim_deg, elev_deg, fused=True)
    span = _F32(_F32(2) * radius / _F32(zoom))
    n0 = shape[perm[0]]
    vp = _view_permuted(view, perm, flip)[0]

    def probe(r, c):
        ys = _F32(_F32(r / max(h - 1, 1) - 0.5) * span)
        xs = _F32(_F32(c / max(w - 1, 1) - 0.5) * span)
        o = _fma32(right, xs, _fma32(-up, ys, _fma32(-view, radius,
                                                      center)))
        op = np.array([o[perm[0]], o[perm[1]], o[perm[2]]], _F32)
        if flip:
            op[0] = _F32(shape[perm[0]] - 1) - op[0]
        t0 = _F32(-op[0] / vp[0])
        pad = _F32(n0 / 2.0)
        return np.array([_fma32(vp[1], t0, op[1]) + pad,
                         _fma32(vp[2], t0, op[2]) + pad, t0], _F32)

    p00 = probe(0.0, 0.0)
    g = np.stack([probe(1.0, 0.0) - p00, probe(0.0, 1.0) - p00], axis=1)
    return g.astype(_F32), p00


def _film_warp(img: torch.Tensor, g: np.ndarray, h0: np.ndarray, out_hw,
               transpose_film: bool) -> torch.Tensor:
    """Catmull-Smith two-pass affine warp ``T(r, c) = I(Y'(r, c),
    X'(r, c))`` of the (n_y, n_x, K) intermediate image: pass 1 resamples
    each intermediate column onto film rows, pass 2 each film row onto
    film columns; ``transpose_film`` warps onto the transposed film."""
    hh, ww = out_hw
    if transpose_film:
        hh, ww = ww, hh
        g = g[:, ::-1]
    g11, g12, g21, g22 = g[0, 0], g[0, 1], g[1, 0], g[1, 1]
    h1, h2 = h0[0], h0[1]
    n_y, n_x = img.shape[:2]
    dev = img.device
    a = _F32(g11 - _F32(g12 * g21) / g22)
    b = _F32(g12 / g22)
    const = _F32(h1 - _F32(g12 * h2) / g22)
    xs = torch.arange(n_x, dtype=torch.float32, device=dev)
    taps1 = _lerp_taps(n_y, hh, a, _fma(xs, float(b), float(const)))
    tmp = _resample(img.transpose(0, 1), 1, taps1).transpose(0, 1)
    rs = torch.arange(hh, dtype=torch.float32, device=dev)
    taps2 = _lerp_taps(n_x, ww, g22, _fma(rs, float(g21), float(h2)))
    out = _resample(tmp, 1, taps2)
    return out.transpose(0, 1) if transpose_film else out


class _ShearSetup:
    """A shear-warp pose: the principal permutation and flip, the shear
    slopes, the film affine, and the volume's slices along the principal
    axis sheared on demand."""

    def __init__(self, vol: torch.Tensor, azim_deg: float, elev_deg: float,
                 out_hw, zoom):
        shape = tuple(vol.shape)
        self.perm, self.flip = _principal_setup(shape, azim_deg, elev_deg)
        self.transpose_film = _film_variant_np(
            shape, self.perm, self.flip, float(azim_deg), float(elev_deg))
        self.view = camera_basis(azim_deg, elev_deg, fused=True)[0]
        self.vp, self.d1, self.d2 = _view_permuted(self.view, self.perm,
                                                   self.flip)
        self.g, self.h0 = _film_affine(shape, self.perm, self.flip,
                                       azim_deg, elev_deg, out_hw, zoom)
        self.vol = vol
        self.n0, self.n1, self.n2 = (shape[p] for p in self.perm)
        self.inter_hw = (self.n1 + self.n0, self.n2 + self.n0)
        self.slab = max(1, SLAB_VOXELS // (self.inter_hw[0]
                                           * self.inter_hw[1]))

    def sheared(self, zs: torch.Tensor) -> torch.Tensor:
        """Slices ``zs`` of the permuted, flipped volume sheared so rays
        run along axis 0: slice z moves by ``(d1, d2) * z - N0 / 2``,
        (len(zs), N1 + N0, N2 + N0)."""
        src = (self.n0 - 1 - zs) if self.flip else zs
        slices = torch.index_select(self.vol, self.perm[0], src)
        slices = slices.permute(self.perm).contiguous()
        z = zs.to(torch.float32)
        off = self.n0 / 2.0
        taps1 = _lerp_taps(self.n1, self.inter_hw[0], 1.0,
                           _fma(z, float(self.d1), -off))
        sh = _resample(slices, 1, taps1)
        taps2 = _lerp_taps(self.n2, self.inter_hw[1], 1.0,
                           _fma(z, float(self.d2), -off))
        return _resample(sh, 2, taps2)

    def slabs(self):
        """``(z0, z1)`` of each slab along the principal axis."""
        for z0 in range(0, self.n0, self.slab):
            yield z0, min(self.n0, z0 + self.slab)

    def zs(self, z0: int, z1: int) -> torch.Tensor:
        return torch.arange(z0, z1, device=self.vol.device)

    def length(self) -> np.float32:
        """Voxels one slice step crosses along the ray."""
        return _F32(np.sqrt(_F32(1) + self.d1 ** 2 + self.d2 ** 2))

    def warp(self, inter: torch.Tensor, out_hw) -> torch.Tensor:
        return _film_warp(inter, self.g[:2], self.h0, out_hw,
                          self.transpose_film)


def _tf_emission(sn: torch.Tensor, w: torch.Tensor,
                 color: torch.Tensor) -> torch.Tensor:
    """Emission summed along axis 0 (per anchor with a (K, 3) ``color``):
    ``(N1p, N2p)`` weights, or ``(K, N1p, N2p)`` for K anchors of a
    piecewise-linear colormap, ``sum_z w hat_k(sn)``."""
    if color.dim() == 1:
        return torch.sum(w, dim=0)
    k = color.shape[0]
    return torch.stack([
        torch.sum(w * torch.clamp(1.0 - torch.abs(sn * (k - 1) - j),
                                  0.0, 1.0), dim=0)
        for j in range(k)])


def _emission_rgb(sums: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """RGB of :func:`_tf_emission`'s sums: ``sum[..., None] * color``, or
    the anchors' sums times their colours added in anchor order."""
    if color.dim() == 1:
        return sums[..., None] * color
    out = 0.0
    for j in range(color.shape[0]):
        out = out + sums[j][..., None] * color[j]
    return out


def render_volume_sw(
        vol, azim_deg: float, elev_deg: float, vmin=0.0, vmax=1.0,
        out_hw: Tuple[int, int] = (512, 512), zoom=1.0, opacity=0.05,
        gamma=1.0, color=(1.0, 1.0, 1.0), bg=(0.0, 0.0, 0.0),
        mode: str = "composite", device="cuda") -> torch.Tensor:
    """Shear-warp direct volume rendering.

    The semantics of :func:`render_volume` (emission-absorption, the
    window/gamma transfer function, the orthographic orbit camera) with
    one bilinear sample a slice, each slice's opacity corrected for the
    path length it spans. ``mode="mip"`` takes the maximum along the
    sheared axis instead (an arbitrary-angle maximum intensity
    projection). ``color`` is a flat (3,) emission colour or a (K, 3)
    stack of colormap anchors, a piecewise-linear transfer function
    evaluated exactly by K weighted sums. Returns (H, W, 3) in [0, 1].
    """
    dev = device_mod.resolve(device)
    vol = _volume(vol, dev)
    setup = _ShearSetup(vol, azim_deg, elev_deg, out_hw, zoom)
    vmin = float(_F32(vmin))
    span = float(max(_F32(vmax) - _F32(vmin), _F32(1e-6)))
    color = torch.as_tensor(np.asarray(color, _F32), device=dev)
    if mode == "mip":
        peak = None
        for z0, z1 in setup.slabs():
            m = torch.amax(setup.sheared(setup.zs(z0, z1)), dim=0)
            peak = m if peak is None else torch.maximum(peak, m)
        lum = torch.clamp((peak - vmin) / span, 0.0, 1.0) ** gamma
        trans = 1.0 - lum
        sums = _tf_emission(lum[None], lum[None], color)
    else:
        length = float(setup.length())
        trans, sums = None, None
        for z0, z1 in setup.slabs():
            sn = torch.clamp((setup.sheared(setup.zs(z0, z1)) - vmin)
                             / span, 0.0, 1.0) ** gamma
            a = sn * opacity
            a = 1.0 - (1.0 - torch.clamp(a, 0.0, 0.999)) ** length
            carry = (torch.ones_like(a[:1]) if trans is None
                     else trans[None])
            tr = torch.cumprod(torch.cat([carry, 1.0 - a]), dim=0)
            part = _tf_emission(sn, tr[:-1] * a, color)
            sums = part if sums is None else sums + part
            trans = tr[-1]
    inter = torch.cat([_emission_rgb(sums, color), trans[..., None],
                       torch.ones_like(trans)[..., None]], dim=-1)
    warped = setup.warp(inter, out_hw)
    cov = torch.clamp(warped[..., 4:5], 0.0, 1.0)
    t_eff = torch.clamp(warped[..., 3:4] + (1.0 - cov), 0.0, 1.0)
    bgc = torch.tensor(bg, dtype=torch.float32, device=dev)
    return torch.clamp(warped[..., :3] + t_eff * bgc, 0.0, 1.0)


def render_isosurface_sw(
        vol, level, azim_deg: float, elev_deg: float,
        out_hw: Tuple[int, int] = (512, 512), zoom=1.0,
        color=(0.8, 0.8, 0.85), bg=(0.0, 0.0, 0.0),
        light_dir: Optional[Sequence[float]] = None, specular=0.4,
        shininess=24.0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Shear-warp shaded isosurface: :func:`render_isosurface`'s semantics
    (first crossing refined linearly between slices, Blinn-Phong,
    ``(rgb, depth)``) with the normal's central differences taken in
    sheared space and un-sheared algebraically.

    As in the reference, the differences wrap around the sheared volume's
    ends (a crossing at slice 0 or N0-1 reads the other end), so each slab
    is sheared with a slice of halo on either side, the wrapped one at the
    ends.
    """
    dev = device_mod.resolve(device)
    vol = _volume(vol, dev)
    setup = _ShearSetup(vol, azim_deg, elev_deg, out_hw, zoom)
    lvl = float(_F32(level))
    n0 = setup.n0
    n1p, n2p = setup.inter_hw
    rows = torch.arange(n1p, device=dev)[:, None]
    cols = torch.arange(n2p, device=dev)[None, :]
    hit = torch.zeros((n1p, n2p), dtype=torch.bool, device=dev)
    z_idx = torch.zeros((n1p, n2p), dtype=torch.int64, device=dev)
    # per column at its crossing: the sample, the one before, and the
    # sheared-space central differences along z, y', x'
    found = torch.zeros((5, n1p, n2p), dtype=torch.float32, device=dev)
    for z0, z1 in setup.slabs():
        zs = torch.arange(z0 - 1, z1 + 1, device=dev) % n0
        halo = setup.sheared(zs)
        core = halo[1:-1]
        above = core >= lvl
        new = ~hit & above.any(dim=0)
        local = torch.argmax(above.to(torch.uint8), dim=0)
        flat = core.reshape(-1)

        def at(u, v):
            return flat.take((local * n1p + u) * n2p + v)

        def halo_at(k):
            return torch.gather(halo, 0, (local + k)[None])[0]

        s_hit = halo_at(1)
        z_new = local + z0
        s_prev = torch.where(z_new == 0, s_hit, halo_at(0))
        vals = torch.stack([
            s_hit, s_prev, (halo_at(2) - halo_at(0)) / 2.0,
            (at((rows + 1) % n1p, cols) - at((rows - 1) % n1p, cols)) / 2.0,
            (at(rows, (cols + 1) % n2p) - at(rows, (cols - 1) % n2p)) / 2.0])
        found = torch.where(new[None], vals, found)
        z_idx = torch.where(new, z_new, z_idx)
        hit = hit | new
    s_hit, s_prev, gz_s, gy_s, gx_s = found
    frac = torch.where(torch.abs(s_hit - s_prev) > 1e-9,
                       (lvl - s_prev) / (s_hit - s_prev), 1.0)
    z_ref = torch.clamp_min(z_idx.to(torch.float32) - 1.0 + frac, 0.0)
    gz = gz_s + float(setup.d1) * gy_s + float(setup.d2) * gx_s
    if setup.flip:
        gz = -gz
    grad = [None, None, None]
    for i, g in zip(setup.perm, (gz, gy_s, gx_s)):
        grad[i] = g
    n = torch.stack(grad, dim=-1)
    n = n / torch.clamp_min(
        torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-6)
    view = setup.view
    n = n * -torch.sign(torch.sum(
        n * torch.from_numpy(view).to(dev), dim=-1, keepdim=True))
    ld = (np.zeros(3, _F32) if light_dir is None
          else np.asarray(light_dir, _F32))
    ldir = _unit(ld if np.any(np.abs(ld) > 0) else -view)
    shade = _blinn_phong(n, view, ldir, specular, shininess, color)
    hitf = hit.to(torch.float32)
    shade = torch.clamp(shade, 0.0, 1.0) * hitf[..., None]
    packed = torch.cat([shade, hitf[..., None], (z_ref * hitf)[..., None]],
                       dim=-1)
    warped = setup.warp(packed, out_hw)
    hitw = warped[..., 3]
    hit_film = hitw > 0.5
    norm = torch.clamp_min(hitw, 1e-6)
    bgc = torch.tensor(bg, dtype=torch.float32, device=dev)
    rgb = torch.where(hit_film[..., None],
                      torch.clamp(warped[..., :3] / norm[..., None], 0.0,
                                  1.0), bgc)
    hh, ww = out_hw
    g, h0 = setup.g, setup.h0
    rs = torch.arange(hh, dtype=torch.float32, device=dev)[:, None]
    cs = torch.arange(ww, dtype=torch.float32, device=dev)[None, :]
    t0 = float(h0[2]) + float(g[2, 0]) * rs + float(g[2, 1]) * cs
    depth = torch.where(hit_film,
                        t0 + warped[..., 4] / norm * float(setup.length()),
                        float("inf"))
    return rgb, depth


def render_channels_sw(
        vol_c, azim_deg: float, elev_deg: float,
        colors: Optional[Sequence[Sequence[float]]] = None, vmin=0.0,
        vmax=1.0, out_hw: Tuple[int, int] = (512, 512), zoom=1.0,
        opacity=0.05, gamma=1.0, bg=(0.0, 0.0, 0.0),
        mode: str = "composite", device="cuda") -> torch.Tensor:
    """Multichannel overlay: each channel of a (Z, Y, X, C) volume (or a
    single (Z, Y, X) channel) through :func:`render_volume_sw` in its own
    colour (cyan, magenta, yellow, grey by default) on black, added, then
    the background behind what stays dark. ``vmin``, ``vmax``,
    ``opacity`` and ``gamma`` may be one value or one a channel."""
    dev = device_mod.resolve(device)
    if vol_c.ndim == 3:
        vol_c = vol_c[..., None]
    n_c = vol_c.shape[-1]
    if colors is None:
        defaults = [(0.0, 1.0, 1.0), (1.0, 0.0, 1.0), (1.0, 1.0, 0.0),
                    (0.9, 0.9, 0.9)]
        colors = [defaults[i % len(defaults)] for i in range(n_c)]

    def per_chan(v, i):
        return v[i] if np.ndim(v) and np.size(v) > 1 else v

    acc = None
    for c in range(n_c):
        img = render_volume_sw(
            vol_c[..., c], azim_deg, elev_deg, vmin=per_chan(vmin, c),
            vmax=per_chan(vmax, c), out_hw=out_hw, zoom=zoom,
            opacity=per_chan(opacity, c), gamma=per_chan(gamma, c),
            color=colors[c], bg=(0.0, 0.0, 0.0), mode=mode, device=dev)
        acc = img if acc is None else acc + img
    bgc = torch.tensor(bg, dtype=torch.float32, device=dev)
    lum = torch.amax(acc, dim=-1, keepdim=True)
    return torch.clamp(acc + torch.clamp(1.0 - lum, 0.0, 1.0) * bgc,
                       0.0, 1.0)


def render_blobs_overlay(
        depth, blobs: np.ndarray, shape, azim_deg, elev_deg,
        out_hw: Tuple[int, int] = (512, 512), zoom: float = 1.0
) -> np.ndarray:
    """Project blob centres into the rendered view (``mlab.points3d``),
    on the host: ``(N, 4)`` rows of ``(row, col, visible, t)``, where
    ``visible`` is 0 for a blob behind the rendered surface (the depth
    buffer's test, 2 voxels of slack) and ``t`` its distance along the
    view ray from the film plane."""
    h, w = out_hw
    extent = np.asarray(shape, np.float32)
    center = (extent - 1) / 2.0
    radius = float(np.linalg.norm(extent)) / 2.0
    view, right, up = camera_basis(float(azim_deg), float(elev_deg))
    span = 2.0 * radius / zoom
    rel = np.asarray(blobs, np.float32)[:, :3] - center
    xs = rel @ right
    ys = rel @ up
    t = rel @ view + radius
    rows = np.clip(((-ys / span) + 0.5) * (h - 1), 0, h - 1)
    cols = np.clip(((xs / span) + 0.5) * (w - 1), 0, w - 1)
    d = (depth.cpu().numpy() if isinstance(depth, torch.Tensor)
         else np.asarray(depth))
    surf = d[rows.astype(int), cols.astype(int)]
    visible = (t <= surf + 2.0) | ~np.isfinite(surf)
    return np.column_stack([rows, cols, visible.astype(np.float32), t])
