"""Halo exchange and sharded whole-volume blob detection.

Port of ``magellanmapper_tpu/parallel/halo.py``. Each rank holds a z (and
optionally y) shard of the volume, sends its edge slabs to its
neighbours (``torch.distributed`` point-to-point on the axis's group,
:func:`comm.exchange`), detects on interior plus halo and keeps only
interior blobs: an exact partition with no cross-rank duplicates and no
pruning pass.

Per rank, the step preprocesses its interior (saturate and per-tile
denoise, :func:`cv.stack_detect.preprocess_block`, whose tile
percentiles are kernel K4 on the card), exchanges halos of the
preprocessed planes, runs the LoG pyramid and ``find_peaks(fused=None)``
(K1 on the card), masks peaks outside the true extent, prunes overlaps
(K3), keeps the interior, shifts to global coordinates and gathers every
rank's fixed-capacity buffer, so that every rank returns every blob.
The halo is sized from the largest LoG support, so interior detections
match a single-shot run; shard extents are denoise-tile multiples, so
per-shard preprocessing matches too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.cv import detector, stack_detect
from magellanmapper_torch.ops import filters, peaks
from magellanmapper_torch.parallel import comm, mesh as mesh_mod

def log_support(max_sigma: float) -> int:
    """Halo width (planes) for exact cross-shard LoG detection parity.

    The separable Gaussian kernels truncate at radius ``int(4*sigma+0.5)``
    (scipy ``gaussian_filter`` truncate=4), and the 3^3 peak test reads
    one more plane, so interior peaks within this margin of a shard edge
    see exactly the data a single-device run would.
    """
    return int(4 * float(max_sigma) + 0.5) + 1


def halo_exchange(
        local: torch.Tensor, halo: int, axis: int = 0,
        axis_name: str = "sp", mesh=None) -> torch.Tensor:
    """Extend a shard with ``halo`` planes from each neighbour along
    ``axis_name`` of ``mesh``.

    Boundary shards extend with the scipy-``reflect`` image of their own
    edge planes (d c b a | a b c d), the boundary mode of the detector's
    Gaussian kernels, so interior LoG responses match a single-device
    run even within filter reach of the volume edge. ``halo`` must not
    exceed the shard extent along ``axis`` (slabs come from immediate
    neighbours only)."""
    if mesh is None:
        raise ValueError("halo_exchange needs the rank mesh")
    n = mesh_mod.axis_size(mesh, axis_name)
    idx = mesh_mod.axis_index(mesh, axis_name)
    size = local.shape[axis]
    lo_slab = local.narrow(axis, 0, halo)
    hi_slab = local.narrow(axis, size - halo, halo)
    from_down = torch.flip(lo_slab, (axis,)) if idx == 0 \
        else torch.empty_like(hi_slab)
    from_up = torch.flip(hi_slab, (axis,)) if idx == n - 1 \
        else torch.empty_like(lo_slab)
    sends, recvs = [], []
    if idx > 0:
        sends.append((lo_slab, idx - 1))
        recvs.append((from_down, idx - 1))
    if idx < n - 1:
        sends.append((hi_slab, idx + 1))
        recvs.append((from_up, idx + 1))
    if sends:
        comm.exchange(sends, recvs, mesh.get_group(axis_name))
    return torch.cat([from_down, local, from_up], dim=axis)


def halo_exchange_z(
        local: torch.Tensor, halo: int, axis_name: str = "sp",
        mesh=None) -> torch.Tensor:
    """Extend a z-shard with ``halo`` planes from each z neighbour."""
    return halo_exchange(local, halo, axis=0, axis_name=axis_name,
                         mesh=mesh)


def make_sharded_detector(
        mesh, shard_shape: Tuple[int, int, int], halo: int,
        sigmas: Tuple[float, ...], threshold: float, overlap: float,
        capacity: int,
        denoise_shape: Optional[Tuple[int, ...]] = None,
        preproc_items: Optional[Tuple[Tuple[str, float], ...]] = None,
        halo_y: Optional[int] = None,
        true_extent: Optional[Tuple[int, int]] = None,
        device="cuda"):
    """Build the sharded whole-volume detection step of this rank.

    The returned ``step(volume, max_thresh=None) -> (blobs, valid)`` takes
    the ``(dp, Z, Y, X)`` global batch (host arrays, alike on every rank),
    detects this rank's shard (batch row by ``dp``, z by ``sp``, y by
    ``spy``) on ``device`` and returns, on every rank, ``blobs`` ``(dp,
    sp*spy*capacity, 4)`` float32 rows ``z,y,x,sigma`` in global
    coordinates and ``valid`` ``(dp, sp*spy*capacity)``, as host tensors.
    ``max_thresh`` is an optional per-row array overriding the profile's
    saturation bound (per-channel near-max).
    """
    dev = device_mod.resolve(device)
    sizes = mesh_mod.shape(mesh)
    dp, spy = sizes["dp"], sizes["spy"]
    shard_z, shard_y = shard_shape[0], shard_shape[1]
    if halo_y is None:
        halo_y = halo
    if halo > shard_z:
        raise ValueError(
            f"halo {halo} exceeds z-shard extent {shard_z}")
    if spy > 1 and halo_y > shard_y:
        raise ValueError(
            f"halo_y {halo_y} exceeds y-shard extent {shard_y}")
    static_mt = (dict(preproc_items).get("max_thresh", 0.0)
                 if preproc_items is not None else 0.0)

    def per_shard(local: torch.Tensor, mt: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        vol = local
        if preproc_items is not None:
            items = tuple((k, mt if k == "max_thresh" else v)
                          for k, v in preproc_items)
            vol = stack_detect.preprocess_block(vol, denoise_shape, items)
        idx_z = mesh_mod.axis_index(mesh, "sp")
        extended = halo_exchange(vol.to(torch.float32), halo, axis=0,
                                 axis_name="sp", mesh=mesh)
        off_y = 0
        if spy > 1:
            extended = halo_exchange(extended, halo_y, axis=1,
                                     axis_name="spy", mesh=mesh)
            off_y = mesh_mod.axis_index(mesh, "spy") * shard_y - halo_y
        off_z = idx_z * shard_z - halo
        cube = filters.log_pyramid(extended, sigmas)
        coords4, _, count = peaks.find_peaks(
            cube, threshold, capacity, fused=None)
        del cube
        valid = torch.arange(capacity, device=dev) < count
        if true_extent is not None:
            # drop peaks in pad/mirror zones BEFORE pruning: a reflected
            # duplicate of a near-edge blob must not prune the real one
            gz = coords4[:, 1].to(torch.int64) + off_z
            gy = coords4[:, 2].to(torch.int64) + off_y
            valid &= (gz >= 0) & (gz < true_extent[0])
            valid &= (gy >= 0) & (gy < true_extent[1])
        sig = filters.sigma_tensor(tuple(sigmas), dev)[coords4[:, 0].long()]
        coords = coords4[:, 1:].to(torch.float32).contiguous()
        valid = peaks.prune_overlapping_blobs(
            coords, sig, valid, overlap, ndim=3)
        raw = torch.cat([coords, sig[:, None]], dim=1)
        interior = (raw[:, 0] >= halo) & (raw[:, 0] < halo + shard_z)
        if spy > 1:
            interior &= (raw[:, 1] >= halo_y) & (raw[:, 1] < halo_y
                                                 + shard_y)
        valid = valid & interior
        shift = torch.tensor(
            [float(-halo) + float(idx_z) * shard_z, float(off_y), 0.0, 0.0],
            device=dev)
        raw = torch.where(valid[:, None], raw + shift, 0.0)
        return raw, valid

    def step(volume, max_thresh=None):
        if max_thresh is None:
            mts = [float(static_mt)] * dp
        else:
            mts = [float(v) for v in np.asarray(
                max_thresh, np.float32).reshape(dp)]
        row = mesh_mod.axis_index(mesh, "dp")
        z0 = mesh_mod.axis_index(mesh, "sp") * shard_z
        y0 = mesh_mod.axis_index(mesh, "spy") * shard_y if spy > 1 else 0
        local = torch.from_numpy(np.ascontiguousarray(
            volume[row, z0:z0 + shard_z, y0:y0 + shard_y])).to(dev)
        raw, valid = per_shard(local, mts[row])
        # every shard's buffer on every rank, dp rows outermost; the
        # validity rides as a fifth column
        rows = comm.all_gather(
            torch.cat([raw, valid[:, None].to(raw.dtype)], dim=1), mesh,
            mesh_mod.AXES).cpu().reshape(dp, -1, 5)
        return rows[..., :4], rows[..., 4] > 0

    return step


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def detect_blobs_sharded_batch(
        volumes: Sequence[np.ndarray],
        settings,
        resolutions: Sequence[float],
        mesh=None,
        preprocess: bool = False,
        near_max: Optional[float] = None,
        device="cuda",
) -> List[Optional[np.ndarray]]:
    """Sharded detection for a batch of same-shape volumes over ``dp``.

    Each dp row holds one volume, z/y sharded over sp/spy within it. The
    halo comes from the largest LoG support (exact interior parity with
    the single-device detector); z/y are padded to shard multiples with
    the Gaussian kernels' reflect boundary (numpy 'symmetric'); with
    ``preprocess``, saturate/denoise runs in the step with each volume's
    own near-max (:func:`cv.stack_detect.sample_near_max` unless
    ``near_max`` gives it). A batch shorter than a multiple of dp is
    filled with the first volume, whose results are dropped. Returns one
    ``N x 10`` blob array (or None) per input volume, the same on every
    rank.
    """
    if mesh is None:
        mesh = mesh_mod.make_mesh(device=device)
    sizes = mesh_mod.shape(mesh)
    dp, sp, spy = sizes["dp"], sizes["sp"], sizes["spy"]
    volumes = [np.asarray(v) for v in volumes]
    z, y, x = volumes[0].shape[:3]

    sigmas = detector.profile_sigmas(settings, resolutions)
    halo = log_support(max(sigmas))

    denoise_shape = None
    prep = None
    max_thresh_list: List[float] = []
    if preprocess:
        denoise_shape = stack_detect.denoise_shape(settings, resolutions)
        if near_max is None:
            near_max_list = [stack_detect.sample_near_max(v)
                             for v in volumes]
        elif np.isscalar(near_max):
            near_max_list = [float(near_max)] * len(volumes)
        else:
            near_max_list = [float(v) for v in near_max]
        preps = [stack_detect.preproc_items(settings, nm)
                 for nm in near_max_list]
        prep = preps[0]
        max_thresh_list = [dict(p)["max_thresh"] for p in preps]

    # shard extents: cover the volume, fit the halo, and stay aligned to
    # the denoise-tile grid so per-shard preprocessing matches single-shot
    shard_z = max(-(-z // sp), halo)
    shard_y = max(-(-y // spy), halo) if spy > 1 else y
    if denoise_shape is not None:
        shard_z = _round_up(shard_z, denoise_shape[0])
        if spy > 1:
            shard_y = _round_up(shard_y, denoise_shape[1])
    pad_z = shard_z * sp - z
    pad_y = shard_y * spy - y

    padded = [np.pad(
        v.astype(np.float32), ((0, pad_z), (0, pad_y), (0, 0)),
        mode="symmetric") for v in volumes]
    n_true = len(padded)
    while len(padded) % dp:
        padded.append(padded[0])      # dp tail fill, dropped on return
        if max_thresh_list:
            max_thresh_list.append(max_thresh_list[0])

    capacity = int(settings["max_blobs_per_block"] or 4096)
    step = make_sharded_detector(
        mesh, (shard_z, shard_y, x), halo, sigmas,
        float(settings["detection_threshold"]),
        float(settings["overlap"]), capacity,
        denoise_shape=denoise_shape, preproc_items=prep,
        true_extent=(z, y), device=device)

    results: List[Optional[np.ndarray]] = []
    for i0 in range(0, len(padded), dp):
        mt = (np.asarray(max_thresh_list[i0:i0 + dp], np.float32)
              if max_thresh_list else None)
        raw, valid = step(np.stack(padded[i0:i0 + dp]), mt)
        raw = raw.numpy()
        valid = valid.numpy()
        for bi in range(dp):
            out = raw[bi][valid[bi]]
            out = out[(out[:, 0] < z) & (out[:, 1] < y)]
            if out.shape[0] == 0:
                results.append(None)
                continue
            results.append(detector.rows_to_blobs(out, 0))
    return results[:n_true]


def detect_blobs_sharded(
        volume: np.ndarray,
        settings,
        resolutions: Sequence[float],
        mesh=None,
        preprocess: bool = False,
        near_max: Optional[float] = None,
        device="cuda",
) -> Optional[np.ndarray]:
    """Whole-volume detection sharded over a rank mesh (single-volume
    front of :func:`detect_blobs_sharded_batch`)."""
    return detect_blobs_sharded_batch(
        [volume], settings, resolutions, mesh=mesh,
        preprocess=preprocess, near_max=near_max, device=device)[0]


#: profile settings that decide whether channels share one detection
_GROUP_KEYS = (
    "min_sigma_factor", "max_sigma_factor", "num_sigma",
    "detection_threshold", "overlap", "max_blobs_per_block",
    "denoise_size", "clip_vmin", "clip_vmax", "max_thresh_factor",
    "clip_min", "clip_max", "tot_var_denoise", "unsharp_strength",
    "erosion_threshold")


def detect_blobs_sharded_stack(
        volume: np.ndarray,
        profiles,
        resolutions: Sequence[float],
        mesh=None,
        channels: Optional[Sequence[int]] = None,
        preprocess: bool = False,
        device="cuda") -> Optional[np.ndarray]:
    """Multichannel sharded whole-volume detection.

    Channels sharing the detection settings form one group and ride the
    mesh's ``dp`` axis together; channel IDs are stamped into the blob
    rows.
    """
    multichannel = volume.ndim > 3
    if channels is None:
        channels = list(range(volume.shape[3])) if multichannel else [0]

    def get_prof(chl):
        if isinstance(profiles, (list, tuple)):
            return profiles[min(chl, len(profiles) - 1)]
        return profiles

    groups: dict = {}
    for chl in channels:
        prof = get_prof(chl)
        key = tuple(repr(prof.get(k)) for k in _GROUP_KEYS)
        groups.setdefault(key, []).append(chl)

    out = []
    for grp in groups.values():
        vols = [np.asarray(volume[..., c] if multichannel else volume)
                for c in grp]
        results = detect_blobs_sharded_batch(
            vols, get_prof(grp[0]), resolutions, mesh=mesh,
            preprocess=preprocess, device=device)
        for chl, blobs in zip(grp, results):
            if blobs is None:
                continue
            blobs_mod.Blobs.set_blob_channel(blobs, chl)
            out.append(blobs)
    return np.vstack(out) if out else None
