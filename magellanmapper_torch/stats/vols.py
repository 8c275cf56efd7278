"""Per-region metrics engine (segment sums on the device), on PyTorch.

Port of ``magellanmapper_tpu/stats/vols.py``. :func:`measure_labels_metrics`
codes every voxel by its label's position among the measured IDs
(``torch.searchsorted``) and sums each label's voxels in one pass a
quantity on the device: voxel counts and the heat map's sums (nuclei and
their squares) in int64 with ``bincount``/``index_add_``, intensity
moments in float64 with ``bincount(weights=...)``. The reference sums all
five as float32 scatter-adds, so its counts round past 2^24 voxels in one
region and its variances cancel in float32; the port keeps counts exact
and moments accurate (recorded deviations, ROADMAP section 3). Per-label
percentiles sort the voxels once on the device by (label, intensity) and
interpolate as numpy's ``percentile`` does; edge sizes and surface faces
are int64 counts on the device, the faces multiplied by their float64
areas in the reference's order.

Label overlap (DSC) and centroid distances count voxels and sum
coordinates exactly in int64 on the device. The rest is host code,
copied: painting a metric into labels, per-level tables, the metric enums
and the facades.
With ``mesh=``, the per-label sums are dealt over the ranks of a mesh
(:func:`_segment_stats_sharded`). Blobs with precomputed cluster IDs (column 4) give the
cluster columns; without them every region's blobs are clustered on the
device in one pass (``clustering.cluster_dbscan`` grouped by region: only
blobs of one region neighbour each other, and each region numbers its
clusters from 0), as the reference's DBSCAN region by region.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence

import numpy as np
import pandas as pd
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import ontology
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.parallel import comm, mesh as mesh_mod
from magellanmapper_torch.stats import clustering
from magellanmapper_torch.utils import libmag

#: metric column names (reference ``vols.LabelMetrics``)
LABEL_METRICS = (
    "Region", "Volume", "VolPx", "Intensity", "Nuclei", "Density",
    "DensityIntens", "VarIntensity", "MeanIntensity", "MedIntensity",
    "LowIntensity", "HighIntensity", "VarNuclei", "MeanNuclei",
    "CoefVarIntens", "CoefVarNuc", "EdgeSize", "EdgeDistSum",
    "EdgeDistMean", "SurfaceArea", "Compactness", "VolDSC", "NucDSC",
    "NucCluster", "NucClusNoise", "NucClusLarg",
)
#: the per-label percentiles: median, low and high quartiles
PERCENTILES = (50, 25, 75)


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array on ``dev``; unsigned integers wider than a byte are
    widened on the host first, since devices index few unsigned types."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.astype(np.int64)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def _dense_code(labels: torch.Tensor, label_ids: torch.Tensor
                ) -> torch.Tensor:
    """Map label values to dense ``[1, n]`` codes by their position in
    ``label_ids``, 0 for background and unlisted labels (int64)."""
    sorted_ids, sorter = torch.sort(label_ids)
    pos = torch.searchsorted(sorted_ids, labels)
    pos = torch.clamp(pos, 0, len(sorted_ids) - 1)
    match = sorted_ids[pos] == labels
    return torch.where(match, sorter[pos] + 1, 0)


def _index_sum(codes: torch.Tensor, values: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Per-code sums of ``values``: int64 for integers, float64 else."""
    if values.is_floating_point():
        return torch.bincount(codes, weights=values.to(torch.float64),
                              minlength=num_segments)
    out = torch.zeros(num_segments, dtype=torch.int64, device=codes.device)
    return out.index_add_(0, codes, values.to(torch.int64))


def _segment_stats(codes: torch.Tensor, intensity: Optional[torch.Tensor],
                   heat: Optional[torch.Tensor], num_segments: int):
    """Per-label sums in one pass each: voxel count (int64), intensity and
    its square (float64), heat and its square (int64 for an integer heat
    map). A missing image sums to zeros."""
    counts = torch.bincount(codes, minlength=num_segments)
    zeros = torch.zeros(num_segments, dtype=torch.int64,
                        device=codes.device)
    if intensity is None:
        s1 = s2 = zeros.to(torch.float64)
    else:
        i64 = intensity.to(torch.float64)
        s1 = _index_sum(codes, i64, num_segments)
        s2 = _index_sum(codes, i64 * i64, num_segments)
    if heat is None:
        h1 = h2 = zeros
    else:
        h = heat if heat.is_floating_point() else heat.to(torch.int64)
        h1 = _index_sum(codes, h, num_segments)
        h2 = _index_sum(codes, h * h, num_segments)
    return counts, s1, s2, h1, h2


def _segment_stats_sharded(codes: torch.Tensor,
                           intensity: Optional[torch.Tensor],
                           heat: Optional[torch.Tensor], num_segments: int,
                           mesh):
    """:func:`_segment_stats` with the voxels dealt over the ranks of
    ``mesh`` (``vols.py:51-88``): each rank sums its contiguous flat
    shard, and one ``all_reduce`` a quantity adds the partials. The voxel
    count is padded to a multiple of the rank count with voxels of code 0
    (background, dropped by the caller) and value 0; counts stay exact,
    and the float64 moments differ from the unsharded sums only in their
    order of summation."""
    n_ranks = mesh_mod.axis_size(mesh, mesh_mod.AXES)
    per = -(-codes.numel() // n_ranks)
    lo = mesh_mod.axis_index(mesh, mesh_mod.AXES) * per

    def shard(x):
        part = x[lo:lo + per]
        return torch.cat([part, part.new_zeros(per - part.numel())])

    parts = _segment_stats(
        shard(codes), None if intensity is None else shard(intensity),
        None if heat is None else shard(heat), num_segments)
    return tuple(comm.all_reduce(p, mesh, mesh_mod.AXES) for p in parts)


def _float_order_key(values: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) ordered as the float32 ``values``."""
    bits = values.to(torch.float32).view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits,
                       bits | 0x80000000)


def _label_percentiles(codes: torch.Tensor, intensity: torch.Tensor,
                       counts: np.ndarray) -> np.ndarray:
    """``(n, 3)`` float64: each label's median, low and high quartile of
    its float32 intensities, as ``np.percentile`` (linear) gives them
    (NaN for an empty label). One sort by (label, intensity) on the
    device; the two neighbours of each rank come to the host, which
    interpolates with numpy's float64 steps."""
    n = len(counts)
    out = np.full((n, len(PERCENTILES)), np.nan)
    sel = codes > 0
    vals = intensity[sel]
    key = codes[sel] * (1 << 32) + _float_order_key(vals)
    sorted_vals = vals[torch.sort(key).indices]
    m = counts.astype(np.int64)
    start = np.concatenate([[0], np.cumsum(m)[:-1]])
    q = np.true_divide(PERCENTILES, 100)
    virtual = (m[:, None] - 1) * q[None, :]
    prev = np.floor(virtual)
    nxt = prev + 1
    above = virtual >= (m[:, None] - 1)
    prev[above] = m[:, None].repeat(len(q), 1)[above] - 1
    nxt[above] = prev[above]
    # numpy takes gamma from the index it clipped to -1 (the last); the
    # two neighbours are then equal and gamma does not matter
    gamma = virtual - np.where(above, -1, prev)
    has = m > 0
    idx = np.stack([prev, nxt])[:, has] + start[has][None, :, None]
    vals = sorted_vals[torch.from_numpy(idx.astype(np.int64)).to(
        sorted_vals.device)].cpu().numpy()
    a, b = vals[0], vals[1]
    t = gamma[has]
    diff_b_a = np.subtract(b, a)
    lerp = np.add(a, diff_b_a * t)
    np.subtract(b, diff_b_a * (1 - t), out=lerp, where=t >= 0.5)
    out[has] = lerp
    return out


def _surface_areas(codes: torch.Tensor, n: int,
                   spacing: Optional[Sequence[float]]) -> np.ndarray:
    """Per-label surface area from label-boundary faces: each axis's
    faces between different codes (the volume padded with background)
    counted per side on the device in int64, times the face's area, and
    summed on the host in the reference's order."""
    ndim = codes.dim()
    if spacing is None:
        spacing = (1.0,) * ndim
    face = [spacing[1] * spacing[2], spacing[0] * spacing[2],
            spacing[0] * spacing[1]]
    areas = np.zeros(n + 1)
    for ax in range(ndim):
        size = codes.shape[ax]
        lo_in = codes.narrow(ax, 0, size - 1)
        hi_in = codes.narrow(ax, 1, size - 1)
        diff = lo_in != hi_in
        first = codes.narrow(ax, 0, 1)
        last = codes.narrow(ax, size - 1, 1)
        # the padded plane before the first is 0: the face is counted on
        # the low side as background (bin 0) and on the high side as the
        # first plane's code wherever that is not background; likewise
        # after the last plane
        lo = torch.cat([lo_in[diff], last[last != 0]])
        hi = torch.cat([hi_in[diff], first[first != 0]])
        for side in (lo, hi):
            cnt = torch.bincount(side, minlength=n + 1).cpu().numpy()
            areas += cnt * face[ax % 3]
    return areas[1:] * (2.0 / 3.0)


def measure_labels_metrics(
        atlas_img: Optional[np.ndarray],
        labels_img: np.ndarray,
        heat_map: Optional[np.ndarray] = None,
        labels_edge: Optional[np.ndarray] = None,
        dist_to_orig: Optional[np.ndarray] = None,
        spacing: Optional[Sequence[float]] = None,
        label_ids: Optional[Sequence[int]] = None,
        combine_sides: bool = True,
        labels_ref: Optional[ontology.LabelsRef] = None,
        level: Optional[int] = None,
        blobs: Optional[np.ndarray] = None,
        cluster_eps: float = 20.0,
        cluster_minpts: int = 5,
        mesh=None,
        device="cuda") -> pd.DataFrame:
    """Measure per-label metrics on ``device`` (reference
    ``vols.measure_labels_metrics``).

    Args:
        atlas_img: intensity image (may be None).
        labels_img: integer labels (negatives = contralateral side).
        heat_map: per-voxel blob counts (``cv_nd.build_heat_map``).
        labels_edge: boolean edge mask of labels.
        dist_to_orig: per-voxel edge distances (for EdgeDist metrics).
        spacing: z,y,x physical voxel size.
        label_ids: labels to measure; defaults to all nonzero IDs.
        combine_sides: treat -id and +id as one region.
        labels_ref: loaded ontology for optional level aggregation.
        level: ontology level to remap labels to before measuring.
        blobs: optional blob array for the per-region cluster columns:
            column 3 = label ID, column 4 = precomputed DBSCAN cluster ID
            (noise = -1). Without column 4 each region's blobs are
            clustered here with DBSCAN (``cluster_eps``/
            ``cluster_minpts``) on ``device``.
        mesh: a rank mesh (``parallel.mesh.make_mesh``) over which the
            per-label sums are dealt (:func:`_segment_stats_sharded`).
        device: where the voxel passes run.

    Returns:
        DataFrame with one row per label, reference column names; counts
        (``VolPx``, ``Nuclei`` of an integer heat map, ``EdgeSize``) are
        exact integers, moments float64.
    """
    dev = device_mod.resolve(device)
    labels_proc = labels_img
    if level is not None and labels_ref is not None:
        labels_proc = ontology.make_labels_level(
            labels_img, labels_ref.ref_lookup, level)
    work = _to_device(labels_proc, dev).to(torch.int64)
    if combine_sides:
        work = torch.abs(work)

    if label_ids is None:
        ids_dev = torch.unique(work)
        ids_dev = ids_dev[ids_dev != 0]
        ids = ids_dev.cpu().numpy().astype(labels_proc.dtype)
    else:
        ids = np.unique(np.abs(label_ids) if combine_sides
                        else np.asarray(label_ids))
        ids_dev = torch.from_numpy(ids.astype(np.int64)).to(dev)
    n = len(ids)
    if n == 0:
        return pd.DataFrame(columns=LABEL_METRICS)

    codes = _dense_code(work.reshape(-1), ids_dev)
    del work
    intensity = None if atlas_img is None else _to_device(
        np.asarray(atlas_img, np.float32).reshape(-1), dev)
    heat = None if heat_map is None else _to_device(
        np.asarray(heat_map).reshape(-1), dev)
    if mesh is not None:
        stats = _segment_stats_sharded(codes, intensity, heat, n + 1, mesh)
    else:
        stats = _segment_stats(codes, intensity, heat, n + 1)
    counts, s1, s2, h1, h2 = (x[1:].cpu().numpy() for x in stats)

    vox_vol = float(np.prod(spacing)) if spacing is not None else 1.0
    vol_px = counts
    volume = vol_px * vox_vol
    denom = np.maximum(counts, 1)
    mean_i = np.divide(s1, denom)
    var_i = np.maximum(s2 / denom - mean_i ** 2, 0)
    std_i = np.sqrt(var_i)
    nuclei = h1
    mean_n = np.divide(h1, denom)
    var_n = np.maximum(h2 / denom - mean_n ** 2, 0)
    std_n = np.sqrt(var_n)
    density = np.divide(nuclei, np.maximum(volume, 1e-12))
    density_i = np.divide(s1, np.maximum(volume, 1e-12))

    # quantile metrics per label
    med = lo_q = hi_q = np.full(n, np.nan)
    if intensity is not None:
        med, lo_q, hi_q = _label_percentiles(codes, intensity, counts).T

    # edge metrics
    edge_size = np.full(n, np.nan)
    edge_sum = np.full(n, np.nan)
    edge_mean = np.full(n, np.nan)
    if labels_edge is not None:
        edge_flat = _to_device(
            np.asarray(labels_edge).reshape(-1).astype(bool), dev)
        e_codes = codes[edge_flat]
        edge_size = torch.bincount(e_codes, minlength=n + 1)[1:].cpu(
        ).numpy().astype(float)
        if dist_to_orig is not None:
            d = _to_device(np.asarray(dist_to_orig).reshape(-1), dev)
            d = torch.abs(d[edge_flat].to(torch.float64))
            edge_sum = torch.bincount(
                e_codes, weights=d, minlength=n + 1)[1:].cpu().numpy()
            edge_mean = np.divide(edge_sum, np.maximum(edge_size, 1))

    # shape metrics by per-label face counting
    sa = _surface_areas(codes.reshape(labels_img.shape), n, spacing)
    compactness = np.divide(sa ** 1.5, np.maximum(volume, 1e-12))

    # per-region point-cloud cluster metrics, from precomputed IDs or
    # DBSCAN within each measured region
    nuc_cluster = np.full(n, np.nan)
    nuc_noise = np.full(n, np.nan)
    nuc_larg = np.full(n, np.nan)
    if blobs is not None and len(blobs) > 0:
        b = np.asarray(blobs)
        blob_lbl = b[:, 3].astype(int)
        if combine_sides:
            blob_lbl = np.abs(blob_lbl)
        if b.shape[1] > 4:
            clus = b[:, 4].astype(int)
        else:
            clus = np.full(len(b), -1, dtype=int)
            m = np.isin(blob_lbl, ids)
            if m.any():
                clus[m] = clustering.cluster_dbscan(
                    b[m, :3], cluster_eps, cluster_minpts, device=dev,
                    groups=blob_lbl[m])
        for i, lid in enumerate(ids):
            m = blob_lbl == lid
            if not m.any():
                continue
            ncl, nns, nlg = clustering.cluster_dbscan_metrics(clus[m])
            nuc_cluster[i] = ncl
            nuc_noise[i] = nns
            nuc_larg[i] = nlg

    df = pd.DataFrame({
        "Region": ids,
        "Volume": volume,
        "VolPx": vol_px,
        "Intensity": s1,
        "Nuclei": nuclei,
        "Density": density,
        "DensityIntens": density_i,
        "VarIntensity": std_i,
        "MeanIntensity": mean_i,
        "MedIntensity": med,
        "LowIntensity": lo_q,
        "HighIntensity": hi_q,
        "VarNuclei": std_n,
        "MeanNuclei": mean_n,
        "CoefVarIntens": np.divide(std_i, np.maximum(mean_i, 1e-12)),
        "CoefVarNuc": np.divide(std_n, np.maximum(mean_n, 1e-12)),
        "EdgeSize": edge_size,
        "EdgeDistSum": edge_sum,
        "EdgeDistMean": edge_mean,
        "SurfaceArea": sa,
        "Compactness": compactness,
        "NucCluster": nuc_cluster,
        "NucClusNoise": nuc_noise,
        "NucClusLarg": nuc_larg,
    })
    if labels_ref is not None and labels_ref.ref_lookup is not None:
        df["RegionName"] = [
            ontology.get_label_name(labels_ref.ref_lookup.get(int(i)))
            for i in ids]
    return df


def _union_ids(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sorted nonzero label IDs of either image."""
    ids = torch.unique(torch.cat([torch.unique(a), torch.unique(b)]))
    return ids[ids != 0]


def measure_label_overlap(
        labels_img1: np.ndarray, labels_img2: np.ndarray,
        heat_map: Optional[np.ndarray] = None,
        combine_sides: bool = True, device="cuda") -> pd.DataFrame:
    """Per-label DSC between two label images (reference
    ``vols.measure_label_overlap``), the voxel counts of each label and
    of their intersection as int64 ``bincount``s on ``device``; the heat
    map's nuclei (``NucDSC``) summed on the host in numpy's order."""
    dev = device_mod.resolve(device)
    dtype = np.result_type(labels_img1.dtype, labels_img2.dtype)
    a = _to_device(labels_img1, dev)
    b = _to_device(labels_img2, dev)
    if combine_sides:
        a, b = a.abs(), b.abs()
    ids_t = _union_ids(a, b)
    ids = ids_t.cpu().numpy().astype(dtype)
    if not len(ids):
        return pd.DataFrame([])
    n = len(ids)
    ca, fa = cv_nd.label_codes(a, ids_t)
    cb, fb = cv_nd.label_codes(b, ids_t)
    same = fa & (a.reshape(-1) == b.reshape(-1))
    n1 = torch.bincount(ca[fa], minlength=n).cpu().numpy()
    n2 = torch.bincount(cb[fb], minlength=n).cpu().numpy()
    both = torch.bincount(ca[same], minlength=n).cpu().numpy()
    if heat_map is not None:
        h1s = np.abs(labels_img1) if combine_sides else labels_img1
        h2s = np.abs(labels_img2) if combine_sides else labels_img2
    rows = []
    for i, lid in enumerate(ids):
        inter = both[i]
        denom = n1[i] + n2[i]
        dsc = 2 * inter / denom if denom else np.nan
        row = {"Region": lid, "VolDSC": dsc}
        if heat_map is not None:
            m1 = h1s == lid
            m2 = h2s == lid
            h1 = heat_map[m1].sum()
            h2 = heat_map[m2].sum()
            hinter = heat_map[np.logical_and(m1, m2)].sum()
            row["NucDSC"] = (2 * hinter / (h1 + h2)
                             if (h1 + h2) else np.nan)
        rows.append(row)
    return pd.DataFrame(rows)


def labels_distance(
        labels_img1: np.ndarray, labels_img2: np.ndarray,
        spacing: Optional[Sequence[float]] = None,
        device="cuda") -> pd.DataFrame:
    """Centroid shift of each label between two images (reference
    ``vols.labels_distance``): the labels' coordinate sums are exact
    int64 sums on ``device`` (``cv_nd.label_coord_sums``), so the
    centroids and distances are numpy's."""
    dev = device_mod.resolve(device)
    dtype = np.result_type(labels_img1.dtype, labels_img2.dtype)
    a = _to_device(labels_img1, dev)
    b = _to_device(labels_img2, dev)
    ids_t = _union_ids(a, b)
    ids = ids_t.cpu().numpy().astype(dtype)
    if spacing is None:
        spacing = (1.0,) * labels_img1.ndim
    rows = []
    if len(ids):
        n1, s1 = cv_nd.label_coord_sums(a, ids_t)
        n2, s2 = cv_nd.label_coord_sums(b, ids_t)
    for i, lid in enumerate(ids):
        dist = np.nan
        if n1[i] and n2[i]:
            c1 = s1[i].astype(np.float64) / n1[i]
            c2 = s2[i].astype(np.float64) / n2[i]
            dist = float(np.linalg.norm((c1 - c2) * np.asarray(spacing)))
        rows.append({"Region": lid, "Dist": dist})
    return pd.DataFrame(rows)


def map_meas_to_labels(
        labels_img: np.ndarray, df: pd.DataFrame, meas: str,
        combine_sides: bool = True) -> np.ndarray:
    """Paint a metric value into each label's voxels
    (reference ``vols.map_meas_to_labels``)."""
    out = np.zeros(labels_img.shape, dtype=float)
    work = np.abs(labels_img) if combine_sides else labels_img
    for _, row in df.iterrows():
        out[work == row["Region"]] = row[meas]
    return out


def measure_labels_metrics_levels(
        atlas_img: Optional[np.ndarray],
        labels_img: np.ndarray,
        labels_ref: "ontology.LabelsRef",
        max_level: int,
        **kwargs) -> pd.DataFrame:
    """Per-region metrics at every ontology level up to ``max_level``
    (reference ``vols.measure_labels_metrics_levels``): rows concatenate
    with a ``Level`` column."""
    dfs = []
    for level in range(max_level + 1):
        df = measure_labels_metrics(
            atlas_img, labels_img, labels_ref=labels_ref, level=level,
            **kwargs)
        df.insert(0, "Level", level)
        dfs.append(df)
    return pd.concat(dfs, ignore_index=True)


class LabelMetrics(Enum):
    """Metric column enum (reference ``vols.LabelMetrics``); values
    equal the column names in :data:`LABEL_METRICS`."""
    Region = "Region"
    Volume = "Volume"
    VolPx = "VolPx"
    Intensity = "Intensity"
    Nuclei = "Nuclei"
    Density = "Density"
    DensityIntens = "DensityIntens"
    VarIntensity = "VarIntensity"
    MeanIntensity = "MeanIntensity"
    MedIntensity = "MedIntensity"
    LowIntensity = "LowIntensity"
    HighIntensity = "HighIntensity"
    VarNuclei = "VarNuclei"
    MeanNuclei = "MeanNuclei"
    CoefVarIntens = "CoefVarIntens"
    CoefVarNuc = "CoefVarNuc"
    EdgeSize = "EdgeSize"
    EdgeDistSum = "EdgeDistSum"
    EdgeDistMean = "EdgeDistMean"
    SurfaceArea = "SurfaceArea"
    Compactness = "Compactness"
    VolDSC = "VolDSC"
    NucDSC = "NucDSC"


#: variance metrics weighted by volume (reference ``vols.WT_METRICS``)
VAR_METRICS = (
    LabelMetrics.VarIntensity, LabelMetrics.VarNuclei,
    LabelMetrics.MeanIntensity, LabelMetrics.MeanNuclei,
)
WT_METRICS = (*VAR_METRICS, LabelMetrics.EdgeDistMean)


class MetricCombos(Enum):
    """Aggregated metric combinations (reference ``vols.MetricCombos``);
    each value is ``(name, member_metrics, aggregator)``."""
    HOMOGENEITY = (
        "Homogeneity",
        (LabelMetrics.VarIntensity, LabelMetrics.EdgeDistSum,
         LabelMetrics.VarNuclei),
        lambda x: np.nanmean(x, axis=1))
    COEFVAR_INTENS = (
        "CoefVarIntensity",
        (LabelMetrics.VarIntensity, LabelMetrics.MeanIntensity),
        lambda x: np.divide(x.iloc[:, 0], x.iloc[:, 1]))
    COEFVAR_NUC = (
        "CoefVarNuclei",
        (LabelMetrics.VarNuclei, LabelMetrics.MeanNuclei),
        lambda x: np.divide(x.iloc[:, 0], x.iloc[:, 1]))


def get_single_label(label_id):
    """First element of an ID sequence, or the scalar itself
    (reference ``vols.get_single_label``)."""
    if libmag.is_seq(label_id) and len(label_id) > 0:
        return label_id[0]
    return label_id


def get_metric_weight_col(stat: str):
    """Weighting column for a metric: volume for variance-family stats,
    else None (reference ``vols.get_metric_weight_col``)."""
    if stat in [m.name for m in WT_METRICS]:
        return LabelMetrics.Volume.name
    return None


def measure_labels_overlap(
        labels_imgs, heat_map=None, spacing=None, unit_factor=None,
        combine_sides: bool = True, label_ids=None, grouping=None,
        df=None, device="cuda") -> pd.DataFrame:
    """Per-label DSC comparison of two label image versions on ``device``
    (reference ``vols.measure_labels_overlap``), with grouping
    columns."""
    out = measure_label_overlap(
        labels_imgs[0], labels_imgs[1], heat_map=heat_map,
        combine_sides=combine_sides, device=device)
    if label_ids is not None:
        out = out[out["Region"].isin(np.abs(np.asarray(label_ids)))]
    for key, val in (grouping or {}).items():
        out[key] = val
    return out


class LabelToEdge:
    """Per-label edge extraction (reference ``vols.LabelToEdge``): the
    labels' perimeter by an erosion on ``device``
    (:func:`magellanmapper_torch.cv.cv_nd.perimeter_nd`)."""

    def __init__(self, labels_img: np.ndarray, device="cuda"):
        self.labels_img = labels_img
        self.device = device

    def make_edge_img(self) -> np.ndarray:
        edges = np.zeros_like(self.labels_img)
        fg = cv_nd.perimeter_nd(self.labels_img != 0, device=self.device)
        # label boundaries: voxels whose neighborhood holds >1 label
        interior_borders = cv_nd.perimeter_nd(self.labels_img,
                                              device=self.device)
        mask = fg | interior_borders
        edges[mask] = self.labels_img[mask]
        return edges


class MeasureLabel:
    """Facade over the per-label metric pass (reference
    ``vols.MeasureLabel``); delegates to :func:`measure_labels_metrics`."""

    def __init__(self, atlas_img_np, labels_img_np, heat_map=None,
                 blobs=None, spacing=None, device="cuda"):
        self.atlas_img_np = atlas_img_np
        self.labels_img_np = labels_img_np
        self.heat_map = heat_map
        self.blobs = blobs
        self.spacing = spacing
        self.device = device

    def measure(self, **kwargs) -> pd.DataFrame:
        kwargs.setdefault("blobs", self.blobs)
        kwargs.setdefault("device", self.device)
        return measure_labels_metrics(
            self.atlas_img_np, self.labels_img_np,
            heat_map=self.heat_map, spacing=self.spacing, **kwargs)


class MeasureLabelOverlap:
    """Facade over the label-version DSC comparison (reference
    ``vols.MeasureLabelOverlap``), on ``device``."""

    def __init__(self, labels_imgs, heat_map=None, device="cuda"):
        self.labels_imgs = labels_imgs
        self.heat_map = heat_map
        self.device = device

    def measure(self, **kwargs) -> pd.DataFrame:
        kwargs.setdefault("device", self.device)
        return measure_labels_overlap(
            self.labels_imgs, heat_map=self.heat_map, **kwargs)
