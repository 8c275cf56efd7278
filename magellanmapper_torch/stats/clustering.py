"""Blob clustering: DBSCAN and k-nearest-neighbour distances on the device.

Port of ``magellanmapper_tpu/stats/clustering.py``, which runs
scikit-learn's ``DBSCAN`` and ``NearestNeighbors`` on the host. The port
gives scikit-learn's results exactly, on the card unless ``device="cpu"``
is asked for:

- a neighbour lies at squared distance ``<= eps * eps``, the squares
  summed in float64 as ``dz*dz + dy*dy + dx*dx``, left to right, as
  scikit-learn's kd-tree sums them (never the ``|a|^2 + |b|^2 - 2ab`` of a
  matrix product, which moves points on the boundary);
- a point is core when its neighbours, itself included, number at least
  ``minpts``; clusters are numbered in the order of their smallest core
  index; a border point takes the smallest cluster number among its core
  neighbours; noise is -1.

Neighbours are found through a uniform grid: points sorted by the key of
their cell (cells a little wider than ``eps``), then the 27 cells around
each point searched in chunks of candidate pairs. The core graph's
connected components come from hooking and pointer jumping, with the
convergence flag read every few rounds. :func:`knn_dist` searches grids of
doubling cells until each point's k-th distance lies inside the region
its cells cover; :func:`plot_knns` plots its sorted curves (matplotlib,
imported when called).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from magellanmapper_torch import device as device_mod
from magellanmapper_torch.atlas import ontology

#: candidate pairs one chunk of the neighbour search holds (a query's
#: candidates never split; a query with more forms a chunk alone)
PAIR_CHUNK = 1 << 24
#: query points whose neighbour cells are looked up at once
QUERY_BLOCK = 1 << 20
#: cells are this much wider than the search radius, so that a pair
#: within it never lands two cells apart through rounding
_CELL_MARGIN = 1.0 + 2.0 ** -20
#: rounds of hooking and pointer jumping between reads of the
#: convergence flag
_ROUNDS_PER_CHECK = 4


class _Grid:
    """Points (float64 ``(N, 3)`` on their device) sorted by the key of
    their cell of edge ``cell`` (widened where the key would pass int64),
    within ``groups`` when given (a cell holds one group's points), with a
    layer of empty cells around, so that the cells next to a point's
    never alias another row or group."""

    def __init__(self, pts: torch.Tensor, cell: float,
                 groups: Optional[torch.Tensor] = None):
        lo = pts.min(0).values
        extent = float((pts.max(0).values - lo).max())
        n_groups = 1 if groups is None else int(groups.max()) + 1
        # cells per axis such that n_groups * dims^3 stays below 2^62
        most = int((2.0 ** 62 / n_groups) ** (1 / 3)) - 4
        self.cell = max(cell, extent / max(most, 1))
        pos = (pts - lo) / self.cell
        c = torch.floor(pos).to(torch.int64)
        self.frac = pos - c
        c += 1
        dims = (c.max(0).values + 2).tolist()
        key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        if groups is not None:
            key = key + groups * (dims[0] * dims[1] * dims[2])
        self.key, self.order = torch.sort(key, stable=True)
        self.cells, self.count = torch.unique_consecutive(
            self.key, return_counts=True)
        self.start = torch.cumsum(self.count, 0) - self.count
        self.strides = (dims[1] * dims[2], dims[2], 1)
        self.spanned = extent <= self.cell

    def rank(self) -> torch.Tensor:
        """Sorted position of each point."""
        out = torch.empty_like(self.order)
        out[self.order] = torch.arange(len(self.order), device=out.device)
        return out

    def pairs(self, q: torch.Tensor
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """``(i, j)`` sorted positions: each query ``i`` of ``q`` (sorted
        positions, ascending) against every point ``j`` of the 27 cells
        around its own (itself included), in chunks of about
        :data:`PAIR_CHUNK` pairs, the candidates of a query in one chunk
        and in the order of ``q``."""
        dev = q.device
        steps = (-1, 0, 1)
        offs = torch.tensor([
            dz * self.strides[0] + dy * self.strides[1] + dx
            for dz, dy, dx in itertools.product(steps, steps, steps)],
            device=dev)
        n_off = len(offs)
        for b0 in range(0, len(q), QUERY_BLOCK):
            qb = q[b0:b0 + QUERY_BLOCK]
            want = self.key[qb][:, None] + offs
            at = torch.searchsorted(self.cells, want).clamp_(
                max=len(self.cells) - 1)
            hit = self.cells[at] == want
            cnt = torch.where(hit, self.count[at], 0)
            st = self.start[at]
            per_q = cnt.sum(1)
            ends = torch.cumsum(per_q, 0).cpu().numpy()
            a = 0
            while a < len(qb):
                base = ends[a - 1] if a else 0
                b = max(int(np.searchsorted(ends, base + PAIR_CHUNK,
                                            side="right")), a + 1)
                total = int(ends[b - 1] - base)
                c = cnt[a:b].reshape(-1)
                seg = torch.repeat_interleave(
                    torch.arange(len(c), device=dev), c, output_size=total)
                first = torch.cumsum(c, 0) - c
                j = st[a:b].reshape(-1)[seg] + (
                    torch.arange(total, device=dev) - first[seg])
                yield qb[a:b][seg // n_off], j
                a = b


def _sq_dist(pts: torch.Tensor, i: torch.Tensor,
             j: torch.Tensor) -> torch.Tensor:
    """Squared distances of rows ``i`` and ``j`` of ``pts``, summed left to
    right in float64."""
    d = pts[i] - pts[j]
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def _as_points(coords, dev: torch.device) -> torch.Tensor:
    pts = np.asarray(coords, dtype=np.float64)[:, :3]
    return torch.from_numpy(np.ascontiguousarray(pts)).to(dev)


def _components(n: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Each node's smallest connected node over edges ``(u, v)``, by
    hooking the larger of two parents onto the smaller and pointer
    jumping; the flag of a fixed point is read every
    :data:`_ROUNDS_PER_CHECK` rounds."""
    parent = torch.arange(n, device=u.device)
    if not len(u):
        return parent
    while True:
        for _ in range(_ROUNDS_PER_CHECK):
            pu, pv = parent[u], parent[v]
            parent.scatter_reduce_(0, torch.maximum(pu, pv),
                                   torch.minimum(pu, pv), reduce="amin")
            parent = parent[parent[parent]]
        if bool(((parent[u] == parent[v]).all()
                 & (parent[parent] == parent).all()).cpu()):
            return parent


def _dbscan(pts: torch.Tensor, eps: float, minpts: int,
            groups: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DBSCAN labels (int64 on the points' device) of ``pts``; with
    ``groups`` (dense int64 IDs), only points of one group neighbour each
    other and each group numbers its clusters from 0."""
    n = len(pts)
    dev = pts.device
    eps2 = eps * eps
    grid = _Grid(pts, eps * _CELL_MARGIN, groups)
    spts = pts[grid.order]
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    edges_u, edges_v = [], []
    for i, j in grid.pairs(torch.arange(n, device=dev)):
        near = _sq_dist(spts, i, j) <= eps2
        counts += torch.bincount(i[near], minlength=n)
        near &= i < j
        edges_u.append(grid.order[i[near]])
        edges_v.append(grid.order[j[near]])
    core = torch.empty_like(counts, dtype=torch.bool)
    core[grid.order] = counts >= minpts
    u, v = torch.cat(edges_u), torch.cat(edges_v)
    both = core[u] & core[v]
    parent = _components(n, u[both], v[both])

    # number each group's clusters by their smallest core index
    idx = torch.arange(n, device=dev)
    roots = idx[core & (parent == idx)]
    label_of_root = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if groups is None:
        label_of_root[roots] = torch.arange(len(roots), device=dev)
    else:
        g = groups[roots]
        g_sorted, by_g = torch.sort(g, stable=True)
        first = torch.searchsorted(g_sorted, g_sorted)
        label_of_root[roots[by_g]] = torch.arange(
            len(roots), device=dev) - first
    big = torch.iinfo(torch.int64).max
    labels = torch.where(core, label_of_root[parent], big)

    # a border point takes its core neighbours' smallest cluster number
    one = core[u] ^ core[v]
    cu, bu = torch.where(core[u], u, v)[one], torch.where(core[u], v, u)[one]
    labels.scatter_reduce_(0, bu, labels[cu], reduce="amin")
    return torch.where(labels == big, -1, labels)


def cluster_dbscan(
        coords: np.ndarray, eps: float, minpts: int,
        device: Union[str, torch.device] = "cuda",
        groups: Optional[np.ndarray] = None) -> np.ndarray:
    """DBSCAN cluster labels of the z,y,x ``coords`` (-1 = noise), those of
    scikit-learn's ``DBSCAN(eps, min_samples=minpts)``, computed on
    ``device``. With ``groups`` (one integer a point), points neighbour
    only points of their own group, and each group numbers its clusters
    from 0, as DBSCAN run on each group's points alone."""
    if not eps > 0:
        raise ValueError(f"eps must be positive, got {eps}")
    dev = device_mod.resolve(device)
    if len(coords) == 0:
        return np.zeros(0, dtype=np.int64)
    grp = None
    if groups is not None:
        _, dense = np.unique(np.asarray(groups), return_inverse=True)
        grp = torch.from_numpy(dense.reshape(-1).astype(np.int64)).to(dev)
    return _dbscan(_as_points(coords, dev), float(eps), int(minpts),
                   grp).cpu().numpy()


def _kth_sq_dist(pts: torch.Tensor, k: int) -> torch.Tensor:
    """Squared distance of each point to its ``k``-th nearest point,
    itself counted first: ring-1 searches over grids whose cells double
    until the k-th distance of every point lies inside the region its
    cells surely cover."""
    n = len(pts)
    dev = pts.device
    out = torch.full((n,), float("nan"), dtype=torch.float64, device=dev)
    extent = (pts.max(0).values - pts.min(0).values).clamp(min=0)
    volume = float(torch.prod(extent))
    cell = max(float(extent.max()) * 2.0 ** -20,
               (volume / n) ** (1 / 3) / 2 if volume > 0 else 0.0) or 1.0
    todo = torch.arange(n, device=dev)
    while len(todo):
        grid = _Grid(pts, cell)
        spts = pts[grid.order]
        # a ring of cells covers the edge of one cell past the point's own
        reach = grid.cell * (1 + torch.minimum(
            grid.frac, 1 - grid.frac).min(1).values) / _CELL_MARGIN
        q = torch.sort(grid.rank()[todo]).values
        done = []
        for i, j in grid.pairs(q):
            d2 = _sq_dist(spts, i, j)
            d2, by_d = torch.sort(d2, stable=True)
            i = i[by_d]
            i, by_i = torch.sort(i, stable=True)
            d2 = d2[by_i]
            qs, cnt = torch.unique_consecutive(i, return_counts=True)
            first = torch.cumsum(cnt, 0) - cnt
            kth = d2[(first + k - 1).clamp(max=len(d2) - 1)]
            pt = grid.order[qs]
            ok = (cnt >= k) & (grid.spanned | (
                kth <= reach[pt] * reach[pt]))
            out[pt[ok]] = kth[ok]
            done.append(pt[ok])
        resolved = torch.zeros(n, dtype=torch.bool, device=dev)
        resolved[torch.cat(done)] = True
        todo = todo[~resolved[todo]]
        cell = grid.cell * 2
    return out


def knn_dist(
        blobs: np.ndarray, n: int = 5, return_sorted: bool = True,
        device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Distance of each blob to its ``n``-th nearest blob, itself counted
    (``NearestNeighbors(n_neighbors=n).kneighbors`` on the fitted set),
    computed on ``device``; sorted ascending unless ``return_sorted`` is
    False (the elbow of the sorted curve guides DBSCAN's ``eps``)."""
    dev = device_mod.resolve(device)
    if n > len(blobs):
        raise ValueError(
            f"Expected n_neighbors <= n_samples_fit, but n_neighbors = {n}, "
            f"n_samples_fit = {len(blobs)}")
    # numpy's square root is correctly rounded, as scikit-learn's is
    out = np.sqrt(_kth_sq_dist(_as_points(blobs, dev), n).cpu().numpy())
    return np.sort(out) if return_sorted else out


def plot_knns(blob_sets, knn_n: int = 4, names=None,
              out_path: Optional[str] = None,
              device: Union[str, torch.device] = "cuda"):
    """The sorted ``knn_n``-th nearest-neighbour distance curves of several
    blob sets in one figure, saved to ``out_path`` when given; the elbow
    of each curve guides DBSCAN's ``eps``. Returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    for i, blobs in enumerate(blob_sets):
        dists = knn_dist(np.asarray(blobs)[:, :3], knn_n, device=device)
        ax.plot(np.sort(dists),
                label=None if names is None else names[i])
    ax.set_xlabel("Points")
    ax.set_ylabel(f"{knn_n}-NN distance")
    if names is not None:
        ax.legend()
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return fig


def cluster_by_label(
        blobs: np.ndarray, labels_img: np.ndarray,
        scaling: Sequence[float], eps: float = 20.0,
        minpts: int = 5, device: Union[str, torch.device] = "cuda"
) -> np.ndarray:
    """Cluster blobs separately within each label region of
    ``labels_img`` (blob coordinates times ``scaling`` index it), in one
    pass on ``device``.

    Returns the blobs with a cluster-ID column appended (noise -1; IDs
    offset region by region, in ascending label order, so that they stay
    unique over the image).
    """
    coords_scaled = ontology.scale_coords(
        blobs[:, :3], scaling, labels_img.shape)
    label_per_blob = ontology.get_label_ids_from_position(
        coords_scaled, labels_img)
    ids = cluster_dbscan(blobs[:, :3], eps, minpts, device=device,
                         groups=label_per_blob).astype(float)
    cluster_ids = np.full(len(blobs), -1, dtype=float)
    next_offset = 0
    for lid in np.unique(label_per_blob):
        mask = label_per_blob == lid
        lid_ids = ids[mask]
        pos = lid_ids >= 0
        lid_ids[pos] += next_offset
        if pos.any():
            next_offset = int(lid_ids[pos].max()) + 1
        cluster_ids[mask] = lid_ids
    return np.column_stack([blobs, cluster_ids])


def cluster_blobs(
        blobs: np.ndarray, eps: Optional[float] = None,
        minpts: int = 5, knn_n: int = 5,
        device: Union[str, torch.device] = "cuda"
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Cluster all blobs on ``device``; ``eps`` defaults to the 90th
    percentile (linear) of the blobs' ``knn_n``-th neighbour distances.

    Returns the blobs with the cluster-ID column appended and the stats
    ``NucCluster``, ``NucClusNoise``, ``NucClusLarg`` and ``eps``.
    """
    if eps is None:
        dists = knn_dist(blobs, knn_n, return_sorted=False, device=device)
        eps = float(np.percentile(dists, 90))
    ids = cluster_dbscan(blobs[:, :3], eps, minpts, device=device)
    n_clusters = len(set(ids[ids >= 0]))
    stats = {
        "NucCluster": n_clusters,
        "NucClusNoise": int(np.sum(ids < 0)),
        "NucClusLarg": int(np.bincount(ids[ids >= 0]).max())
        if n_clusters else 0,
        "eps": eps,
    }
    return np.column_stack([blobs, ids]), stats


def cluster_dbscan_metrics(labels: np.ndarray):
    """(num_clusters, num_noise, num_largest) for DBSCAN labels."""
    lbl_unique, lbl_counts = np.unique(
        labels[labels != -1], return_counts=True)
    num_clusters = len(lbl_unique)
    num_largest = np.nan if not len(lbl_counts) else int(
        np.amax(lbl_counts))
    num_noise = int(np.sum(labels == -1))
    return num_clusters, num_noise, num_largest


class ClusterByLabel:
    """Per-region DBSCAN of blobs: :func:`cluster_by_label` of the blobs
    scaled to isotropic voxels, on ``device``."""

    def __init__(self, blobs: np.ndarray, labels_img_np: np.ndarray,
                 blobs_lbl_scaling=None, blobs_iso_scaling=None,
                 device: Union[str, torch.device] = "cuda"):
        self.blobs = blobs
        self.labels_img_np = labels_img_np
        self.blobs_lbl_scaling = blobs_lbl_scaling or (1.0, 1.0, 1.0)
        self.blobs_iso_scaling = blobs_iso_scaling or (1.0, 1.0, 1.0)
        self.device = device

    def cluster(self, eps: float = 20.0, minpts: int = 5) -> np.ndarray:
        coords = np.multiply(
            self.blobs[:, :3], self.blobs_iso_scaling)
        return cluster_by_label(
            coords, self.labels_img_np, self.blobs_lbl_scaling,
            eps=eps, minpts=minpts, device=self.device)
