"""Blob clustering metrics.

Copy of what the per-region metrics need from
``magellanmapper_tpu/stats/clustering.py``: :func:`cluster_dbscan_metrics`
(clusters, noise and largest cluster of a region's DBSCAN labels, host
numpy). The DBSCAN itself (``cluster_dbscan``, ``cluster_by_label``,
``cluster_blobs``, ``knn_dist``) runs scikit-learn in the reference and
is not ported yet (ROADMAP queue): :func:`cluster_dbscan` raises.
"""

from __future__ import annotations

import numpy as np


def cluster_dbscan(coords: np.ndarray, eps: float, minpts: int):
    """DBSCAN cluster labels: not ported yet."""
    raise NotImplementedError(
        "DBSCAN clustering (stats.clustering.cluster_dbscan) is not ported "
        "to magellanmapper_torch yet; pass blobs with precomputed cluster "
        "IDs in column 4")


def cluster_dbscan_metrics(labels: np.ndarray):
    """(num_clusters, num_noise, num_largest) for DBSCAN labels
    (reference ``clustering.cluster_dbscan_metrics``)."""
    lbl_unique, lbl_counts = np.unique(
        labels[labels != -1], return_counts=True)
    num_clusters = len(lbl_unique)
    num_largest = np.nan if not len(lbl_counts) else int(
        np.amax(lbl_counts))
    num_noise = int(np.sum(labels == -1))
    return num_clusters, num_noise, num_largest
