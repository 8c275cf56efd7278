"""DBSCAN and k-nearest-neighbour distances of the port
(``magellanmapper_torch.stats.clustering``, on the device) against
scikit-learn, which the JAX package runs: labels exactly on integer and
float clouds with points exactly on eps, border points between two
clusters, shuffled input and empty input; k-th distances within 1e-12 with
isolated points; per-region clustering, ``cluster_blobs``, ``vols``
without a cluster column, and ``--register cluster_blobs`` through both
command lines, on the CPU.

Every cloud holds more than ``2 * n_neighbors`` (and more than 11) points
a group: below that scikit-learn's ``auto`` switches to its brute route,
which computes ``|a|^2 + |b|^2 - 2ab`` and moves points on the eps
boundary.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import DBSCAN
from sklearn.neighbors import NearestNeighbors

from magellanmapper_tpu.io import cli as ref_cli
from magellanmapper_tpu.stats import clustering as ref_clustering
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch import testing
from magellanmapper_torch.cv import blobs as blobs_mod
from magellanmapper_torch.io import cli, np_io
from magellanmapper_torch.stats import clustering, vols

torch.set_num_threads(1)

#: k-th neighbour distances against scikit-learn (both take the correctly
#: rounded root of the same float64 square sum)
KNN_ATOL = 1e-12


def _int_cloud(seed=0, n=1500, side=24):
    """Integer points: many pairs at exactly 1, sqrt(2), 2 ... apart."""
    return np.random.default_rng(seed).integers(
        0, side, (n, 3)).astype(float)


def _float_cloud(seed=1, n=1500):
    """Float points in blobs of several densities plus scattered noise,
    with pairs placed exactly ``eps`` apart along an axis and on a
    diagonal (eps 2.0)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 60, (8, 3))
    pts = np.concatenate([
        c + rng.normal(0, s, (n // 10, 3))
        for c, s in zip(centres, (0.8, 1.2, 1.5, 2.0, 2.5, 3.0, 1.0, 0.6))])
    pts = np.concatenate([pts, rng.uniform(-10, 70, (n - len(pts), 3))])
    anchor = pts[:40].copy()
    pts = np.concatenate([pts, anchor + (2.0, 0, 0), anchor + (0, 1.2, 1.6)])
    return pts


def _sklearn(pts, eps, minpts):
    return DBSCAN(eps=eps, min_samples=minpts).fit_predict(pts)


@pytest.mark.parametrize("eps,minpts", [
    (1.0, 4), (np.sqrt(2.0), 6), (np.sqrt(3.0), 8), (2.0, 10), (2.5, 14)])
def test_dbscan_integer_cloud_matches_sklearn(eps, minpts):
    pts = _int_cloud()
    want = _sklearn(pts, eps, minpts)
    got = clustering.cluster_dbscan(pts, eps, minpts, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(set(want)) > 2 and (want == -1).any()


@pytest.mark.parametrize("eps,minpts", [(2.0, 5), (1.0, 3), (3.5, 12)])
def test_dbscan_float_cloud_matches_sklearn(eps, minpts):
    pts = _float_cloud()
    want = _sklearn(pts, eps, minpts)
    np.testing.assert_array_equal(
        clustering.cluster_dbscan(pts, eps, minpts, device="cpu"), want)
    assert len(set(want)) > 2 and (want == -1).any()


def test_dbscan_points_exactly_on_eps_count():
    """A neighbour at squared distance eps * eps counts (``<=``): a line of
    points 0.25 apart (exact in binary) is one cluster at eps 0.25 and
    noise just below it; lines 0.3 apart (inexact) as scikit-learn has
    them."""
    line = np.zeros((20, 3))
    line[:, 2] = np.arange(20) * 0.25
    at = clustering.cluster_dbscan(line, 0.25, 2, device="cpu")
    below = clustering.cluster_dbscan(line, np.nextafter(0.25, 0), 2,
                                      device="cpu")
    assert (at == 0).all() and (below == -1).all()
    line[:, 2] = np.arange(20) * 0.3 + 17.1
    for eps in (0.3, np.nextafter(0.3, 0), np.nextafter(0.3, 1)):
        for pts in (line, line[:, ::-1]):
            np.testing.assert_array_equal(
                clustering.cluster_dbscan(pts, eps, 2, device="cpu"),
                _sklearn(pts, eps, 2))


def test_dbscan_border_point_takes_smallest_cluster():
    """A non-core point within eps of the cores of two clusters takes the
    cluster whose smallest core index comes first, whatever the order."""
    a = np.stack(np.meshgrid(*(np.arange(3.0),) * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    b = a + (0, 0, 4.0)
    border = np.array([[1, 1, 3.0]])
    noise = np.array([[50, 50, 50.0], [-40, 3, 9.0]])
    for order in ([0, 1, 2, 3], [2, 1, 0, 3], [1, 3, 2, 0], [3, 0, 1, 2]):
        parts = [border, a, b, noise]
        pts = np.concatenate([parts[i] for i in order])
        want = _sklearn(pts, 1.0, 4)
        got = clustering.cluster_dbscan(pts, 1.0, 4, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert len(set(want)) == 3


def test_dbscan_shuffled_input_matches_sklearn():
    """Shuffled clouds, and a shuffled chain of 3,000 points (one cluster
    whose core graph is a long path: many rounds of hooking)."""
    pts = _int_cloud(seed=2)
    chain = np.zeros((3000, 3))
    chain[:, 0] = np.arange(3000) * 0.5
    rng = np.random.default_rng(3)
    for cloud, eps, minpts in ((pts, 2.0, 10), (pts, 2.0, 10),
                               (chain, 0.5, 3)):
        shuffled = cloud[rng.permutation(len(cloud))]
        got = clustering.cluster_dbscan(shuffled, eps, minpts, device="cpu")
        np.testing.assert_array_equal(got, _sklearn(shuffled, eps, minpts))
    assert (got == 0).all()


def test_dbscan_and_knn_in_small_chunks(monkeypatch):
    """Query blocks and pair chunks split many times (a query with more
    candidates than a chunk forms its own) give the same labels and
    distances."""
    monkeypatch.setattr(clustering, "PAIR_CHUNK", 50)
    monkeypatch.setattr(clustering, "QUERY_BLOCK", 37)
    pts = _int_cloud(seed=12, n=600, side=12)
    np.testing.assert_array_equal(
        clustering.cluster_dbscan(pts, 1.5, 6, device="cpu"),
        _sklearn(pts, 1.5, 6))
    want = NearestNeighbors(n_neighbors=5).fit(pts).kneighbors(pts)[0]
    np.testing.assert_allclose(
        clustering.knn_dist(pts, 5, return_sorted=False, device="cpu"),
        want[:, -1], rtol=0, atol=KNN_ATOL)


def test_dbscan_empty_and_invalid():
    assert clustering.cluster_dbscan(np.zeros((0, 3)), 1.0, 5,
                                     device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="eps"):
        clustering.cluster_dbscan(np.zeros((4, 3)), 0.0, 5, device="cpu")


def test_dbscan_groups_equal_each_group_alone():
    """With groups, only points of a group neighbour each other and each
    group numbers from 0: DBSCAN of each group's points alone."""
    pts = _int_cloud(seed=4, n=1200, side=16)
    groups = np.random.default_rng(5).integers(-3, 3, len(pts)) * 7
    got = clustering.cluster_dbscan(pts, 1.5, 4, device="cpu",
                                    groups=groups)
    for g in np.unique(groups):
        m = groups == g
        np.testing.assert_array_equal(got[m], _sklearn(pts[m], 1.5, 4))


@pytest.mark.parametrize("cloud", ["int", "float", "isolated"])
def test_knn_dist_matches_sklearn(cloud):
    pts = {"int": _int_cloud(seed=6, n=800, side=40),
           "float": _float_cloud(seed=7),
           "isolated": np.concatenate([
               _float_cloud(seed=8, n=300),
               [[1e4, 0, 0], [0, -3e3, 5], [500, 500, 500]]])}[cloud]
    nbrs = NearestNeighbors(n_neighbors=5).fit(pts)
    want = nbrs.kneighbors(pts)[0][:, -1]
    got = clustering.knn_dist(pts, 5, return_sorted=False, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=KNN_ATOL)
    np.testing.assert_allclose(
        clustering.knn_dist(pts, 5, device="cpu"),
        ref_clustering.knn_dist(pts, 5), rtol=0, atol=KNN_ATOL)
    with pytest.raises(ValueError, match="n_neighbors"):
        clustering.knn_dist(pts[:3], 5, device="cpu")


def test_cluster_blobs_matches_reference():
    """eps from the 90th percentile of the 5th-neighbour distances (a value
    that pairs of the integer cloud sit at exactly), then DBSCAN."""
    pts = testing.make_point_cloud(6000, 0)
    blobs = np.column_stack([pts, np.full(len(pts), 3.0)])
    got, stats = clustering.cluster_blobs(blobs, device="cpu")
    want, want_stats = ref_clustering.cluster_blobs(blobs)
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats
    assert stats["NucCluster"] > 1 and stats["NucClusNoise"] > 0


def test_cluster_by_label_matches_reference():
    pts = _int_cloud(seed=9, n=2000, side=30)
    labels = np.zeros((10, 10, 10), np.int32)
    labels[:5] = 3
    labels[5:, :4] = -2
    labels[5:, 4:] = 9
    scaling = (1 / 3, 1 / 3, 1 / 3)
    got = clustering.cluster_by_label(pts, labels, scaling, eps=1.5,
                                      minpts=4, device="cpu")
    want = ref_clustering.cluster_by_label(pts, labels, scaling, eps=1.5,
                                           minpts=4)
    np.testing.assert_array_equal(got, want)
    by_cls = clustering.ClusterByLabel(
        pts, labels, blobs_lbl_scaling=scaling, device="cpu").cluster(1.5, 4)
    np.testing.assert_array_equal(by_cls, ref_clustering.ClusterByLabel(
        pts, labels, blobs_lbl_scaling=scaling).cluster(1.5, 4))
    assert len(np.unique(got[:, -1])) > 3


def test_vols_clusters_blobs_without_a_cluster_column():
    """Per-region ``NucCluster``, ``NucClusNoise`` and ``NucClusLarg`` from
    blobs carrying only their region (column 3, both sides) equal the
    reference's region-by-region DBSCAN."""
    rng = np.random.default_rng(10)
    labels = np.zeros((12, 20, 20), np.int32)
    labels[:6] = 4
    labels[6:, :10] = -4
    labels[6:, 10:] = 7
    labels[:3, :5] = 0
    pts = _int_cloud(seed=11, n=1800, side=40)
    region = labels[tuple((pts // (40 / np.array(labels.shape))).astype(
        int).T)]
    blobs = np.column_stack([pts, region])
    blobs = blobs[rng.permutation(len(blobs))]
    for combine in (True, False):
        got = vols.measure_labels_metrics(
            None, labels, blobs=blobs, cluster_eps=1.5, cluster_minpts=4,
            combine_sides=combine, device="cpu")
        want = ref_vols.measure_labels_metrics(
            None, labels, blobs=blobs, cluster_eps=1.5, cluster_minpts=4,
            combine_sides=combine)
        cols = ["Region", "NucCluster", "NucClusNoise", "NucClusLarg"]
        pd.testing.assert_frame_equal(
            got[cols].astype(float), want[cols].astype(float))
        assert (got["NucCluster"] > 1).all()


def test_cli_cluster_blobs_matches_reference(tmp_path):
    pts = testing.make_point_cloud(3000, 1)
    paths = []
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
        paths.append(str(tmp_path / name / "vol.npy"))
        np_io.write_npy(paths[-1], np.zeros((4, 8, 8), np.uint16))
        b = blobs_mod.Blobs(np.column_stack([pts, np.full(len(pts), 3.0)]))
        b.format_blobs(0)
        b.path = paths[-1].replace(".npy", "_blobs.npz")
        b.save_archive()
    got = cli.main(["--img", paths[0], "--register", "cluster_blobs",
                    "--device", "cpu"])
    want = ref_cli.main(["--img", paths[1], "--register", "cluster_blobs"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(paths[0] + "_clusters.npy"), got)
    assert len(np.unique(got[:, -1])) > 2


def test_small_groups_follow_the_kd_tree_pin():
    """scikit-learn's ``auto`` takes its brute route for at most 11 points
    (``n_neighbors`` 5 >= n // 2), where ``|a|^2 + |b|^2 - 2ab`` moves a
    pair exactly eps apart out of reach; from 12 points its kd-tree keeps
    it, as the port always does. The reference's per-region DBSCAN
    (``vols``) meets both routes, region by region."""
    a = np.array([float.fromhex(v) for v in (
        "0x1.7a4600fab2d59p+9", "0x1.26a199592a858p+9",
        "0x1.d6c857dd49f67p+9")])
    b = np.array([float.fromhex(v) for v in (
        "0x1.7a2069f6afb6ap+9", "0x1.26a41766145afp+9",
        "0x1.d63c1eaa4662ep+9")])
    d = a - b
    eps = float(np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
    far = a + np.arange(1, 11)[:, None] * 1000.0
    small = np.concatenate([[a, b], far[:2]])
    large = np.concatenate([[a, b], far])
    assert (_sklearn(small, eps, 2) == -1).all()
    np.testing.assert_array_equal(
        clustering.cluster_dbscan(small, eps, 2, device="cpu")[:2], [0, 0])
    np.testing.assert_array_equal(
        clustering.cluster_dbscan(large, eps, 2, device="cpu"),
        _sklearn(large, eps, 2))
    assert (_sklearn(large, eps, 2)[:2] == 0).all()
