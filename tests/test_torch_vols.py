"""Per-region metrics (``stats/vols``) of ``magellanmapper_torch`` against
the JAX reference on seeded fixtures, and the two recorded deviations
where the reference breaks its own contract.

Tolerances: integer columns (``Region``, ``VolPx``, ``Nuclei`` of an
integer heat map, ``EdgeSize``) and the cluster columns exactly; the
percentiles (``Med/Low/HighIntensity``), ``SurfaceArea``,
``Compactness`` and the edge distances exactly too (the port gathers the
same float32 order statistics and interpolates, counts and sums in the
reference's float64 steps). Every other float column within rtol 1e-5:
the reference sums in float32, the port in float64. The variance family
(``VarIntensity``/``VarNuclei`` and their ``CoefVar``) is compared as
variances, ``std**2``, within the float32 bound of the reference's
arithmetic: ``(4 * 2**-23 + 3 * N * 2**-24) * s2 / N`` for a label of N
voxels whose mean square is ``s2 / N`` (the cancellation of
``s2 / N - mean**2`` in float32, plus the float32 sums of N terms), and
for ``CoefVar`` one more rounding of the division, ``4 * 2**-23 * s2 /
N``. The perimeter and the labels' edge image exactly.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import ontology as ref_ontology
from magellanmapper_tpu.cv import cv_nd as ref_cv_nd
from magellanmapper_tpu.stats import vols as ref_vols
from magellanmapper_torch.atlas import ontology
from magellanmapper_torch.cv import cv_nd
from magellanmapper_torch.stats import vols

torch.set_num_threads(1)

RTOL = 1e-5
#: columns compared exactly
EXACT = ("Region", "VolPx", "Nuclei", "MedIntensity", "LowIntensity",
         "HighIntensity", "EdgeSize", "EdgeDistSum", "EdgeDistMean",
         "SurfaceArea", "Compactness", "NucCluster", "NucClusNoise",
         "NucClusLarg")
#: the variance family: (std column, mean column, coefficient of variation)
VARIANCES = (("VarIntensity", "MeanIntensity", "CoefVarIntens"),
             ("VarNuclei", "MeanNuclei", "CoefVarNuc"))

ABA_TREE = {"msg": [{
    "id": 1, "name": "root", "acronym": "rt", "st_level": 0,
    "parent_structure_id": None,
    "children": [
        {"id": 2, "name": "cortex", "acronym": "cx", "st_level": 1,
         "parent_structure_id": 1, "children": [
             {"id": 4, "name": "layer1", "acronym": "l1",
              "st_level": 2, "parent_structure_id": 2, "children": []},
             {"id": 5, "name": "layer2", "acronym": "l2",
              "st_level": 2, "parent_structure_id": 2, "children": []},
         ]},
        {"id": 3, "name": "thalamus", "acronym": "th", "st_level": 1,
         "parent_structure_id": 1, "children": []},
    ]}]}


@pytest.fixture
def aba_path(tmp_path):
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(ABA_TREE))
    return str(path)


def _fixture(seed, shape=(14, 18, 20), ids=(-5, -4, -3, 0, 2, 3, 4, 5)):
    """Seeded labels (both sides), a float32 intensity image, an int32
    heat map, an edge mask and edge distances."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(ids, np.int32)[rng.integers(0, len(ids), shape)]
    labels[:2] = 0
    return {
        "labels": labels,
        "atlas": (rng.random(shape) * 100).astype(np.float32),
        "heat": rng.integers(0, 3, shape).astype(np.int32),
        "edge": rng.random(shape) > 0.7,
        "dist": rng.normal(0, 3, shape).astype(np.float32),
    }


def _moments(labels, img, ids, combine_sides):
    """Voxel count and mean square of ``img`` per label of ``ids``, in
    float64 on the host."""
    work = np.abs(labels) if combine_sides else labels
    out = []
    for lid in ids:
        vals = np.asarray(img, np.float64)[work == lid]
        out.append((len(vals), float(np.mean(vals ** 2)) if len(vals)
                    else 0.0))
    return np.array(out)


def assert_metrics_match(got, want, labels, atlas=None, heat=None,
                         combine_sides=True):
    """The port's table against the reference's, with the tolerances of
    the module docstring."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    ids = want["Region"].to_numpy()
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if col == "RegionName":
            assert list(g) == list(w)
        elif col in EXACT:
            np.testing.assert_array_equal(g.astype(float), w.astype(float),
                                          err_msg=col)
        elif col not in sum(VARIANCES, ()):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=col)
    for (std, mean, coef), img in zip(VARIANCES, (atlas, heat)):
        if img is None:
            continue
        n, ms = _moments(labels, img, ids, combine_sides).T
        bound = (4 * 2.0 ** -23 + 3 * n * 2.0 ** -24) * ms
        g_var = got[std].to_numpy() ** 2
        w_var = want[std].to_numpy().astype(np.float64) ** 2
        assert np.all(np.abs(g_var - w_var) <= bound), std
        g_cv = (got[coef].to_numpy()
                * np.maximum(got[mean].to_numpy(), 1e-12)) ** 2
        w_cv = (want[coef].to_numpy().astype(np.float64)
                * np.maximum(want[mean].to_numpy().astype(np.float64),
                             1e-12)) ** 2
        assert np.all(np.abs(g_cv - w_cv)
                      <= bound + 4 * 2.0 ** -23 * ms), coef


@pytest.mark.parametrize("combine_sides", [True, False])
def test_measure_labels_metrics_matches_reference(combine_sides):
    f = _fixture(0)
    kwargs = dict(heat_map=f["heat"], labels_edge=f["edge"],
                  dist_to_orig=f["dist"], spacing=(2.0, 1.0, 0.5),
                  combine_sides=combine_sides)
    want = ref_vols.measure_labels_metrics(f["atlas"], f["labels"], **kwargs)
    got = vols.measure_labels_metrics(f["atlas"], f["labels"],
                                      device="cpu", **kwargs)
    assert_metrics_match(got, want, f["labels"], f["atlas"], f["heat"],
                         combine_sides)
    # integer counts stay integers
    assert got["VolPx"].dtype == np.int64 and got["Nuclei"].dtype == np.int64


def test_metrics_without_images_and_with_listed_ids():
    f = _fixture(1)
    for kwargs in ({}, {"label_ids": [3, -4, 7]},
                   {"label_ids": [3, -4], "combine_sides": False}):
        want = ref_vols.measure_labels_metrics(None, f["labels"], **kwargs)
        got = vols.measure_labels_metrics(None, f["labels"], device="cpu",
                                          **kwargs)
        assert_metrics_match(got, want, f["labels"])
    empty = vols.measure_labels_metrics(
        None, np.zeros((4, 5, 6), np.int32), device="cpu")
    assert list(empty.columns) == list(ref_vols.LABEL_METRICS)
    assert len(empty) == 0


def test_metrics_at_an_ontology_level(aba_path):
    labels = np.zeros((8, 10, 12), np.int32)
    labels[:3], labels[3:5], labels[5:7] = 4, 5, -3
    atlas = np.random.default_rng(2).random(labels.shape).astype(np.float32)
    want_ref = ref_ontology.LabelsRef(aba_path).load()
    got_ref = ontology.LabelsRef(aba_path).load()
    for level in (0, 1, 2):
        want = ref_vols.measure_labels_metrics(
            atlas, labels, labels_ref=want_ref, level=level)
        got = vols.measure_labels_metrics(
            atlas, labels, labels_ref=got_ref, level=level, device="cpu")
        assert_metrics_match(got, want, ontology.make_labels_level(
            labels, got_ref.ref_lookup, level), atlas)
    want = ref_vols.measure_labels_metrics_levels(
        atlas, labels, want_ref, max_level=2)
    got = vols.measure_labels_metrics_levels(
        atlas, labels, got_ref, max_level=2, device="cpu")
    np.testing.assert_array_equal(got["Level"], want["Level"])
    np.testing.assert_array_equal(got["Region"], want["Region"])
    np.testing.assert_array_equal(got["VolPx"], want["VolPx"])


def test_cluster_columns_from_precomputed_ids():
    rng = np.random.default_rng(3)
    labels = np.full((8, 8, 8), 2, np.int32)
    labels[4:] = -6
    n = 40
    blobs = np.column_stack([
        rng.integers(0, 8, (n, 3)), rng.choice([2, -6, 6], n),
        rng.integers(-1, 4, n)]).astype(float)
    for combine_sides in (True, False):
        want = ref_vols.measure_labels_metrics(
            None, labels, blobs=blobs, combine_sides=combine_sides)
        got = vols.measure_labels_metrics(
            None, labels, blobs=blobs, combine_sides=combine_sides,
            device="cpu")
        assert_metrics_match(got, want, labels)
    # a region whose blobs are all noise, and none at all
    blobs = np.array([[1, 1, 1, 2, -1], [2, 2, 2, 2, -1]], float)
    want = ref_vols.measure_labels_metrics(None, labels, blobs=blobs)
    got = vols.measure_labels_metrics(None, labels, blobs=blobs,
                                      device="cpu")
    assert_metrics_match(got, want, labels)


def test_percentiles_follow_numpy_on_ties_signs_and_single_voxels():
    labels = np.zeros((6, 7, 8), np.int32)
    labels[0, 0, 0] = 9                      # one voxel
    labels[1] = 3                            # ties
    labels[2:4] = 4                          # negatives and signed zeros
    labels[4:, :, :3] = 5
    atlas = np.random.default_rng(4).normal(0, 1, labels.shape).astype(
        np.float32)
    atlas[1] = np.float32(0.25) * np.random.default_rng(5).integers(
        0, 3, atlas[1].shape)
    atlas[2, :, :4] = -0.0
    atlas[2, :, 4:] = 0.0
    want = ref_vols.measure_labels_metrics(atlas, labels)
    got = vols.measure_labels_metrics(atlas, labels, device="cpu")
    assert_metrics_match(got, want, labels, atlas)


def test_host_copies_match_reference():
    f = _fixture(6, shape=(6, 8, 9), ids=(-2, 0, 1, 2, 3))
    other = np.roll(f["labels"], 1, axis=2)
    for combine_sides in (True, False):
        pd.testing.assert_frame_equal(
            vols.measure_label_overlap(f["labels"], other, f["heat"],
                                       combine_sides, device="cpu"),
            ref_vols.measure_label_overlap(f["labels"], other, f["heat"],
                                           combine_sides))
    pd.testing.assert_frame_equal(
        vols.labels_distance(f["labels"], other, (2.0, 1.0, 1.0),
                             device="cpu"),
        ref_vols.labels_distance(f["labels"], other, (2.0, 1.0, 1.0)))
    pd.testing.assert_frame_equal(
        vols.measure_labels_overlap((f["labels"], other), f["heat"],
                                    label_ids=[1, -2],
                                    grouping={"Condition": "a"},
                                    device="cpu"),
        ref_vols.measure_labels_overlap((f["labels"], other), f["heat"],
                                        label_ids=[1, -2],
                                        grouping={"Condition": "a"}))
    df = pd.DataFrame({"Region": [1, 2, 3], "Volume": [10.0, 20.0, 30.0]})
    np.testing.assert_array_equal(
        vols.map_meas_to_labels(f["labels"], df, "Volume"),
        ref_vols.map_meas_to_labels(f["labels"], df, "Volume"))
    assert [m.value for m in vols.LabelMetrics] == [
        m.value for m in ref_vols.LabelMetrics]
    assert vols.LABEL_METRICS == ref_vols.LABEL_METRICS
    assert [m.name for m in vols.WT_METRICS] == [
        m.name for m in ref_vols.WT_METRICS]
    assert [(c.value[0], [m.name for m in c.value[1]])
            for c in vols.MetricCombos] == [
        (c.value[0], [m.name for m in c.value[1]])
        for c in ref_vols.MetricCombos]
    for stat in ("VarIntensity", "EdgeDistMean", "Volume", "Nuclei"):
        assert vols.get_metric_weight_col(stat) == \
            ref_vols.get_metric_weight_col(stat)
    for val in ([7, 8], (9,), np.array([3]), 4, []):
        assert vols.get_single_label(val) == ref_vols.get_single_label(val)
    got = vols.MeasureLabel(f["atlas"], f["labels"], f["heat"],
                            spacing=(1.0, 2.0, 2.0), device="cpu").measure()
    want = ref_vols.MeasureLabel(f["atlas"], f["labels"], f["heat"],
                                 spacing=(1.0, 2.0, 2.0)).measure()
    assert_metrics_match(got, want, f["labels"], f["atlas"], f["heat"])
    pd.testing.assert_frame_equal(
        vols.MeasureLabelOverlap((f["labels"], other),
                                 device="cpu").measure(),
        ref_vols.MeasureLabelOverlap((f["labels"], other)).measure())


@pytest.mark.parametrize("largest_only", [False, True])
def test_perimeter_and_label_edges_match_reference(largest_only):
    rng = np.random.default_rng(7)
    labels = np.zeros((10, 12, 14), np.int32)
    labels[2:8, 3:9, 2:10] = 3
    labels[4:7, 4:8, 6:12] = 5
    labels[0:2, 0:2, 0:2] = 8                # a second, smaller component
    labels[rng.random(labels.shape) > 0.97] = 0
    mask = labels != 0
    np.testing.assert_array_equal(
        cv_nd.perimeter_nd(mask, largest_only, device="cpu"),
        ref_cv_nd.perimeter_nd(mask, largest_only))
    np.testing.assert_array_equal(
        cv_nd.perimeter_nd(mask[5], largest_only, device="cpu"),
        ref_cv_nd.perimeter_nd(mask[5], largest_only))
    np.testing.assert_array_equal(
        vols.LabelToEdge(labels, device="cpu").make_edge_img(),
        ref_vols.LabelToEdge(labels).make_edge_img())


def test_unported_options_raise_by_name():
    labels = np.ones((4, 4, 4), np.int32)
    with pytest.raises(NotImplementedError, match="_segment_stats_sharded"):
        vols.measure_labels_metrics(None, labels, mesh=object(),
                                    device="cpu")
    # blobs without a cluster column are clustered here, as the
    # reference clusters them (DBSCAN within each region)
    grid = np.stack(np.meshgrid(*(np.arange(3.0),) * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    blobs = np.column_stack([np.concatenate([grid, grid * 9]),
                             np.ones(2 * len(grid))])
    got = vols.measure_labels_metrics(None, labels, blobs=blobs,
                                      cluster_eps=1.5, device="cpu")
    want = ref_vols.measure_labels_metrics(None, labels, blobs=blobs,
                                           cluster_eps=1.5)
    cols = ["NucCluster", "NucClusNoise", "NucClusLarg"]
    pd.testing.assert_frame_equal(got[cols], want[cols].astype(float))
    # the second grid's origin repeats the first's: 28 in the cluster
    assert got[cols].values.tolist() == [[1.0, 26.0, 28.0]]


# -- recorded deviations ------------------------------------------------------

def test_vols_counts_past_2_24_in_a_region_pin():
    """The reference counts a region's voxels as a float32 scatter-add,
    which stops at 2^24; the port counts in int64. Fixture: one region of
    20,000,000 voxels."""
    labels = np.ones((20, 1000, 1000), np.int8)
    want = ref_vols.measure_labels_metrics(None, labels)
    got = vols.measure_labels_metrics(None, labels, device="cpu")
    assert int(got["VolPx"].iloc[0]) == labels.size
    assert float(want["VolPx"].iloc[0]) == 2.0 ** 24


def test_vols_float32_variance_cancellation_pin():
    """The reference forms ``s2 / N - mean**2`` from float32 sums, which
    cancel for intensities of about 1e4 +- 1 (the variance, ~1/3, comes
    out 0); the port sums in float64 and keeps it within 1e-5 of numpy's
    float64 variance of the same float32 values."""
    rng = np.random.default_rng(8)
    labels = np.ones((10, 20, 20), np.int32)
    labels[5:] = 2
    atlas = (10000 + rng.uniform(-1, 1, labels.shape)).astype(np.float32)
    truth = np.array([np.var(atlas[labels == i].astype(np.float64))
                      for i in (1, 2)])
    want = ref_vols.measure_labels_metrics(atlas, labels)
    got = vols.measure_labels_metrics(atlas, labels, device="cpu")
    np.testing.assert_allclose(got["VarIntensity"] ** 2, truth, rtol=1e-5)
    assert np.all(np.abs(want["VarIntensity"].to_numpy() ** 2 - truth)
                  > 0.1 * truth)
