"""``atlas.reg_tasks`` and ``atlas.labels_meta`` of ``magellanmapper_torch``
against the JAX package's, on the CPU, and the card's painting against the
host loop (``cuda`` marker; skips here).

Tolerance: none. ``build_labels_diff_images`` builds the difference table
on the host as the reference does and paints it by a sorted lookup and a
gather; its image equals ``vols.map_meas_to_labels``' host loop (the plain
version) and the reference's bit for bit, float64 values and all, with
duplicated, absent, non-integral and negative region IDs; its ``.mhd``
file equals the reference's byte for byte.
"""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch

from magellanmapper_tpu.atlas import labels_meta as ref_labels_meta
from magellanmapper_tpu.atlas import reg_tasks as ref_reg_tasks
from magellanmapper_torch.atlas import labels_meta, reg_tasks
from magellanmapper_torch.stats import vols

SHAPE = (9, 13, 11)


def _labels(seed=0, ids=(-7, -3, -2, 0, 2, 3, 5, 9), dtype=np.int32):
    rng = np.random.default_rng(seed)
    return np.asarray(ids)[rng.integers(0, len(ids), SHAPE)].astype(dtype)


def _table(seed=0, regions=(2, 3, 5, 7, 11), conds=("a", "b")):
    rng = np.random.default_rng(seed)
    return pd.DataFrame([{"Region": r, "Condition": c,
                          "Volume": float(rng.integers(1, 1000)),
                          "Density": rng.random()}
                         for c in conds for r in regions])


def _same(got, want):
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["Volume", "Density"])
@pytest.mark.parametrize("conds", [None, ("b", "a")])
def test_build_labels_diff_images_matches_reference(metric, conds):
    labels, df = _labels(), _table()
    got = reg_tasks.build_labels_diff_images(labels, df, metric, conds=conds,
                                             device="cpu")
    _same(got, ref_reg_tasks.build_labels_diff_images(labels, df, metric,
                                                      conds=conds))


@pytest.mark.parametrize("case", [
    "absent_regions", "region_in_one_condition", "duplicated_regions",
    "negative_region_ids", "non_integral_and_huge_ids", "nan_values",
    "no_common_region"])
def test_build_labels_diff_images_edge_cases_match_reference(case):
    labels, df = _labels(1), _table(1)
    if case == "absent_regions":
        df = df[df["Region"] != 3]
    elif case == "region_in_one_condition":
        df = df.drop(index=df.index[(df["Region"] == 5)
                                    & (df["Condition"] == "b")])
    elif case == "duplicated_regions":
        # the same rows again, later and with other values: last wins
        dup = df.copy()
        dup["Density"] = dup["Density"] * 2 + 1
        df = pd.concat([df, dup], ignore_index=True)
    elif case == "negative_region_ids":
        df.loc[df["Region"] == 2, "Region"] = -2
        df.loc[df["Region"] == 7, "Region"] = -7
    elif case == "non_integral_and_huge_ids":
        df["Region"] = df["Region"].astype(float)
        df.loc[df["Region"] == 3.0, "Region"] = 3.5
        df.loc[df["Region"] == 11.0, "Region"] = 2.0 ** 40
    elif case == "nan_values":
        df.loc[df["Region"] == 5, "Density"] = np.nan
    else:
        df["Region"] = np.where(df["Condition"] == "a", df["Region"],
                                df["Region"] + 100)
    got = reg_tasks.build_labels_diff_images(labels, df, "Density",
                                             device="cpu")
    _same(got, ref_reg_tasks.build_labels_diff_images(labels, df, "Density"))


def _diff_table(seed):
    rng = np.random.default_rng(seed)
    regions = np.array([2, -3, 5, 5, 9, 2, 40, np.nan, 7.5, -7],
                       dtype=float)
    return pd.DataFrame({"Region": regions,
                         "Value": rng.normal(size=len(regions))})


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16,
                                   np.int32, np.uint32, np.int64,
                                   np.float32, np.float64, bool])
@pytest.mark.parametrize("combine_sides", [True, False])
def test_painting_equals_the_host_loop(dtype, combine_sides):
    """The lookup and gather against ``map_meas_to_labels``' loop on every
    labels type: duplicated rows (the last wins), absent, negative,
    non-integral and NaN regions, both sides combined or not."""
    ids = (0, 1) if dtype is bool else (
        (0, 2, 5, 7, 9, 200) if np.dtype(dtype).kind == "u"
        else (-7, -3, -2, 0, 2, 5, 9, 100))
    labels = _labels(2, ids, dtype)
    table = _diff_table(3)
    if dtype is bool:
        table.loc[0, "Region"] = 1
    got = reg_tasks._paint_labels(labels, table, "Value", combine_sides,
                                  device="cpu")
    _same(got, vols.map_meas_to_labels(labels, table, "Value",
                                       combine_sides))


def test_painting_an_empty_table_gives_zeros():
    labels = _labels(4)
    empty = pd.DataFrame({"Region": [], "Value": []})
    _same(reg_tasks._paint_labels(labels, empty, "Value", device="cpu"),
          vols.map_meas_to_labels(labels, empty, "Value"))


def test_diff_image_file_matches_reference(tmp_path):
    labels, df = _labels(5), _table(5)
    paths = [str(tmp_path / f"{n}_diff.mhd") for n in ("port", "ref")]
    reg_tasks.build_labels_diff_images(labels, df, "Volume",
                                       out_path=paths[0], device="cpu")
    ref_reg_tasks.build_labels_diff_images(labels, df, "Volume",
                                           out_path=paths[1])
    for ext in (".mhd", ".raw"):
        a, b = (os.path.splitext(p)[0] + ext for p in paths)
        if ext == ".mhd":
            # the header names its own .raw file
            assert open(a).read().replace("port_", "ref_") == open(b).read()
        else:
            assert filecmp.cmp(a, b, shallow=False)


def test_one_condition_raises_as_reference():
    df = _table(conds=("a",))
    for fn, kwargs in ((reg_tasks.build_labels_diff_images,
                        {"device": "cpu"}),
                       (ref_reg_tasks.build_labels_diff_images, {})):
        with pytest.raises(ValueError, match="two conditions"):
            fn(_labels(), df, "Volume", **kwargs)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_painting_on_the_card_equals_the_host_loop():
    labels = _labels(6, (-9, -5, -2, 0, 2, 5, 9, 11))
    table = _diff_table(7)
    for combine_sides in (True, False):
        _same(reg_tasks._paint_labels(labels, table, "Value", combine_sides,
                                      device="cuda"),
              vols.map_meas_to_labels(labels, table, "Value",
                                      combine_sides))
    df = _table(8, regions=(2, 5, 9))
    _same(reg_tasks.build_labels_diff_images(labels, df, "Density",
                                             device="cuda"),
          reg_tasks.build_labels_diff_images(labels, df, "Density",
                                             device="cpu"))


# -- labels_meta --------------------------------------------------------------

@pytest.mark.parametrize("prefix,ids", [
    ("sample.npy", [3, 1, 2]), (None, None), ("dir/b.mhd", np.arange(4))])
def test_labels_meta_round_trips_with_reference(tmp_path, prefix, ids):
    """A sidecar saved by either package loads in the other with the same
    path and IDs, under the same file name."""
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        if prefix and os.path.dirname(prefix):
            os.makedirs(os.path.dirname(prefix))
        for saver, loader in ((labels_meta, ref_labels_meta),
                              (ref_labels_meta, labels_meta)):
            meta = saver.LabelsMeta(prefix)
            meta.path_ref = "ref.json"
            meta.region_ids_orig = ids
            path = meta.save()
            assert path == loader.LabelsMeta(prefix).save_path
            got = loader.LabelsMeta(prefix).load()
            assert got.path_ref == "ref.json"
            assert got.region_ids_orig == (
                None if ids is None else [int(i) for i in ids])
            os.remove(path)
        missing = labels_meta.LabelsMeta("none.npy").load()
        assert missing.path_ref is None and missing.region_ids_orig is None
        assert labels_meta.SUFFIX == ref_labels_meta.SUFFIX
    finally:
        os.chdir(cwd)
