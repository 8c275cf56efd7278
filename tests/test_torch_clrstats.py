"""``stats.clrstats`` of ``magellanmapper_torch`` against the JAX package's,
on the CPU: every model of ``meas_group_stats`` on seeded study tables,
and ``plot_volcano``'s file.

Tolerance: none. The port's copy runs the same numpy and scipy code on the
same inputs, so every table equals the reference's exactly (the IRLS,
BFGS and GEE fits included); the volcano plot's PNG equals the
reference's by pixels.
"""

import numpy as np
import pandas as pd
import pytest

from magellanmapper_tpu.stats import clrstats as ref_clrstats
from magellanmapper_torch.stats import clrstats

from test_torch_plot import pixels


def _study(seed=0, n_samples=8, regions=(1, 2, 3, 4), levels=("wt", "ko"),
           sides=True):
    """A region table of ``n_samples`` samples a condition level, each
    region of each sample on both sides: region 1 shifted in the second
    level, region 3 noisier there, region 4 present in one level only."""
    rng = np.random.default_rng(seed)
    rows = []
    for li, level in enumerate(levels):
        for s in range(n_samples):
            sample = f"{level}{s}"
            for region in regions:
                if region == 4 and li:
                    continue
                for side in (("L", "R") if sides else ("R",)):
                    shift = 1.5 * li if region == 1 else 0.0
                    sd = 1.0 + (2.0 * li if region == 3 else 0.0)
                    rows.append({
                        "Sample": sample, "Condition": level, "Side": side,
                        "Region": region,
                        "Volume": 10.0 + shift + rng.normal(0.0, sd)})
    return pd.DataFrame(rows)


def _paired(seed=1, n_samples=10):
    """The same samples before and after, with large sample offsets."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_samples):
        base = rng.normal(0.0, 5.0)
        for region, shift in ((1, 1.0), (2, 0.0), (3, 0.0)):
            for cond, sh in (("pre", 0.0), ("post", shift)):
                if region == 3 and cond == "post" and s % 2:
                    continue
                rows.append({"Sample": s, "Condition": cond,
                             "Region": region,
                             "Volume": base + sh + rng.normal(0, 0.2)})
    return pd.DataFrame(rows)


def _same(kwargs, df):
    got = clrstats.meas_group_stats(df, **kwargs)
    want = ref_clrstats.meas_group_stats(df, **kwargs)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    return got


@pytest.mark.parametrize("model", [
    "ttest", "wilcoxon", "mannwhitney", "fligner", "shapiro", "basic",
    "diff.mean", "logit", "linregr", "gee"])
def test_unpaired_models_match_reference(model):
    got = _same({"metric": "Volume", "conds": ("wt", "ko"), "model": model},
                _study())
    assert len(got) >= 3


@pytest.mark.parametrize("model", ["ttest.paired", "wilcoxon.paired"])
def test_paired_models_match_reference(model):
    got = _same({"metric": "Volume", "conds": ("pre", "post"),
                 "model": model}, _paired())
    assert got.set_index("Region").loc[1, "P"] < 0.01


def test_gaussian_gee_matches_reference():
    _same({"metric": "Volume", "conds": ("wt", "ko"), "model": "gee",
           "gee_family": "gaussian"}, _study(seed=2))


def test_ordinal_logit_on_three_levels_matches_reference():
    df = _study(seed=3, levels=("WT", "het", "null"), sides=False)
    got = _same({"metric": "Volume", "conds": ("WT", "null"),
                 "model": "logit.ord"}, df)
    assert got["P"].notna().all()


def test_default_conditions_and_columns_match_reference():
    df = _study(seed=4).rename(columns={"Region": "Id", "Condition": "Geno"})
    _same({"metric": "Volume", "cond_col": "Geno", "region_col": "Id"}, df)


def test_kmodel_and_fdr_match_reference():
    assert clrstats.KMODEL == ref_clrstats.KMODEL
    p = np.random.default_rng(5).random(40)
    p[[3, 7]] = 1e-6
    np.testing.assert_array_equal(clrstats._fdr_bh(p),
                                  ref_clrstats._fdr_bh(p))


def test_unknown_model_raises_as_reference():
    df = _study()
    for fn in (clrstats.meas_group_stats, ref_clrstats.meas_group_stats):
        with pytest.raises(ValueError, match="unknown model: nope"):
            fn(df, "Volume", conds=("wt", "ko"), model="nope")


def test_plot_volcano_matches_reference(tmp_path):
    stats = clrstats.meas_group_stats(_study(seed=6, regions=range(1, 30)),
                                      "Volume", conds=("wt", "ko"))
    paths = [str(tmp_path / f"{name}.png") for name in ("port", "ref")]
    clrstats.plot_volcano(stats, paths[0])
    ref_clrstats.plot_volcano(stats, paths[1])
    np.testing.assert_array_equal(pixels(paths[0]), pixels(paths[1]))
