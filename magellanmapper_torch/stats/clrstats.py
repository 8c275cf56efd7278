"""Group statistics and volcano plots.

Copy of ``magellanmapper_tpu/stats/clrstats.py``, the reference's Python
stand-in for the ``clrstats`` R package: per-region group models over the
regions' tables (two-sample tests and their paired forms, variance,
normality and summary models, logistic, ordinal-logistic, GEE and linear
regression) with effect sizes and Benjamini-Hochberg adjusted p-values,
and the volcano plot. It stays numpy and scipy, as in the reference, so
the same inputs give the same bits on one machine.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import pandas as pd
from scipy import stats as sp_stats

_logger = logging.getLogger(__name__)


def _fdr_bh(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    p = np.asarray(pvals, float)
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    # enforce monotonicity from the largest p down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0, 1)
    return out


def _fit_logit_irls(X: np.ndarray, y: np.ndarray,
                    max_iter: int = 60, tol: float = 1e-9,
                    ridge: float = 1e-8):
    """Logistic regression via iteratively reweighted least squares.

    Python stand-in for R ``glm(..., family=binomial)`` (no statsmodels
    in this environment). Returns ``(beta, cov)`` with the model-based
    covariance ``(X'WX)^-1``; Wald z tests follow.
    """
    n, p = X.shape
    beta = np.zeros(p)
    H = np.eye(p)
    for _ in range(max_iter):
        eta = np.clip(X @ beta, -30, 30)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = np.maximum(mu * (1 - mu), 1e-10)
        z = eta + (y - mu) / w
        XtW = X.T * w
        H = XtW @ X + ridge * np.eye(p)
        new = np.linalg.solve(H, XtW @ z)
        if np.max(np.abs(new - beta)) < tol:
            beta = new
            break
        beta = new
    return beta, np.linalg.inv(H)


def _fit_gee_exchangeable(X: np.ndarray, y: np.ndarray,
                          clusters: np.ndarray,
                          max_iter: int = 50, tol: float = 1e-6):
    """Binomial-logit GEE with exchangeable working correlation.

    Python stand-in for R ``gee::gee(genos ~ ..., id, corstr=
    "exchangeable", family=binomial())`` (reference
    ``clrstats/R/clrstats.R:148``): moment estimate of the common
    within-cluster correlation from Pearson residuals, Fisher scoring on
    the working model, and the robust (sandwich) covariance for the
    reported z/p. Returns ``(beta, robust_cov)``.
    """
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    _, p = X.shape
    beta, _ = _fit_logit_irls(X, y)      # independence start
    uids = np.unique(clusters)
    groups = [np.nonzero(clusters == u)[0] for u in uids]

    for _ in range(max_iter):
        eta = np.clip(X @ beta, -30, 30)
        mu = 1.0 / (1.0 + np.exp(-eta))
        a = np.maximum(mu * (1 - mu), 1e-10)
        r = (y - mu) / np.sqrt(a)
        # exchangeable alpha: mean off-diagonal residual product
        num = 0.0
        den = 0.0
        for idx in groups:
            ri = r[idx]
            ni = len(ri)
            if ni < 2:
                continue
            num += (ri.sum() ** 2 - (ri ** 2).sum()) / 2.0
            den += ni * (ni - 1) / 2.0
        alpha = float(np.clip(num / den, -0.99, 0.99)) if den > 0 else 0.0

        U = np.zeros(p)
        H = np.zeros((p, p))
        M = np.zeros((p, p))
        for idx in groups:
            ni = len(idx)
            Xi = X[idx]
            ai = a[idx]
            Di = Xi * ai[:, None]                       # d mu / d beta
            R = np.full((ni, ni), alpha) + (1 - alpha) * np.eye(ni)
            As = np.sqrt(ai)
            Vi = (As[:, None] * R * As[None, :])
            Vinv = np.linalg.inv(Vi + 1e-12 * np.eye(ni))
            resid = y[idx] - mu[idx]
            DtV = Di.T @ Vinv
            U += DtV @ resid
            H += DtV @ Di
            s = DtV @ resid
            M += np.outer(s, s)
        step = np.linalg.solve(H + 1e-10 * np.eye(p), U)
        beta = beta + step
        if np.max(np.abs(step)) < tol:
            break
    Hinv = np.linalg.inv(H + 1e-10 * np.eye(p))
    return beta, Hinv @ M @ Hinv                        # sandwich


def _fit_gee_gaussian(X: np.ndarray, y: np.ndarray,
                      clusters: np.ndarray,
                      max_iter: int = 50, tol: float = 1e-8):
    """Gaussian-identity GEE with exchangeable working correlation.

    The continuous-measure counterpart of the binomial GEE (R
    ``gee(vals ~ ..., family=gaussian())``): generalized least squares
    under the moment-estimated exchangeable correlation, robust
    (sandwich) covariance. Returns ``(beta, robust_cov)``.
    """
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    _, p = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)   # independence start
    uids = np.unique(clusters)
    groups = [np.nonzero(clusters == u)[0] for u in uids]

    H = np.eye(p)
    M = np.zeros((p, p))
    for _ in range(max_iter):
        resid = y - X @ beta
        phi = max(float(np.mean(resid ** 2)), 1e-12)
        r = resid / np.sqrt(phi)
        num = den = 0.0
        for idx in groups:
            ri = r[idx]
            ni = len(ri)
            if ni < 2:
                continue
            num += (ri.sum() ** 2 - (ri ** 2).sum()) / 2.0
            den += ni * (ni - 1) / 2.0
        alpha = float(np.clip(num / den, -0.99, 0.99)) if den > 0 else 0.0

        U = np.zeros(p)
        H = np.zeros((p, p))
        M = np.zeros((p, p))
        for idx in groups:
            ni = len(idx)
            Xi = X[idx]
            R = np.full((ni, ni), alpha) + (1 - alpha) * np.eye(ni)
            Vinv = np.linalg.inv(phi * R + 1e-12 * np.eye(ni))
            DtV = Xi.T @ Vinv
            ri = resid[idx]
            U += DtV @ ri
            H += DtV @ Xi
            s = DtV @ ri
            M += np.outer(s, s)
        step = np.linalg.solve(H + 1e-10 * np.eye(p), U)
        beta = beta + step
        if np.max(np.abs(step)) < tol:
            break
    Hinv = np.linalg.inv(H + 1e-10 * np.eye(p))
    return beta, Hinv @ M @ Hinv


def _fit_ordinal_logit(X: np.ndarray, y_ord: np.ndarray, n_levels: int):
    """Proportional-odds ordinal logistic regression (R ``MASS::polr``).

    ``P(Y <= k | x) = sigmoid(theta_k - x @ beta)`` with ordered
    thresholds ``theta_1 < ... < theta_{K-1}``; ``X`` has NO intercept
    column (the thresholds absorb it, as in polr). Fit by BFGS on the
    exact negative log-likelihood; covariance from a finite-difference
    Hessian at the optimum (polr's ``Hess=TRUE``). Returns
    ``(beta, theta, cov_beta)``.
    """
    from scipy.optimize import minimize

    X = np.asarray(X, float)
    y = np.asarray(y_ord, int)
    n, p = X.shape
    k = n_levels

    def unpack(w):
        beta = w[:p]
        theta = np.cumsum(np.concatenate(
            [w[p:p + 1], np.exp(w[p + 1:])]))   # ordered thresholds
        return beta, theta

    def nll(w):
        beta, theta = unpack(w)
        eta = X @ beta
        # cumulative probs, padded with 0 and 1
        cum = np.concatenate([
            np.zeros((n, 1)),
            1.0 / (1.0 + np.exp(-(theta[None, :] - eta[:, None]))),
            np.ones((n, 1))], axis=1)
        probs = np.clip(cum[np.arange(n), y + 1]
                        - cum[np.arange(n), y], 1e-12, 1.0)
        return -np.sum(np.log(probs))

    # start: zero slopes, thresholds at the empirical logits
    cum_frac = np.clip(np.cumsum(np.bincount(y, minlength=k))[:-1] / n,
                       1e-3, 1 - 1e-3)
    th0 = np.log(cum_frac / (1 - cum_frac))
    w0 = np.concatenate([
        np.zeros(p), th0[:1],
        np.log(np.maximum(np.diff(th0), 1e-3))])
    res = minimize(nll, w0, method="BFGS",
                   options={"gtol": 1e-8, "maxiter": 500})
    beta, theta = unpack(res.x)

    # finite-difference Hessian in the NATURAL (beta, theta) space so
    # the Wald SEs match polr's Hessian-based ones
    def nll_nat(w):
        b = w[:p]
        th = w[p:]
        eta = X @ b
        cum = np.concatenate([
            np.zeros((n, 1)),
            1.0 / (1.0 + np.exp(-(th[None, :] - eta[:, None]))),
            np.ones((n, 1))], axis=1)
        probs = np.clip(cum[np.arange(n), y + 1]
                        - cum[np.arange(n), y], 1e-12, 1.0)
        return -np.sum(np.log(probs))

    w_nat = np.concatenate([beta, theta])
    m = len(w_nat)
    eps = 1e-4 * np.maximum(np.abs(w_nat), 1.0)
    hess = np.zeros((m, m))
    for i in range(m):
        for j in range(i, m):
            ei = np.zeros(m)
            ej = np.zeros(m)
            ei[i] = eps[i]
            ej[j] = eps[j]
            hess[i, j] = hess[j, i] = (
                nll_nat(w_nat + ei + ej) - nll_nat(w_nat + ei - ej)
                - nll_nat(w_nat - ei + ej) + nll_nat(w_nat - ei - ej)
            ) / (4 * eps[i] * eps[j])
    cov = np.linalg.inv(hess + 1e-10 * np.eye(m))
    return beta, theta, cov[:p, :p]


def _regression_stats(grp: pd.DataFrame, metric: str, cond_col: str,
                      conds, model: str, side_col: Optional[str],
                      sample_col: Optional[str],
                      gee_family: str = "binomial"):
    """Per-region regression models of the reference ``fitModel``
    (``clrstats/R/clrstats.R:92``): logit ``glm(genos ~ vals [* sides])``,
    linregr ``lm(vals ~ genos [* sides])``, gee ``gee(genos ~ vals *
    sides, id, exchangeable, binomial)`` (or the gaussian family,
    ``vals ~ genos``, for continuous measures), and ``logit.ord``
    (``MASS::polr(genos ~ vals * sides)`` on ALL ordered condition
    levels). Effect/p come from the ``vals`` (logit/gee/logit.ord) or
    ``genos`` (linregr/gaussian gee) coefficient, as the reference takes
    the first non-intercept row."""
    use_all_levels = model == "logit.ord"
    sub = (grp.dropna(subset=[metric]) if use_all_levels
           else grp[grp[cond_col].isin(conds)].dropna(subset=[metric]))
    if len(sub) < 4:
        return None
    vals = sub[metric].to_numpy(float)
    genos = (sub[cond_col] == conds[1]).to_numpy(float)
    if not use_all_levels and len(np.unique(genos)) < 2:
        return None
    sides = None
    if side_col and side_col in sub and sub[side_col].nunique() > 1:
        sides = (sub[side_col] == sorted(
            sub[side_col].unique())[1]).to_numpy(float)

    def design(x):
        cols = [np.ones_like(x), x]
        if sides is not None:
            cols += [sides, x * sides]
        return np.column_stack(cols)

    if model == "logit":
        X = design(vals)
        beta, cov = _fit_logit_irls(X, genos)
        est, se = beta[1], np.sqrt(max(cov[1, 1], 1e-300))
    elif model == "logit.ord":
        # polr scales the predictor and orders ALL condition levels
        # (kGenoLevels); the design drops the intercept column
        levels = sorted(sub[cond_col].unique(), key=str)
        if len(levels) < 2:
            return None
        y_ord = sub[cond_col].map(
            {lv: i for i, lv in enumerate(levels)}).to_numpy(int)
        sd = vals.std()
        vs = (vals - vals.mean()) / (sd if sd > 0 else 1.0)
        X = design(vs)[:, 1:]
        beta, _, cov = _fit_ordinal_logit(X, y_ord, len(levels))
        est, se = beta[0], np.sqrt(max(cov[0, 0], 1e-300))
    elif model == "gee":
        if sample_col and sample_col in sub:
            clusters = sub[sample_col].to_numpy()
        else:
            clusters = np.arange(len(sub))
        if gee_family == "gaussian":
            # continuous response: vals ~ genos under GLS + sandwich
            X = design(genos)
            beta, cov = _fit_gee_gaussian(X, vals, clusters)
        else:
            X = design(vals)
            beta, cov = _fit_gee_exchangeable(X, genos, clusters)
        est, se = beta[1], np.sqrt(max(cov[1, 1], 1e-300))
    elif model == "linregr":
        X = design(genos)
        beta, res, *_ = np.linalg.lstsq(X, vals, rcond=None)
        fitted = X @ beta
        dof = max(len(vals) - X.shape[1], 1)
        s2 = float(np.sum((vals - fitted) ** 2)) / dof
        cov = s2 * np.linalg.inv(X.T @ X + 1e-12 * np.eye(X.shape[1]))
        est, se = beta[1], np.sqrt(max(cov[1, 1], 1e-300))
        z = est / se
        # lm uses the t distribution
        return est, z, 2 * sp_stats.t.sf(abs(z), dof)
    else:
        raise ValueError(model)
    z = est / se
    return est, z, 2 * sp_stats.norm.sf(abs(z))


#: models handled by per-region regression instead of two-sample tests
_REGRESSION_MODELS = ("logit", "gee", "linregr", "logit.ord")

#: the full reference ``kModel`` vocabulary
#: (``clrstats/R/clrstats.R:21``); "mannwhitney" is this module's alias
#: for the reference's unpaired "wilcoxon" (R ``wilcox.test`` without
#: ``paired`` IS the Mann-Whitney U test)
KMODEL = ("logit", "linregr", "gee", "logit.ord", "ttest", "wilcoxon",
          "ttest.paired", "wilcoxon.paired", "fligner", "basic",
          "diff.mean", "shapiro")


def _paired_vals(grp: pd.DataFrame, metric: str, cond_col: str, conds,
                 sample_col: str):
    """Match values across the two conditions by sample (reference
    ``setupPairing``: sort by sample, split by condition, keep complete
    pairs). Returns ``(a, b)`` aligned arrays or ``None``."""
    if sample_col not in grp:
        return None
    wide = grp.pivot_table(
        index=sample_col, columns=cond_col, values=metric,
        aggfunc="mean")
    if not all(c in wide.columns for c in conds):
        # a region present in only one condition has no pairs; skip it
        # like other insufficient-data cases instead of KeyError-ing
        return None
    wide = wide.dropna(subset=list(conds))
    if len(wide) < 2:
        return None
    return wide[conds[0]].to_numpy(float), wide[conds[1]].to_numpy(float)


def _cohens_d(a: np.ndarray, b: np.ndarray, paired: bool) -> float:
    """Cohen's d (the reference's standardized t-test effect,
    ``effectsize::cohens_d``): pooled-SD for independent samples,
    SD-of-differences for paired."""
    if paired:
        d = b - a
        sd = d.std(ddof=1)
        return float(d.mean() / sd) if sd > 0 else np.nan
    na, nb = len(a), len(b)
    pooled = np.sqrt(((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1))
                     / max(na + nb - 2, 1))
    return float((b.mean() - a.mean()) / pooled) if pooled > 0 else np.nan


def _wilcoxon_std_effect(stat: float, p: float, n: int,
                         sign: float) -> float:
    """Standardized Wilcoxon effect ``z / sqrt(N)`` (reference
    ``rcompanion::wilcoxonZ``): recover |z| from the two-sided p, then
    restore the effect direction — ``norm.isf(p/2)`` is always
    non-negative, while the reference's z is signed."""
    z = sp_stats.norm.isf(max(min(p / 2, 0.5), 1e-300))
    s = np.sign(sign) if sign else 1.0
    return float(s * z / np.sqrt(max(n, 1)))


def meas_group_stats(
        df: pd.DataFrame, metric: str,
        cond_col: str = "Condition",
        region_col: str = "Region",
        conds: Optional[Sequence[str]] = None,
        model: str = "ttest",
        side_col: str = "Side",
        sample_col: str = "Sample",
        gee_family: str = "binomial") -> pd.DataFrame:
    """Per-region group comparison (the full reference ``kModel`` family,
    ``clrstats/R/clrstats.R:21``; names in :data:`KMODEL`).

    Two-sample tests: "ttest" / "wilcoxon" (= "mannwhitney") and their
    paired forms "ttest.paired" / "wilcoxon.paired" (matched by
    ``sample_col``); variance/normality/summary models "fligner",
    "shapiro", "basic", "diff.mean"; regression family "logit" /
    "logit.ord" / "gee" / "linregr" (reference ``fitModel``; GEE
    clusters on ``sample_col`` with exchangeable correlation and
    sandwich SEs — ``gee_family="gaussian"`` switches to the
    continuous-response identity-link form). Returns per-region effect
    (log2 fold "Effect" plus the reference's standardized "EffectStd"
    and raw "EffectRaw" where defined), p-value, and BH-adjusted p.
    """
    if conds is None:
        conds = list(pd.unique(df[cond_col]))[:2]
    paired = model in ("ttest.paired", "wilcoxon.paired")
    rows = []
    for region, grp in df.groupby(region_col):
        a = grp[grp[cond_col] == conds[0]][metric].dropna().to_numpy()
        b = grp[grp[cond_col] == conds[1]][metric].dropna().to_numpy()
        eff_std = eff_raw = None
        if model in ("shapiro", "basic"):
            # pooled over conditions (reference groups into one
            # condition for Shapiro-Wilk; basic is a summary row)
            pooled = grp[metric].dropna().to_numpy(float)
            if len(pooled) < 3:
                continue
            if model == "shapiro":
                stat, p = sp_stats.shapiro(pooled)
                eff_std = float(stat)        # the W statistic
            else:
                n = len(pooled)
                sem = pooled.std(ddof=1) / np.sqrt(n)
                ci = sp_stats.t.ppf(0.975, n - 1) * sem
                rows.append({
                    region_col: region, "N": n,
                    "MeanBase": float(pooled.mean()),
                    "MeanOther": float(pooled.mean()),
                    "Effect": float(pooled.mean()),
                    "CILow": float(pooled.mean() - ci),
                    "CIHigh": float(pooled.mean() + ci),
                    "Stat": np.nan, "P": np.nan})
                continue
            mean_a = mean_b = float(pooled.mean())
        elif model == "fligner":
            # variance homogeneity across ALL conditions
            groups = [g[metric].dropna().to_numpy(float)
                      for _, g in grp.groupby(cond_col)]
            groups = [g for g in groups if len(g) >= 2]
            if len(groups) < 2:
                continue
            stat, p = sp_stats.fligner(*groups)
            eff_std = float(stat)
            mean_a = a.mean() if len(a) else np.nan
            mean_b = b.mean() if len(b) else np.nan
        elif paired:
            pair = _paired_vals(grp, metric, cond_col, conds, sample_col)
            if pair is None:
                continue
            pa, pb = pair
            if model == "ttest.paired":
                stat, p = sp_stats.ttest_rel(pb, pa)
                eff_std = _cohens_d(pa, pb, paired=True)
            else:
                diffs = pb - pa
                if np.all(diffs == 0):
                    continue
                stat, p = sp_stats.wilcoxon(pb, pa)
                # direction from the signed-rank statistic vs its null
                # mean: T+ - n(n+1)/4 (scipy's two-sided statistic is
                # min(T+, T-), which carries no sign)
                nz = diffs[diffs != 0]
                t_plus = float(np.sum(
                    sp_stats.rankdata(np.abs(nz))[nz > 0]))
                eff_std = _wilcoxon_std_effect(
                    stat, p, len(pa),
                    t_plus - len(nz) * (len(nz) + 1) / 4.0)
            eff_raw = float(np.mean(pb - pa))
            mean_a, mean_b = pa.mean(), pb.mean()
        else:
            # logit.ord fits ALL ordered condition levels, so gate on
            # the model's own total-count check inside
            # ``_regression_stats`` rather than the two primary
            # conditions' sample counts
            if model != "logit.ord" and (len(a) < 2 or len(b) < 2):
                continue
            if model in _REGRESSION_MODELS:
                fit = _regression_stats(
                    grp, metric, cond_col, conds, model,
                    side_col, sample_col, gee_family)
                if fit is None:
                    continue
                effect, stat, p = fit
                rows.append({
                    region_col: region,
                    "MeanBase": a.mean() if len(a) else np.nan,
                    "MeanOther": b.mean() if len(b) else np.nan,
                    "Effect": effect,
                    "Stat": float(stat), "P": float(p)})
                continue
            if model == "ttest":
                stat, p = sp_stats.ttest_ind(b, a, equal_var=False)
                eff_std = _cohens_d(a, b, paired=False)
                eff_raw = float(b.mean() - a.mean())
            elif model in ("mannwhitney", "wilcoxon"):
                stat, p = sp_stats.mannwhitneyu(b, a)
                # U(b) above its null mean na*nb/2 means b tends larger
                eff_std = _wilcoxon_std_effect(
                    stat, p, min(len(a), len(b)),
                    float(stat) - len(a) * len(b) / 2.0)
                eff_raw = float(np.median(b) - np.median(a))
            elif model == "diff.mean":
                eff_raw = float(b.mean() - a.mean())
                stat, p = np.nan, np.nan
            else:
                raise ValueError(f"unknown model: {model}")
            mean_a, mean_b = a.mean(), b.mean()
        effect = np.log2(mean_b / mean_a) \
            if mean_a > 0 and mean_b > 0 else np.nan
        if model == "diff.mean":
            effect = eff_raw
        row = {
            region_col: region, "MeanBase": mean_a, "MeanOther": mean_b,
            "Effect": effect, "Stat": float(stat), "P": float(p)}
        if eff_std is not None:
            row["EffectStd"] = eff_std
        if eff_raw is not None:
            row["EffectRaw"] = eff_raw
        rows.append(row)
    out = pd.DataFrame(rows)
    if len(out) and out["P"].notna().any():
        padj = np.full(len(out), np.nan)
        mask = out["P"].notna().to_numpy()
        padj[mask] = _fdr_bh(out["P"].to_numpy()[mask])
        out["Padj"] = padj
    return out


def plot_volcano(
        df: pd.DataFrame, path: Optional[str] = None,
        p_col: str = "Padj", effect_col: str = "Effect",
        sig_thresh: float = 0.05, region_col: str = "Region"):
    """Volcano plot: effect vs -log10 p (reference volcano scripts)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from magellanmapper_torch.plot import plot_support

    fig, ax = plt.subplots(figsize=(6, 6))
    logp = -np.log10(np.clip(df[p_col], 1e-300, 1))
    sig = df[p_col] < sig_thresh
    ax.scatter(df.loc[~sig, effect_col], logp[~sig], s=12, c="gray")
    ax.scatter(df.loc[sig, effect_col], logp[sig], s=14, c="crimson")
    for _, row in df[sig].iterrows():
        ax.annotate(str(row[region_col]),
                    (row[effect_col], -np.log10(max(row[p_col], 1e-300))),
                    fontsize=6)
    ax.axhline(-np.log10(sig_thresh), ls="--", lw=0.8, c="k")
    ax.set_xlabel("log2 fold change")
    ax.set_ylabel("-log10 adjusted p")
    if path:
        plot_support.save_fig(fig, path)
    plt.close(fig)
    return fig
