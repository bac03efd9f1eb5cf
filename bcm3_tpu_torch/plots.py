"""Posterior diagnostic plots — the R analysis plotting layer in Python.

Copied from the JAX package's bcm3_tpu/plots.py (numpy, scipy and
matplotlib; matplotlib imported only inside the drawing functions), over
the port's prior constants.

Equivalent of the reference's R plotting functions
(reference: R/plots_functions.r): trace plots (plot_trace:130-146,
plot_all_traces:95-114), marginal posterior densities with weighted
bound-reflected KDE and prior overlays
(plot_variable_distribution_impl:334-489, plot_all_densities:75-93),
bivariate posterior density heatmaps
(plot_bivariate_variable_distribution:264-318), posterior-predictive
bar/line plots (ppd_barplot:147-218, ppd_lineplot:220-262), and
proposal-adaptation GMM ellipse plots (examples/banana/plots.r:20-36).

All functions take the results dict from
:func:`bcm3_tpu_torch.io.output.load_results` (samples indexed
``[sample, temperature, variable]``) plus a :class:`bcm3_tpu_torch.model.prior.Prior`
where prior information is needed, and draw on a supplied matplotlib Axes
(or create one). Colors: categorical identities use the Okabe–Ito
colorblind-safe palette in fixed order; the bivariate heatmap uses
viridis like the reference (:296).

Deviation from the reference: bandwidth selection uses Silverman's rule
on the effective (weighted) sample size instead of R's ``h.select``
cross-validation — documented here because CV bandwidths are not
reproducible across R versions either.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from bcm3_tpu_torch.model.prior import (
    BETA,
    BETA_PRIME,
    DIRICHLET_MEMBER,
    EXPONENTIAL,
    EXPONENTIAL_MIX,
    GAMMA,
    HALF_CAUCHY,
    NORMAL,
    UNIFORM,
    Prior,
)

# Okabe–Ito colorblind-safe categorical order (fixed, never cycled)
PALETTE = ["#0072B2", "#D55E00", "#009E73", "#CC79A7", "#E69F00", "#56B4E9"]
PRIOR_COLOR = "#777777"
POSTERIOR_COLOR = PALETTE[0]
PREDICTIVE_COLOR = PALETTE[1]
DATA_COLOR = "#1A1A1A"


def _ax(ax=None):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.grid(True, alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    return ax


def _t1_samples(results, var_ix: int, sample_ix=None) -> np.ndarray:
    """T=1 chain samples for one variable."""
    s = results["samples"][:, -1, var_ix]
    if sample_ix is not None:
        s = s[np.asarray(sample_ix)]
    return s


def _weights(results, n: int, sample_ix=None) -> np.ndarray:
    w = results.get("weights")
    if w is None:
        return np.full(n, 1.0 / n)
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 2:  # (S, n_temperatures) from load_results: T=1 column
        w = w[:, -1]
    w = w.reshape(-1)
    if sample_ix is not None:
        w = w[np.asarray(sample_ix)]
    w = np.where(np.isfinite(w), w, 0.0)
    tot = w.sum()
    return w / tot if tot > 0 else np.full(n, 1.0 / n)


# ---------------------------------------------------------------------------
# Prior curves (reference: plot_variable_distribution_impl per-family branches)


def _prior_curve(prior: Prior, var_ix: int, smin: float, smax: float):
    """(x, pdf, lbound, ubound) for the prior overlay; bounds NaN if open.

    Mirrors the per-distribution range logic of
    plot_variable_distribution_impl:345-421."""
    from scipy import stats

    code = int(prior.dist_type[var_ix])
    a, b, c = (
        float(prior.p1[var_ix]),
        float(prior.p2[var_ix]),
        float(prior.p3[var_ix]),
    )
    lb, ub = np.nan, np.nan
    if code == NORMAL:
        lo = min(smin, stats.norm.ppf(0.01, a, b))
        hi = max(smax, stats.norm.ppf(0.99, a, b))
        x = np.linspace(lo, hi, 200)
        y = stats.norm.pdf(x, a, b)
    elif code == GAMMA:
        lo, hi = 0.0, max(smax, stats.gamma.ppf(0.99, a, scale=b))
        x = np.linspace(lo, hi, 200)
        y = stats.gamma.pdf(x, a, scale=b)
        lb = 0.0
    elif code == UNIFORM:
        x = np.linspace(a, b, 200)
        y = stats.uniform.pdf(x, a, b - a)
        lb, ub = a, b
    elif code == HALF_CAUCHY:
        hi = max(smax, stats.cauchy.ppf(0.95, 0.0, a))
        x = np.linspace(0.0, hi, 200)
        y = 2.0 * stats.cauchy.pdf(x, 0.0, a)
        lb = 0.0
    elif code == BETA:
        x = np.linspace(1e-6, 1 - 1e-6, 200)
        y = stats.beta.pdf(x, a, b)
        lb, ub = 0.0, 1.0
    elif code == EXPONENTIAL:
        hi = max(smax, stats.expon.ppf(0.99, scale=1.0 / a))
        x = np.linspace(0.0, hi, 200)
        y = stats.expon.pdf(x, scale=1.0 / a)
        lb = 0.0
    elif code == BETA_PRIME:
        x = np.linspace(0.0, max(smax, 1.0) * 1.5, 200)
        y = stats.betaprime.pdf(x / c, a, b) / c
        lb = 0.0
    elif code == EXPONENTIAL_MIX:
        hi = max(
            stats.expon.ppf(0.99, scale=1.0 / a),
            stats.expon.ppf(0.99, scale=1.0 / b),
        )
        x = np.linspace(0.0, hi, 200)
        y = c * stats.expon.pdf(x, scale=1.0 / a) + (1 - c) * stats.expon.pdf(
            x, scale=1.0 / b
        )
        lb = 0.0
    elif code == DIRICHLET_MEMBER:
        # reference uses a Beta(1, 9) placeholder (:404-410)
        x = np.linspace(1e-6, 1 - 1e-6, 200)
        y = stats.beta.pdf(x, 1.0, 9.0)
        lb, ub = 0.0, 1.0
    else:
        x = np.linspace(smin, smax, 200)
        y = np.zeros_like(x)
    return x, y, lb, ub


# ---------------------------------------------------------------------------
# Weighted reflected KDE (reference: plot_variable_distribution_impl:426-462)


def weighted_kde(
    samples: np.ndarray,
    weights: np.ndarray,
    grid: np.ndarray,
    lbound: float = np.nan,
    ubound: float = np.nan,
    adjust: float = 1.0,
) -> np.ndarray:
    """Gaussian KDE with weights and reflection at hard bounds.

    The reflection trick matches the reference (:437-452): samples are
    mirrored around each finite bound and the resulting density is scaled
    by the number of copies so mass near the bound is not lost.
    """
    samples = np.asarray(samples, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    # Silverman bandwidth on the effective sample size
    ess = 1.0 / np.sum(weights**2)
    mu = np.sum(weights * samples)
    sd = math.sqrt(max(np.sum(weights * (samples - mu) ** 2), 1e-300))
    bw = 1.06 * sd * ess ** (-1.0 / 5.0) * adjust
    bw = max(bw, 1e-12)

    xs = [samples]
    ws = [weights]
    factor = 1
    if np.isfinite(lbound):
        xs.append(lbound - (samples - lbound))
        ws.append(weights)
        factor += 1
    if np.isfinite(ubound):
        xs.append(ubound + (ubound - samples))
        ws.append(weights)
        factor += 1
    x = np.concatenate(xs)
    w = np.concatenate(ws)
    w = w / w.sum()

    z = (grid[:, None] - x[None, :]) / bw
    dens = (w[None, :] * np.exp(-0.5 * z * z)).sum(axis=1) / (
        bw * math.sqrt(2 * math.pi)
    )
    return dens * factor


def marginal_density(
    results,
    prior: Prior,
    var_ix: int,
    sample_ix=None,
    adjust: float = 1.0,
    ax=None,
):
    """Posterior marginal density with prior overlay
    (reference: plot_variable_distribution:54-73 + impl)."""
    ax = _ax(ax)
    s = _t1_samples(results, var_ix, sample_ix)
    w = _weights(results, len(s), sample_ix)
    px, py, lb, ub = _prior_curve(prior, var_ix, s.min(), s.max())
    lo = lb if np.isfinite(lb) else min(s.min(), px[0])
    hi = ub if np.isfinite(ub) else max(s.max(), px[-1])
    grid = np.linspace(lo, hi, 512)
    dens = weighted_kde(s, w, grid, lb, ub, adjust)
    ax.plot(px, py, color=PRIOR_COLOR, lw=2, label="prior")
    ax.plot(grid, dens, color=POSTERIOR_COLOR, lw=2, label="posterior")
    ax.set_title(results["variables"][var_ix])
    ax.set_ylabel("Probability density")
    ax.legend(frameon=False)
    return ax


def plot_variable_prior(prior: Prior, var_ix: int, ax=None):
    """Standalone prior density plot
    (reference: plot_variable_prior:116-128, plot_variable_prior_impl:489)."""
    ax = _ax(ax)
    lo = prior.lower[var_ix]
    hi = prior.upper[var_ix]
    smin = lo if np.isfinite(lo) else -1.0
    smax = hi if np.isfinite(hi) else 1.0
    px, py, _, _ = _prior_curve(prior, var_ix, smin, smax)
    ax.plot(px, py, color=PRIOR_COLOR, lw=2)
    ax.set_title(prior.varset.names[var_ix])
    ax.set_ylabel("Probability density")
    return ax


def trace_plot(
    results,
    var_ix: int,
    temperature_ix: int = -1,
    burnin_cutoff: Optional[int] = None,
    ax=None,
):
    """Sample trace for one variable (reference: plot_trace:130-146)."""
    ax = _ax(ax)
    y = results["samples"][:, temperature_ix, var_ix]
    ax.plot(
        np.arange(len(y)), y, ".", ms=2, color=POSTERIOR_COLOR, rasterized=True
    )
    if burnin_cutoff is None:
        burnin_cutoff = len(y) // 2
    ax.axvline(burnin_cutoff - 0.5, color=PRIOR_COLOR, ls="--", lw=1)
    ax.set_title(results["variables"][var_ix])
    ax.set_xlabel("sample")
    return ax


def _tile(n: int):
    ncol = math.ceil(math.sqrt(n))
    nrow = math.ceil(n / ncol)
    return nrow, ncol


def plot_all_traces(results, filename: str, burnin_cutoff: Optional[int] = None):
    """Tiled trace plots for every variable
    (reference: plot_all_traces:95-114, png_tile:584-590)."""
    import matplotlib.pyplot as plt

    n = len(results["variables"])
    nrow, ncol = _tile(n)
    fig, axes = plt.subplots(
        nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False
    )
    for i in range(n):
        trace_plot(results, i, burnin_cutoff=burnin_cutoff, ax=axes[i // ncol][i % ncol])
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].set_visible(False)
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def plot_all_densities(
    results, prior: Prior, filename: str, sample_ix=None
):
    """Tiled marginal densities (reference: plot_all_densities:75-93;
    default sample_ix = second half of the samples, :77-79)."""
    import matplotlib.pyplot as plt

    n = len(results["variables"])
    if sample_ix is None:
        S = results["samples"].shape[0]
        sample_ix = np.arange(S // 2, S)
    nrow, ncol = _tile(n)
    fig, axes = plt.subplots(
        nrow, ncol, figsize=(4 * ncol, 3 * nrow), squeeze=False
    )
    for i in range(n):
        marginal_density(
            results, prior, i, sample_ix=sample_ix, ax=axes[i // ncol][i % ncol]
        )
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].set_visible(False)
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)
    return filename


def bivariate_density(
    results,
    prior: Prior,
    var_ix1: int,
    var_ix2: int,
    sample_ix=None,
    gridsize: int = 20,
    hscale: float = 1.0,
    ax=None,
):
    """Bivariate posterior density heatmap on the prior-bound rectangle
    (reference: plot_bivariate_variable_distribution:264-318).

    Samples are mirrored around all four prior bounds (3x3 reflection
    grid, :282-288) and a Gaussian product kernel is evaluated on a
    gridsize x gridsize lattice; rendered with viridis like the
    reference (:296)."""
    ax = _ax(ax)
    ax.grid(False)
    s1 = _t1_samples(results, var_ix1, sample_ix)
    s2 = _t1_samples(results, var_ix2, sample_ix)
    xr = (float(prior.lower[var_ix1]), float(prior.upper[var_ix1]))
    yr = (float(prior.lower[var_ix2]), float(prior.upper[var_ix2]))
    if not np.isfinite(xr).all():
        xr = (s1.min(), s1.max())
    if not np.isfinite(yr).all():
        yr = (s2.min(), s2.max())

    xs = np.concatenate(
        [s1, xr[0] + (xr[0] - s1), xr[1] + (xr[1] - s1)] * 3
    )
    ys = np.concatenate(
        [
            np.tile(s2, 3),
            np.tile(yr[0] + (yr[0] - s2), 3),
            np.tile(yr[1] + (yr[1] - s2), 3),
        ]
    )
    # plug-in bandwidth (diagonal Silverman substitute for ks::Hpi) from
    # the un-mirrored samples; the 9 reflection copies scale the density
    # back up like weighted_kde's `factor`
    n = len(xs)
    n_data = len(s1)
    bx = 1.06 * max(np.std(s1), 1e-12) * n_data ** (-1 / 6) * hscale
    by = 1.06 * max(np.std(s2), 1e-12) * n_data ** (-1 / 6) * hscale
    gx = np.linspace(xr[0], xr[1], gridsize)
    gy = np.linspace(yr[0], yr[1], gridsize)
    zx = np.exp(-0.5 * ((gx[:, None] - xs[None, :]) / bx) ** 2)
    zy = np.exp(-0.5 * ((gy[:, None] - ys[None, :]) / by) ** 2)
    z = 9.0 * (zx @ zy.T) / (n * 2 * np.pi * bx * by)

    im = ax.imshow(
        z.T,
        origin="lower",
        extent=(xr[0], xr[1], yr[0], yr[1]),
        aspect="auto",
        cmap="viridis",
    )
    ax.figure.colorbar(im, ax=ax, label="Probability density")
    ax.set_xlabel(results["variables"][var_ix1])
    ax.set_ylabel(results["variables"][var_ix2])
    return ax


# ---------------------------------------------------------------------------
# Posterior predictive plots (reference: ppd_barplot:147-218, ppd_lineplot)


def _predictive_draws(rng, mean_samples, sd, error_model, ppdsamples):
    """Predictive draws under the four reference error models (:185-196)."""
    from scipy import stats

    m = np.repeat(np.asarray(mean_samples, dtype=np.float64), ppdsamples)
    s = np.broadcast_to(np.asarray(sd, dtype=np.float64), mean_samples.shape)
    s = np.repeat(s, ppdsamples)
    if error_model == "normal":
        return rng.normal(m, s)
    if error_model == "truncated_normal":
        a, b = (0.0 - m) / s, (1.0 - m) / s
        return stats.truncnorm.rvs(a, b, loc=m, scale=s, random_state=rng)
    if error_model == "t":
        return m + s * rng.standard_t(3, size=m.shape)
    if error_model == "truncated_t":
        lo = stats.t.cdf((0.0 - m) / s, 3)
        hi = stats.t.cdf((1.0 - m) / s, 3)
        u = rng.uniform(lo, hi)
        return m + s * stats.t.ppf(u, 3)
    raise ValueError(f"Unknown error model '{error_model}'")


def ppd_barplot(
    variable_samples: np.ndarray,
    data: np.ndarray,
    labels: Sequence[str],
    sd_samples=0.0,
    error_model: str = "t",
    bounds=(0.05, 0.95),
    ppdsamples: int = 20,
    seed: int = 0,
    ax=None,
):
    """Posterior-predictive interval bars with observed points overlaid
    (reference: ppd_barplot:147-218).

    variable_samples: (n_samples, n_conditions) posterior draws of the
    modeled mean per condition; data: observed values (n_conditions,) or
    (n_replicates, n_conditions)."""
    ax = _ax(ax)
    variable_samples = np.asarray(variable_samples)
    data = np.atleast_2d(np.asarray(data, dtype=np.float64))
    ncond = variable_samples.shape[1]
    if data.shape[1] != ncond:
        raise ValueError(
            "Number of columns of data and posterior samples should be the same"
        )
    lo_q, hi_q = sorted(bounds)
    rng = np.random.default_rng(seed)
    barwidth = 0.6
    for i in range(ncond):
        sd_i = (
            sd_samples[:, i]
            if np.ndim(sd_samples) == 2
            else (np.asarray(sd_samples) if np.ndim(sd_samples) == 1 else sd_samples)
        )
        pred = _predictive_draws(
            rng, variable_samples[:, i], sd_i, error_model, ppdsamples
        )
        ly, uy = np.nanquantile(pred, [lo_q, hi_q])
        iqr_l, iqr_u = np.nanquantile(pred, [0.25, 0.75])
        med = np.nanquantile(pred, 0.5)
        ax.bar(
            i,
            uy - ly,
            bottom=ly,
            width=barwidth,
            color=PREDICTIVE_COLOR,
            alpha=0.35,
            linewidth=0,
        )
        ax.bar(
            i,
            iqr_u - iqr_l,
            bottom=iqr_l,
            width=barwidth,
            color=PREDICTIVE_COLOR,
            alpha=0.55,
            linewidth=0,
        )
        ax.plot(
            [i - barwidth / 2, i + barwidth / 2],
            [med, med],
            color=PREDICTIVE_COLOR,
            lw=2,
        )
    for r in range(data.shape[0]):
        ax.plot(np.arange(ncond), data[r], "o", color=DATA_COLOR, ms=5)
    ax.set_xticks(np.arange(ncond))
    ax.set_xticklabels(labels, rotation=90)
    return ax


def ppd_lineplot(
    x_data,
    y_data,
    x_samples,
    y_samples,
    bounds=(0.05, 0.95),
    median_line: bool = True,
    ax=None,
):
    """Posterior-predictive quantile band over a trajectory
    (reference: ppd_lineplot:220-262).

    y_samples: (n_samples, n_points) modeled trajectories at x_samples."""
    ax = _ax(ax)
    y_samples = np.asarray(y_samples, dtype=np.float64)
    x_samples = np.asarray(x_samples, dtype=np.float64)
    lo_q, hi_q = sorted(bounds)
    ly = np.nanquantile(y_samples, lo_q, axis=0)
    my = np.nanquantile(y_samples, 0.5, axis=0)
    uy = np.nanquantile(y_samples, hi_q, axis=0)
    ok = ~np.isnan(my)
    ax.fill_between(
        x_samples[ok], ly[ok], uy[ok], color=PREDICTIVE_COLOR, alpha=0.35, lw=0
    )
    ax.plot(x_samples, ly, color=PREDICTIVE_COLOR, lw=1)
    ax.plot(x_samples, uy, color=PREDICTIVE_COLOR, lw=1)
    if median_line:
        ax.plot(x_samples[ok], my[ok], color=PREDICTIVE_COLOR, lw=2)
    if y_data is not None:
        y_data = np.atleast_2d(np.asarray(y_data, dtype=np.float64))
        for r in range(y_data.shape[0]):
            ax.plot(x_data, y_data[r], "o", color=DATA_COLOR, ms=5)
    return ax


# ---------------------------------------------------------------------------
# Proposal-adaptation introspection (reference: examples/banana/plots.r:20-36)


def _cov_ellipse(mean, cov, level=0.6, npoints=100):
    """Confidence ellipse boundary points (R ellipse::ellipse)."""
    from scipy import stats

    r = math.sqrt(stats.chi2.ppf(level, 2))
    theta = np.linspace(0, 2 * math.pi, npoints)
    circle = np.stack([np.cos(theta), np.sin(theta)], axis=1) * r
    L = np.linalg.cholesky(np.asarray(cov) + 1e-12 * np.eye(2))
    return np.asarray(mean)[None, :] + circle @ L.T


def adaptation_ellipse_plot(
    results,
    adaptation,
    adapt_key: str,
    block_key: str,
    var_ix1: int,
    var_ix2: int,
    level: float = 0.6,
    sample_ix=None,
    ax=None,
):
    """Scatter of two variables' samples with the adapted GMM components'
    covariance ellipses overlaid (reference: examples/banana/plots.r:20-36;
    adaptation groups written per SamplerPTChain.cpp:149-166).

    `adaptation` is the dict loaded from sampler_adaptation.nc
    (bcm3_tpu_torch.io.bundler.load_bundle)."""
    ax = _ax(ax)
    x = _t1_samples(results, var_ix1, sample_ix)
    y = _t1_samples(results, var_ix2, sample_ix)
    ax.plot(x, y, ".", ms=2, color="#AAAAAA", rasterized=True)
    group = adaptation[adapt_key][block_key]
    # means/covariances are over the block's variable subset; map the
    # requested variable indices to their position within the block
    block_vars = list(np.asarray(group["variable_indices"]))
    try:
        i1, i2 = block_vars.index(var_ix1), block_vars.index(var_ix2)
    except ValueError:
        raise ValueError(
            f"variables ({var_ix1}, {var_ix2}) are not both in block "
            f"{block_key} (variables {block_vars})"
        )
    ncl = sum(1 for k in group if k.endswith("_mean"))
    for ci in range(ncl):
        mean = np.asarray(group[f"cluster{ci}_mean"])[[i1, i2]]
        cov = np.asarray(group[f"cluster{ci}_covariance"])[
            np.ix_([i1, i2], [i1, i2])
        ]
        ell = _cov_ellipse(mean, cov, level)
        ax.plot(
            ell[:, 0],
            ell[:, 1],
            lw=2,
            color=PALETTE[ci % len(PALETTE)],
            # beyond the fixed palette the hues repeat; the ellipses then
            # show mixture *structure*, not nameable identities, so no
            # legend entry (categorical hues are never meaningfully cycled)
            label=f"component {ci}" if ci < len(PALETTE) else None,
        )
    ax.set_xlabel(results["variables"][var_ix1])
    ax.set_ylabel(results["variables"][var_ix2])
    if 1 < ncl <= len(PALETTE):
        ax.legend(frameon=False, fontsize=8)
    return ax
