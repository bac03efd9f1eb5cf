"""Posterior analysis: the Python equivalent of the reference R layer.

Copied from the JAX package's bcm3_tpu/analysis.py (numpy only), the
counterpart of the reference's R analysis scripts (reference: R/load.r,
R/stats.r, R/plots_functions.r). `load_results`
(bcm3_tpu_torch.io.output) reads the sample store; this module provides the
posterior summaries `R/stats.r` computes — per-variable mean / sd /
median / quantiles / lag-1 autocorrelation / decorrelation lag /
effective sample size (stats.r:8-121, 242-296), log-posterior and AIC
(load.r:62-80), and the thermodynamic-integration marginal likelihood
over the temperature ladder (stats.r marginal_likelihood:232-240).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bcm3_tpu_torch.io.output import load_results
from bcm3_tpu_torch.stats.summary import acf as _acf


def _default_sample_ix(S: int) -> np.ndarray:
    """Second half of the chain (reference: stats.r default sample_ix)."""
    return np.arange(S // 2, S)


def decorrelation_lag(x: np.ndarray, max_lag: Optional[int] = None) -> float:
    """First lag at which the autocorrelation drops below 1/e
    (reference: stats.r 'decorr_lag' via fitting; here the standard
    first-crossing estimate)."""
    n = len(x)
    if max_lag is None:
        max_lag = min(n - 1, 1000)
    mu = x.mean()
    var = x.var(ddof=1)
    if var <= 0 or not np.isfinite(var):
        return float("nan")
    for lag in range(1, max_lag):
        if _acf(x, lag, mu, var) < np.exp(-1.0):
            return float(lag)
    return float(max_lag)


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via initial positive sequence of autocorrelations
    (reference: stats.r 'ess' / coda-style)."""
    n = len(x)
    mu = x.mean()
    var = x.var(ddof=1)
    if var <= 0 or not np.isfinite(var):
        return float(n)
    s = 0.0
    for lag in range(1, n - 1):
        rho = _acf(x, lag, mu, var)
        if rho < 0.0:
            break
        s += rho
    return float(n / (1.0 + 2.0 * s))


def effective_sample_size_batched(x: np.ndarray) -> np.ndarray:
    """ESS per column of ``x`` (n, B) — the FFT-vectorized equivalent of
    ``effective_sample_size`` (same acf convention as stats/summary.py
    acf: mean of n-lag products over var(ddof=1), and the same
    initial-positive-sequence truncation). Used by chip_smoke.py, as the
    JAX package's bench.py uses its own, to compute ESS over thousands of
    ensemble chains at once."""
    x = np.asarray(x, dtype=np.float64)
    n, B = x.shape
    if n < 3:
        return np.full(B, float(n))
    d = x - x.mean(axis=0)
    var = x.var(axis=0, ddof=1)
    nfft = 1 << int(2 * n - 1).bit_length()
    f = np.fft.rfft(d, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real
    # acf(lag) = mean(d[:-lag] * d[lag:]) / var  ->  acov[lag]/(n-lag)/var
    counts = (n - np.arange(n))[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = acov / counts / var[None, :]
    rho[0] = 1.0
    # initial positive sequence: sum rho[1:] until the first negative
    neg = rho[1:] < 0.0
    first_neg = np.where(neg.any(axis=0), neg.argmax(axis=0), n - 1)
    mask = np.arange(1, n)[:, None] <= first_neg[None, :]
    s = np.where(mask, rho[1:], 0.0).sum(axis=0)
    ess = n / (1.0 + 2.0 * s)
    bad = ~np.isfinite(var) | (var <= 0)
    ess = np.where(bad, float(n), ess)
    return np.clip(ess, 1.0, float(n))


def variable_summary(
    results: Dict,
    temperature_ix: int = -1,
    sample_ix: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Per-variable posterior summary table
    (reference: stats.r variable_summary:100-121)."""
    samples = results["samples"]  # (S, C, D)
    S, C, D = samples.shape
    if sample_ix is None:
        sample_ix = _default_sample_ix(S)
    x = samples[sample_ix, temperature_ix, :]  # (n, D)
    out = {
        "variables": list(results.get("variables", range(D))),
        "mean": x.mean(axis=0),
        "sd": x.std(axis=0, ddof=1),
        "median": np.median(x, axis=0),
        "q025": np.quantile(x, 0.025, axis=0),
        "q975": np.quantile(x, 0.975, axis=0),
        "autocorrelation_lag1": np.array(
            [_acf(x[:, j], 1) for j in range(D)]
        ),
        "decorrelation_lag": np.array(
            [decorrelation_lag(x[:, j]) for j in range(D)]
        ),
        "ess": np.array([effective_sample_size(x[:, j]) for j in range(D)]),
    }
    return out


def log_posterior(results: Dict) -> np.ndarray:
    """lposterior[s, c] = lprior + T_c * llh (reference: load.r:62-70)."""
    temps = np.asarray(results["temperatures"])
    lp = results["log_prior"]
    ll = results["log_likelihood"]
    return lp + temps[None, :] * ll


def aic(results: Dict, sample_ix: Optional[np.ndarray] = None) -> float:
    """AIC from the best likelihood at T=1 (reference: load.r:72-80)."""
    ll = results["log_likelihood"][:, -1]
    S = len(ll)
    if sample_ix is None:
        sample_ix = _default_sample_ix(S)
    k = results["samples"].shape[2]
    return float(2 * k - 2 * np.nanmax(ll[sample_ix]))


def marginal_likelihood(
    results: Dict, sample_ix: Optional[np.ndarray] = None
) -> float:
    """Thermodynamic integration over the temperature ladder
    (reference: stats.r marginal_likelihood:232-240): trapezoid rule on
    the per-temperature mean log-likelihood; the T=0 (prior) chain is
    dropped if its mean is infinite."""
    ll = results["log_likelihood"]  # (S, C)
    temps = np.asarray(results["temperatures"])
    S = ll.shape[0]
    if sample_ix is None:
        sample_ix = _default_sample_ix(S)
    mean_ll = np.nanmean(ll[sample_ix, :], axis=0)
    if not np.isfinite(mean_ll[0]):
        return float(np.trapezoid(mean_ll[1:], temps[1:]))
    return float(np.trapezoid(mean_ll, temps))


def load_and_summarize(filename: str) -> Dict:
    """One-call analysis: load an output.nc and compute everything
    (python-side equivalent of bcm3.load.results + variable_summary)."""
    results = load_results(filename)
    return {
        "results": results,
        "summary": variable_summary(results),
        "log_posterior": log_posterior(results),
        "aic": aic(results),
        "marginal_likelihood": marginal_likelihood(results),
    }
