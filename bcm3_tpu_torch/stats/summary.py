"""Summary statistics on the host (numpy).

Copied from the numpy part of the JAX package's bcm3_tpu/stats/summary.py
(reference: src/utils/SummaryStats.cpp). The autocorrelation convention
matches the reference: mean of lagged cross-products over (N - lag)
terms, normalized by the (n-1)-denominator sample variance.
"""

from __future__ import annotations

import numpy as np


def acf(x: np.ndarray, lag: int, mu=None, sigma_sq=None) -> float:
    """Autocorrelation at a lag (reference: SummaryStats.cpp acf)."""
    x = np.asarray(x, dtype=np.float64)
    if lag == 0:
        return 1.0
    if x.size <= lag:
        return float("nan")
    if mu is None:
        mu = x.mean()
    if sigma_sq is None:
        sigma_sq = x.var(ddof=1)
    d = x - mu
    r = np.mean(d[:-lag] * d[lag:])
    return float(r / sigma_sq)


def effective_sample_size(x: np.ndarray) -> float:
    """ESS via summed ACF, matching the reference's convention
    (reference: src/sampler/ProposalGaussianMixture.cpp:132-149):
    lags 1 .. max(5, 10*log10(N)) - 1, ess = N / (1 + 2*sum(acf))."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    mu = x.mean()
    sigma_sq = x.var(ddof=1)
    if sigma_sq <= 0 or not np.isfinite(sigma_sq):
        return float(n)
    lag_max = max(5, int(10 * np.log10(n))) if n > 1 else 1
    rho_t = 0.0
    d = x - mu
    for lag in range(1, lag_max):
        if n <= lag:
            break
        rho_t += np.mean(d[:-lag] * d[lag:]) / sigma_sq
    return float(n / (1.0 + 2.0 * rho_t))


def cov(samples: np.ndarray) -> np.ndarray:
    """Sample covariance, rows = observations (reference: SummaryStats cov)."""
    return np.cov(np.asarray(samples, dtype=np.float64), rowvar=False, ddof=1)


def cor(samples: np.ndarray) -> np.ndarray:
    """Sample correlation, rows = observations."""
    return np.corrcoef(np.asarray(samples, dtype=np.float64), rowvar=False)
