"""Gaussian mixture model fitting on the host (numpy, float64).

Copied from the JAX package's bcm3_tpu/stats/gmm.py (numpy only). Split
of the reference GMM (reference: src/stats/GMM.cpp): fitting runs on the
host at the sampler's adaptation boundary, while *evaluation*
(responsibilities, densities, proposal draws) runs on the device — see
bcm3_tpu_torch/sampler/proposal.py. The batched EM that runs the same
fits on a torch device is bcm3_tpu_torch/stats/gmm_device.py.

Faithful to the reference algorithm:
- k-means++ initialization (GMM.cpp:188-246)
- EM with per-component Cholesky and convergence/retry logic (GMM.cpp:48-160)
- effective-sample-size-aware eigenvalue shrinkage of the correlation
  matrix, adapted from Dey & Srinivasan / Ledoit & Wolf (GMM.cpp:287-335)
- AIC with nparam = K*(D + D(D+1)/2) + K - 1 (GMM.cpp:155-158)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.linalg import solve_triangular

from bcm3_tpu_torch.stats.summary import effective_sample_size

_MAX_EM_STEPS = 100
_EM_RETRIES = 4
_LOGL_EPSILON = 1e-5

# component counts tried during adaptation
# (reference: ProposalGaussianMixture.cpp:160 num_components table)
COMPONENT_LADDER = (1, 2, 3, 4, 5, 8, 13)


@dataclass
class GMM:
    means: np.ndarray  # (K, D)
    covariances: np.ndarray  # (K, D, D)
    chols: np.ndarray  # (K, D, D) lower Cholesky factors
    weights: np.ndarray  # (K,)
    log_c: np.ndarray  # (K,) log normalization constants
    logl: float = np.nan
    aic: float = np.nan

    @property
    def num_components(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    @classmethod
    def from_params(cls, means, covariances, weights) -> Optional["GMM"]:
        """Build from explicit parameters (reference: GMM.cpp Set)."""
        means = np.atleast_2d(np.asarray(means, dtype=np.float64))
        covariances = np.asarray(covariances, dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        K, D = means.shape
        chols = np.empty_like(covariances)
        log_c = np.empty(K)
        for i in range(K):
            try:
                chols[i] = np.linalg.cholesky(covariances[i])
            except np.linalg.LinAlgError:
                return None
            log_c[i] = -np.sum(np.log(np.diag(chols[i]))) - 0.5 * D * np.log(2 * np.pi)
        return cls(means, covariances, chols, weights, log_c)

    def log_pdf(self, x: np.ndarray) -> np.ndarray:
        """Mixture log-density for points x: (..., D)."""
        comps = self.component_log_pdfs(x) + np.log(self.weights)
        m = comps.max(axis=-1, keepdims=True)
        return (m + np.log(np.sum(np.exp(comps - m), axis=-1, keepdims=True)))[..., 0]

    def component_log_pdfs(self, x: np.ndarray) -> np.ndarray:
        """Per-component log N(x; mu_k, Sigma_k): (..., K)."""
        x = np.asarray(x, dtype=np.float64)
        out = np.empty((*x.shape[:-1], self.num_components))
        for i in range(self.num_components):
            d = x - self.means[i]
            s = solve_triangular(self.chols[i], d[..., None], lower=True)[..., 0]
            out[..., i] = self.log_c[i] - 0.5 * np.sum(s * s, axis=-1)
        return out

    def responsibilities(self, x: np.ndarray) -> np.ndarray:
        lp = self.component_log_pdfs(x) + np.log(self.weights)
        lp -= lp.max(axis=-1, keepdims=True)
        p = np.exp(lp)
        return p / p.sum(axis=-1, keepdims=True)


def _weighted_mean_cov(
    samples: np.ndarray, resp: np.ndarray, ess_factor: float
) -> tuple[np.ndarray, np.ndarray]:
    """Weighted mean/covariance with ESS-aware eigenvalue shrinkage
    (reference: GMM.cpp CalculateMeanCovariance:248-336)."""
    D = samples.shape[1]
    w = np.where(resp >= np.finfo(np.float64).eps, resp, 0.0)
    wsum = w.sum()
    if wsum < 2.0:
        mean = samples.mean(axis=0) if len(samples) else np.zeros(D)
        return mean, np.eye(D)
    mean = (w[:, None] * samples).sum(axis=0) / wsum
    d = samples - mean
    cov = (w[:, None] * d).T @ d / (wsum - 1.0)

    # Regularization
    n_eff = wsum / ess_factor
    if n_eff < 2:
        return mean, np.diag(np.diag(cov))
    n_eff = max(n_eff, float(D))

    sd = np.sqrt(np.diag(cov))
    sd = np.where(sd > 0, sd, 1e-150)
    corr = cov / np.outer(sd, sd)
    np.fill_diagonal(corr, 1.0)

    # Eigenvalue shrinkage with effective sample size
    eigval, eigvec = np.linalg.eigh(corr)  # ascending, like Eigen
    shrunk = eigval.copy()
    n_eff_int = int(np.floor(n_eff))
    P = len(shrunk)
    for i in range(min(n_eff_int, P)):
        shrunk[P - 1 - i] *= n_eff / (n_eff + D + 1 - 2 * i)
    for i in range(n_eff_int, P):
        shrunk[P - 1 - i] = 0.0
    corr = (eigvec * shrunk) @ eigvec.T
    cov = corr * np.outer(sd, sd)
    cov[np.diag_indices_from(cov)] += 1e-8
    return mean, cov


def _chol_logc(cov: np.ndarray) -> tuple[Optional[np.ndarray], float]:
    try:
        L = np.linalg.cholesky(cov)
    except np.linalg.LinAlgError:
        return None, np.nan
    log_c = -np.sum(np.log(np.diag(L))) - 0.5 * cov.shape[0] * np.log(2 * np.pi)
    return L, log_c


def _kmeanspp(
    samples: np.ndarray, k: int, rng: np.random.Generator
) -> Optional[np.ndarray]:
    """k-means++ hard assignment (reference: GMM.cpp KMeanspp:188-246)."""
    n = len(samples)
    centers = np.empty((k, samples.shape[1]))
    used = set()
    ix = int(rng.integers(0, n))
    centers[0] = samples[ix]
    used.add(ix)
    for i in range(1, k):
        dist = np.full(n, 0.0)
        diffs = samples[:, None, :] - centers[None, :i, :]
        mindistsq = np.min(np.sum(diffs * diffs, axis=-1), axis=-1)
        mindistsq[list(used)] = 0.0
        total = mindistsq.sum()
        if total <= 0:
            return None
        newix = int(rng.choice(n, p=mindistsq / total))
        centers[i] = samples[newix]
        used.add(newix)
    # hard assignment to nearest center
    diffs = samples[:, None, :] - centers[None, :, :]
    assign = np.argmin(np.sum(diffs * diffs, axis=-1), axis=-1)
    resp = np.zeros((n, k))
    resp[np.arange(n), assign] = 1.0
    return resp


def fit_gmm(
    samples: np.ndarray,
    num_components: int,
    rng: np.random.Generator,
    ess_factor: float = 1.0,
) -> Optional[GMM]:
    """Fit a GMM by EM (reference: GMM.cpp Fit:48-160). Returns None on
    failure (singular covariance or not enough samples)."""
    samples = np.asarray(samples, dtype=np.float64)
    n, D = samples.shape

    if num_components == 1:
        resp = np.ones(n)
        mean, cov = _weighted_mean_cov(samples, resp, ess_factor)
        L, log_c = _chol_logc(cov)
        if L is None:
            return None
        d = samples - mean
        s = solve_triangular(L, d.T, lower=True)
        logl = float(np.sum(log_c - 0.5 * np.sum(s * s, axis=0)))
        gmm = GMM(
            mean[None, :], cov[None, :, :], L[None, :, :], np.ones(1), np.array([log_c])
        )
        nparam = D + D * (D + 1) // 2
        gmm.logl = logl
        gmm.aic = 2 * nparam - 2 * logl
        return gmm

    if n < 2.0 * D * num_components:
        # each component needs at least ~p samples for regularization
        return None

    K = num_components
    best = None
    for _retry in range(_EM_RETRIES):
        resp = _kmeanspp(samples, K, rng)
        if resp is None:
            return None
        means = np.empty((K, D))
        covs = np.empty((K, D, D))
        for i in range(K):
            means[i], covs[i] = _weighted_mean_cov(samples, resp[:, i], ess_factor)
        weights = np.full(K, 1.0 / K)

        singular = False
        converged = False
        prev_logl = -np.inf
        logl = -np.inf
        for _step in range(_MAX_EM_STEPS):
            # E-step (reference: GMM.cpp EM_expectation)
            chols = np.empty((K, D, D))
            log_cs = np.empty(K)
            comp_lp = np.empty((n, K))
            for i in range(K):
                L, log_c = _chol_logc(covs[i])
                if L is None:
                    singular = True
                    break
                chols[i], log_cs[i] = L, log_c
                s = solve_triangular(L, (samples - means[i]).T, lower=True)
                comp_lp[:, i] = log_c - 0.5 * np.sum(s * s, axis=0) + np.log(weights[i])
            if singular:
                break
            m = comp_lp.max(axis=1, keepdims=True)
            sample_logl = m[:, 0] + np.log(np.sum(np.exp(comp_lp - m), axis=1))
            logl = float(sample_logl.sum())
            resp = np.exp(comp_lp - sample_logl[:, None])
            zero_rows = resp.sum(axis=1) == 0
            resp[zero_rows] = 1.0 / K

            if logl < prev_logl:
                if prev_logl - logl < abs(logl * _LOGL_EPSILON * 10):
                    converged = True
                    break
                converged = False
                break
            elif logl - prev_logl < abs(logl * _LOGL_EPSILON):
                converged = True
                break
            prev_logl = logl

            # M-step (reference: GMM.cpp EM_maximization)
            for i in range(K):
                weights[i] = resp[:, i].sum() / n
                means[i], covs[i] = _weighted_mean_cov(samples, resp[:, i], ess_factor)

        if singular:
            continue
        best = (means, covs, weights, logl)
        if converged:
            break

    if best is None:
        return None
    means, covs, weights, logl = best
    gmm = GMM.from_params(means, covs, weights)
    if gmm is None:
        return None
    nparam = K * (D + D * (D + 1) // 2) + K - 1
    gmm.logl = logl
    gmm.aic = 2 * nparam - 2 * logl
    return gmm


def fit_gmm_best_aic(
    history: np.ndarray,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log=None,
) -> Optional[GMM]:
    """Fit GMMs over the component ladder, select lowest AIC with ESS gating
    (reference: ProposalGaussianMixture.cpp InitializeImpl:129-210)."""
    history = np.asarray(history, dtype=np.float64)
    n, D = history.shape
    if n < 2:
        return None

    ess = np.array([effective_sample_size(history[:, i]) for i in range(D)])
    min_ess = float(np.min(ess))
    if not np.isfinite(min_ess) or min_ess <= 0:
        min_ess = 1.0
    aic_adjust_factor = min_ess / n
    ess_factor = n / min_ess

    best_gmm = None
    best_aic = np.inf
    for k in COMPONENT_LADDER:
        if min_ess < k * (1 + min(D // 2, 10)):
            if log:
                log(f"GMM k={k}: not enough effective samples (min ESS {min_ess:.1f})")
            continue
        gmm = fit_gmm(history, k, rng, ess_factor)
        if gmm is None:
            if log:
                log(f"GMM k={k}: fit failed")
            continue
        nparam = 0.5 * gmm.aic + gmm.logl
        adjusted_aic = 2.0 * nparam - 2.0 * aic_adjust_factor * gmm.logl
        if log:
            log(f"GMM k={k}: AIC={gmm.aic:.6g}, adjusted AIC={adjusted_aic:.6g}")
        # quirk preserved from the reference: in adjusted mode the adjusted
        # AIC is compared against the stored *plain* AIC of the incumbent
        crit = adjusted_aic if select_with_adjusted_aic else gmm.aic
        if crit < best_aic:
            best_gmm = gmm
            best_aic = gmm.aic
    return best_gmm

