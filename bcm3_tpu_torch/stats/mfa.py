"""Mixture of (t-)factor analyzers proposal fitting.

Copied from the JAX package's bcm3_tpu/stats/mfa.py (numpy and scipy
only), for the `gaussian_mixture_fit_in_r` proposal type: the sampler fits
it on the host per ladder position at an adaptation boundary.

Replaces the reference's out-of-process R fitting service
(reference: src/sampler/ProposalGaussianMixtureFitInR.cpp:60-135 shells
out to R/fit_proposal.r, which fits EMMIXmfa::mtfa — a mixture of
t-factor-analyzers with per-component loadings ("sigma_type = unique")
and a common diagonal noise matrix ("D_type = common") — over a grid of
component counts {1,2,3,5,8} (filtered to k < sqrt(n)) and a Fibonacci
ladder of factor counts <= d-1, selects the minimum-BIC fit, and falls
back to an mclust full-covariance GMM when that has lower BIC).

This module reproduces those semantics in-process with numpy:

- `fit_mtfa`: AECM (alternating expectation/conditional maximization)
  for the mixture-of-t-factor-analyzers model
      x | component i  ~  t_{nu_i}(mu_i, B_i B_i' + D)
  following McLachlan, Peel & Bean (2003), with per-component degrees of
  freedom estimated by solving the standard one-dimensional M-step
  equation, and Woodbury-based density evaluation so the per-iteration
  cost is O(n d q) rather than O(n d^2) — the whole point of the factor
  parameterization in high dimensions.
- `fit_proposal_mtfa`: the full fit_proposal.r selection procedure,
  returning a `GMM` whose component covariances are B_i B_i' + D
  (R/fit_proposal.r:95-100) so the sampler's existing Gaussian-mixture
  proposal machinery consumes the fit unchanged. The mclust comparison
  uses this package's own full-covariance EM (bcm3_tpu_torch/stats/gmm.py)
  scored by BIC; R's mclust convention BIC = 2 logL - npar log n is
  negated to the minimization convention before comparing, matching
  `-max(mc$BIC) < minbic` in fit_proposal.r:79.

Why this exists at all: plain full-covariance GMM EM needs O(d^2)
samples per component and degenerates for the reference's
high-dimensional targets; the factor decomposition caps the covariance
parameter count at d(q+2) per component.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
from scipy.special import digamma, gammaln

from bcm3_tpu_torch.stats.gmm import GMM, fit_gmm

# component grid (R/fit_proposal.r:19) — filtered by k < sqrt(n) at fit time
MTFA_COMPONENTS = (1, 2, 3, 5, 8)

_NU_MIN, _NU_MAX = 0.5, 200.0
_D_FLOOR = 1e-12


def factor_ladder(d: int) -> List[int]:
    """Fibonacci ladder of factor counts <= d-1 (R/fit_proposal.r:22-30)."""
    if d <= 1:
        return [1]
    fib = [1, 1]
    for i in range(d):
        fib.append(fib[i] + fib[i + 1])
    out: List[int] = []
    for f in fib:
        if f <= d - 1 and f not in out:
            out.append(f)
    return out or [1]


@dataclass
class MTFAFit:
    weights: np.ndarray  # (g,)
    means: np.ndarray  # (g, d)
    loadings: np.ndarray  # (g, d, q)
    noise: np.ndarray  # (d,) common diagonal of D
    nu: np.ndarray  # (g,) per-component degrees of freedom
    logl: float
    bic: float

    @property
    def num_components(self) -> int:
        return len(self.weights)

    def covariances(self) -> np.ndarray:
        """Component covariances B_i B_i' + D (R/fit_proposal.r:99)."""
        g, d, _ = self.loadings.shape
        covs = np.einsum("gdq,geq->gde", self.loadings, self.loadings)
        covs[:, np.arange(d), np.arange(d)] += self.noise
        return covs


def _woodbury(B: np.ndarray, dinv: np.ndarray):
    """Inverse and log-determinant of B B' + D via the Woodbury identity.

    Returns (BtDi, core_inv, logdet) so Mahalanobis distances cost
    O(n d q):  Sigma^-1 v = D^-1 v - D^-1 B core^-1 B' D^-1 v
    with core = I_q + B' D^-1 B. The q x q core is inverted explicitly
    (q <= ~30, dominated elsewhere); Cholesky validates positivity.
    """
    q = B.shape[1]
    BtDi = B.T * dinv  # (q, d)
    core = np.eye(q) + BtDi @ B  # (q, q)
    L = np.linalg.cholesky(core)
    logdet = -np.sum(np.log(dinv)) + 2.0 * np.sum(np.log(np.diag(L)))
    core_inv = np.linalg.inv(core)
    return BtDi, core_inv, logdet


def _mahalanobis(x_mu: np.ndarray, dinv: np.ndarray, BtDi, core_inv) -> np.ndarray:
    """delta_j = (x_j-mu)' Sigma^-1 (x_j-mu) for rows of x_mu, O(n d q)."""
    w = x_mu * dinv  # (n, d) = D^-1 (x-mu)
    base = np.einsum("nd,nd->n", x_mu, w)
    t = BtDi @ x_mu.T  # (q, n)
    return base - np.einsum("qn,qn->n", t, core_inv @ t)


def _t_logpdf_terms(delta: np.ndarray, logdet: float, nu: float, d: int):
    """log t_nu(x; mu, Sigma) given Mahalanobis distances delta."""
    return (
        gammaln((nu + d) / 2.0)
        - gammaln(nu / 2.0)
        - 0.5 * d * math.log(nu * math.pi)
        - 0.5 * logdet
        - 0.5 * (nu + d) * np.log1p(delta / nu)
    )


def _solve_nu(rhs: float) -> float:
    """Solve log(nu/2) - digamma(nu/2) + rhs = 0 by bisection.

    The M-step dof equation of the t mixture (McLachlan & Peel eq. 7.28);
    the left side is decreasing in nu from +inf (nu->0) to 0 (nu->inf),
    so a root exists iff rhs < 0; otherwise clamp to _NU_MAX.
    """

    def f(nu):
        return math.log(nu / 2.0) - digamma(nu / 2.0) + rhs

    lo, hi = _NU_MIN, _NU_MAX
    if f(hi) > 0.0:
        return _NU_MAX
    if f(lo) < 0.0:
        return _NU_MIN
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _init_partition(x: np.ndarray, g: int, rng: np.random.Generator, kmeans: bool):
    """k-means or random-partition initialization (EMMIXmfa nkmeans/nrandom)."""
    n = len(x)
    if g == 1:
        return np.zeros(n, dtype=np.int64)
    if not kmeans:
        return rng.integers(0, g, size=n)
    # lightweight k-means++ with a few Lloyd steps
    centers = [x[rng.integers(0, n)]]
    for _ in range(g - 1):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centers], axis=0
        )
        tot = d2.sum()
        if not np.isfinite(tot) or tot <= 0:
            centers.append(x[rng.integers(0, n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / tot)])
    centers = np.asarray(centers)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(10):
        dist = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = dist.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for i in range(g):
            sel = x[labels == i]
            if len(sel):
                centers[i] = sel.mean(0)
    return labels


def _init_params(x: np.ndarray, labels: np.ndarray, g: int, q: int,
                 rng: np.random.Generator):
    """Per-cluster PCA initialization of (pi, mu, B, D)."""
    n, d = x.shape
    pis = np.empty(g)
    mus = np.empty((g, d))
    Bs = np.empty((g, d, q))
    resid = np.zeros(d)
    for i in range(g):
        sel = x[labels == i]
        if len(sel) < 2:
            sel = x
        pis[i] = max(len(x[labels == i]), 1) / n
        mus[i] = sel.mean(0)
        c = sel - mus[i]
        cov = c.T @ c / max(len(sel) - 1, 1)
        try:
            eigval, eigvec = np.linalg.eigh(cov)
        except np.linalg.LinAlgError:
            eigval = np.ones(d)
            eigvec = np.eye(d)
        eigval = np.maximum(eigval[::-1], 0.0)  # descending
        eigvec = eigvec[:, ::-1]
        noise_level = eigval[q:].mean() if d > q else 0.0
        lam = np.maximum(eigval[:q] - noise_level, 1e-6)
        Bs[i] = eigvec[:, :q] * np.sqrt(lam)
        resid += pis[i] * np.maximum(np.diag(cov) - (Bs[i] ** 2).sum(1), 0.0)
    scale = np.maximum(x.var(0), 1e-12)
    D = np.maximum(resid, 1e-4 * scale)
    nus = np.full(g, 10.0)
    pis /= pis.sum()
    return pis, mus, Bs, D, nus


def fit_mtfa(
    samples: np.ndarray,
    g: int,
    q: int,
    rng: np.random.Generator,
    tol: float = 1e-4,
    max_iter: int = 200,
    n_kmeans: int = 5,
    n_random: int = 5,
) -> Optional[MTFAFit]:
    """Fit one (g components, q factors) mixture of t-factor analyzers.

    Multiple k-means and random-partition starts, best final
    log-likelihood wins (EMMIXmfa mtfa nkmeans=5, nrandom=5,
    conv_measure='ratio', tol=1e-4 — R/fit_proposal.r:42).
    """
    x = np.asarray(samples, dtype=np.float64)
    n, d = x.shape
    if n < 2 or q > max(d - 1, 1) and d > 1:
        return None
    best: Optional[MTFAFit] = None
    starts = [(True, s) for s in range(n_kmeans)] + [
        (False, s) for s in range(n_random)
    ]
    for kmeans, _s in starts:
        fit = _fit_mtfa_single(x, g, q, rng, kmeans, tol, max_iter)
        if fit is not None and (best is None or fit.logl > best.logl):
            best = fit
    return best


def _estep(x, pis, mus, Bs, D, nus):
    """Responsibilities tau (n,g), weights u (n,g), loglik, per-comp pieces."""
    n, d = x.shape
    g = len(pis)
    dinv = 1.0 / D
    log_dens = np.empty((n, g))
    deltas = np.empty((n, g))
    wood = []
    for i in range(g):
        BtDi, core_inv, logdet = _woodbury(Bs[i], dinv)
        delta = _mahalanobis(x - mus[i], dinv, BtDi, core_inv)
        delta = np.maximum(delta, 0.0)
        deltas[:, i] = delta
        log_dens[:, i] = _t_logpdf_terms(delta, logdet, nus[i], d)
        wood.append((BtDi, core_inv, logdet))
    lw = log_dens + np.log(np.maximum(pis, 1e-300))
    m = lw.max(1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(lw - m).sum(1))
    tau = np.exp(lw - lse[:, None])
    u = (nus[None, :] + d) / (nus[None, :] + deltas)
    return tau, u, float(lse.sum()), deltas, wood


def _fit_mtfa_single(x, g, q, rng, kmeans, tol, max_iter):
    n, d = x.shape
    labels = _init_partition(x, g, rng, kmeans)
    pis, mus, Bs, D, nus = _init_params(x, labels, g, q, rng)
    scale_floor = np.maximum(x.var(0), 1e-12) * _D_FLOOR

    prev_logl = -np.inf
    logl = -np.inf
    for it in range(max_iter):
        # ---- AECM cycle 1: (pi, mu, nu) ----
        try:
            tau, u, logl, deltas, _ = _estep(x, pis, mus, Bs, D, nus)
        except np.linalg.LinAlgError:
            return None
        if not np.isfinite(logl):
            return None
        ni = tau.sum(0)  # (g,)
        if np.any(ni < 1e-8):
            return None
        pis = ni / n
        tu = tau * u
        mus = (tu.T @ x) / np.maximum(tu.sum(0)[:, None], 1e-300)
        # dof update (one-dimensional root, per component)
        for i in range(g):
            with np.errstate(divide="ignore"):
                term = (tau[:, i] * (np.log(u[:, i]) - u[:, i])).sum() / ni[i]
            rhs = (
                1.0
                + term
                + digamma((nus[i] + d) / 2.0)
                - math.log((nus[i] + d) / 2.0)
            )
            nus[i] = _solve_nu(rhs)

        # ---- AECM cycle 2: (B, D) ----
        try:
            tau, u, logl, deltas, wood = _estep(x, pis, mus, Bs, D, nus)
        except np.linalg.LinAlgError:
            return None
        ni = tau.sum(0)
        if np.any(ni < 1e-8):
            return None
        tu = tau * u
        dinv = 1.0 / D
        new_D = np.zeros(d)
        for i in range(g):
            xc = x - mus[i]
            w = tu[:, i]
            # weighted scatter S_i = sum_j tau u (x-mu)(x-mu)' / n_i
            Sw = (xc * w[:, None]).T @ xc / ni[i]
            # gamma_i = B' Sigma^-1 via Woodbury pieces
            BtDi, core_inv, _ = wood[i]
            gamma = BtDi - (BtDi @ Bs[i]) @ (core_inv @ BtDi)  # (q, d)
            SG = Sw @ gamma.T  # (d, q)
            inner = np.eye(q) - gamma @ Bs[i] + gamma @ SG  # (q, q)
            try:
                B_new = np.linalg.solve(inner.T, SG.T).T
            except np.linalg.LinAlgError:
                return None
            Bs[i] = B_new
            new_D += (ni[i] / n) * np.maximum(
                np.diag(Sw) - np.einsum("dq,qd->d", B_new, gamma @ Sw), 0.0
            )
        D = np.maximum(new_D, scale_floor)

        # ratio convergence (EMMIXmfa conv_measure='ratio')
        if np.isfinite(prev_logl) and abs(logl - prev_logl) < tol * abs(
            prev_logl if prev_logl != 0 else 1.0
        ):
            break
        prev_logl = logl

    try:
        _, _, logl, _, _ = _estep(x, pis, mus, Bs, D, nus)
    except np.linalg.LinAlgError:
        return None
    if not np.isfinite(logl):
        return None
    npar = (
        (g - 1)
        + g * d
        + g * (d * q - q * (q - 1) // 2)
        + d
        + g
    )
    bic = -2.0 * logl + npar * math.log(n)
    return MTFAFit(pis, mus, Bs, D.copy(), nus.copy(), logl, bic)


def fit_proposal_mtfa(
    samples: np.ndarray,
    rng: np.random.Generator,
    select_with_adjusted_aic: bool = False,
    log: Optional[Callable] = None,
) -> Optional[GMM]:
    """Full fit_proposal.r procedure, returning a sampler-ready GMM.

    Grid-search mtfa over components x factors by BIC, compare against a
    full-covariance GMM (mclust stand-in, scored with the same BIC
    convention), return the winner's Gaussian-mixture representation
    (mtfa covariances collapse to B B' + D: R/fit_proposal.r:95-100).
    `select_with_adjusted_aic` is accepted for fitter-signature
    compatibility and ignored — fit_proposal.r selects by BIC only.
    """
    x = np.asarray(samples, dtype=np.float64)
    n, d = x.shape
    if n < 2:
        return None

    comps = [k for k in MTFA_COMPONENTS if k < math.sqrt(n)] or [1]
    best_mtfa: Optional[MTFAFit] = None
    if d > 1:
        factors = factor_ladder(d)
        # grid scan with cheap settings, then refit the winning (g, q)
        # with the full EMMIXmfa-equivalent start schedule. Combinations
        # with more parameters than samples are skipped — they cannot win
        # the BIC and EMMIXmfa's try() swallows their failures anyway.
        best_gq = None
        best_scan_bic = np.inf
        for gc in comps:
            for q in factors:
                npar = (gc - 1) + gc * d + gc * (d * q - q * (q - 1) // 2) + d + gc
                if npar > n:
                    continue
                fit = fit_mtfa(x, gc, q, rng, n_kmeans=1, n_random=1,
                               max_iter=60)
                if fit is not None and fit.bic < best_scan_bic:
                    best_scan_bic = fit.bic
                    best_gq = (gc, q)
                    best_mtfa = fit
        if best_gq is not None:
            refit = fit_mtfa(x, best_gq[0], best_gq[1], rng,
                             n_kmeans=3, n_random=2)
            if refit is not None and refit.bic < best_mtfa.bic:
                best_mtfa = refit
        if log and best_mtfa is not None:
            log(
                "mtfa best fit: g=%d q=%d BIC=%.1f nu=%s",
                best_mtfa.num_components,
                best_mtfa.loadings.shape[2],
                best_mtfa.bic,
                np.round(best_mtfa.nu, 1),
            )

    # mclust stand-in: full-covariance GMM over the same component grid,
    # compared on BIC (fit_proposal.r:62,79)
    best_gmm: Optional[GMM] = None
    best_gmm_bic = np.inf
    for gc in comps:
        fit = fit_gmm(x, gc, rng)
        if fit is None or not np.isfinite(fit.logl):
            continue
        npar = gc * (d + d * (d + 1) // 2) + gc - 1
        bic = -2.0 * fit.logl + npar * math.log(n)
        if bic < best_gmm_bic:
            best_gmm_bic = bic
            best_gmm = fit

    mtfa_bic = best_mtfa.bic if best_mtfa is not None else np.inf
    if best_gmm is not None and best_gmm_bic < mtfa_bic:
        if log:
            log("fit_in_r: using full-covariance GMM fit (BIC %.1f < %.1f)",
                best_gmm_bic, mtfa_bic)
        return best_gmm
    if best_mtfa is None:
        return best_gmm
    if log:
        log("fit_in_r: using mtfa fit (BIC %.1f <= %.1f)", mtfa_bic,
            best_gmm_bic)
    gmm = GMM.from_params(
        best_mtfa.means, best_mtfa.covariances(), best_mtfa.weights
    )
    if gmm is None:
        # numerically non-PSD after collapse: jitter the diagonal
        covs = best_mtfa.covariances()
        covs[:, np.arange(d), np.arange(d)] += 1e-8 + 1e-6 * np.abs(
            covs[:, np.arange(d), np.arange(d)]
        ).max()
        gmm = GMM.from_params(best_mtfa.means, covs, best_mtfa.weights)
    return gmm if gmm is not None else best_gmm
