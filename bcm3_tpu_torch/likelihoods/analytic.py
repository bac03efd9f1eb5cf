"""Analytic test likelihoods, batched over chains.

Counterpart of bcm3_tpu/likelihoods/analytic.py (reference:
src/likelihoods/TestLikelihood{Banana,Circular,MultimodalGaussians,
TruncatedT}.cpp, LikelihoodDummy.cpp). Each factory returns
``log_prob_batched(xs (B, D)) -> (B,)`` on the device and in the dtype of
`xs`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bcm3_tpu_torch.distributions import univariate as uv
from bcm3_tpu_torch.distributions.mvn import logpdf_mvn_chol, logpdf_mvt_chol


def _scalar(v, xs):
    return torch.tensor(v, dtype=xs.dtype, device=xs.device)


def make_banana(dim: int, sd1: float, sd2: float):
    """Banana-shaped density (reference: TestLikelihoodBanana.cpp:42-55).

    The first dim-1 coordinates are N(0, sd1); the last follows
    N(y + 3y + (1-y)^2, sd2), y the sum of the first dim-1 coordinates."""
    if dim < 2:
        raise ValueError("Banana dimension must be at least 2")

    def log_prob_batched(xs):
        s1, s2 = _scalar(sd1, xs), _scalar(sd2, xs)
        lead = uv.logpdf_normal(xs[:, : dim - 1], 0.0, s1).sum(dim=-1)
        y = xs[:, : dim - 1].sum(dim=-1)
        # the ridge mean exactly as the reference writes it
        ridge = uv.logpdf_normal(xs[:, dim - 1], y + 3.0 * y + (1.0 - y) ** 2, s2)
        return lead + ridge

    return log_prob_batched


def make_circular(dim: int, radius: float = 2.0, offset: float = 3.5, width: float = 0.1):
    """Two circular ridges (reference: TestLikelihoodCircular.cpp:43-53)."""
    mu1 = np.zeros(dim)
    mu2 = np.zeros(dim)
    mu1[0] = -offset
    mu2[0] = offset

    def log_prob_batched(xs):
        w = _scalar(width, xs)
        d1 = torch.linalg.vector_norm(xs - torch.as_tensor(mu1).to(xs), dim=-1)
        d2 = torch.linalg.vector_norm(xs - torch.as_tensor(mu2).to(xs), dim=-1)
        return torch.logaddexp(
            uv.logpdf_normal(d1, radius, w), uv.logpdf_normal(d2, radius, w)
        )

    return log_prob_batched


def make_multimodal_gaussians():
    """Fixed 2-D two-component mixture
    (reference: TestLikelihoodMultimodalGaussians.cpp:24-41)."""
    means = np.array([[-5.0, -5.0], [5.0, 5.0]])
    covs = np.array(
        [
            [[1.0, -0.9], [-0.9, 1.0]],
            [[2.0, -0.5], [-0.5, 1.0]],
        ]
    )
    chols = np.linalg.cholesky(covs)
    log_half = math.log(0.5)

    def log_prob_batched(xs):
        lp1 = log_half + logpdf_mvn_chol(xs, means[0], chols[0])
        lp2 = log_half + logpdf_mvn_chol(xs, means[1], chols[1])
        return torch.logaddexp(lp1, lp2)

    return log_prob_batched


def make_truncated_t(mus, sigmas, nus, weights):
    """Mixture of multivariate t densities
    (reference: TestLikelihoodTruncatedT.cpp:79-88). The truncation comes
    from the bounded prior, not from the density."""
    mus = np.asarray(mus, dtype=np.float64)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    nus = np.asarray(nus, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    weights = weights / weights.sum()
    chols = np.linalg.cholesky(sigmas)
    log_w = np.log(weights)

    def log_prob_batched(xs):
        lps = torch.stack(
            [
                log_w[i] + logpdf_mvt_chol(xs, mus[i], chols[i], nus[i])
                for i in range(len(nus))
            ]
        )
        return torch.logsumexp(lps, dim=0)

    return log_prob_batched


def make_dummy():
    """Trivial likelihood (reference: LikelihoodDummy.cpp): always 0."""

    def log_prob_batched(xs):
        return torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)

    return log_prob_batched
