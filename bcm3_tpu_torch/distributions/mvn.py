"""Multivariate normal and Student-t densities on torch tensors.

Counterpart of bcm3_tpu/distributions/mvn.py (reference:
src/stats/mvn.h:5-8, src/stats/mvt.h:5-8). Densities are computed from a
lower Cholesky factor, with one triangular solve over the flattened batch
of points. `mean` and `chol` may be numpy arrays or tensors; they are
moved to the device and dtype of `x`.
"""

from __future__ import annotations

import math

import torch


def _like(a, x):
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def chol_logdet(chol):
    """Log-determinant of A from its lower Cholesky factor L (A = L L^T)."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)


def _solve_lower_batched(chol, dx):
    """L^{-1} dx for dx of shape (..., d) against a single (d, d) factor."""
    d = dx.shape[-1]
    flat = dx.reshape(-1, d)
    sol = torch.linalg.solve_triangular(chol, flat.T, upper=False)
    return sol.T.reshape(dx.shape)


def _maha(x, mean, chol):
    v = _solve_lower_batched(chol, x - mean)
    return (v * v).sum(dim=-1)


def logpdf_mvn_chol(x, mean, chol):
    """Log N(x; mean, L L^T) given the lower Cholesky factor `chol`.

    x: (..., d); mean: (d,); chol: (d, d). Returns (...)."""
    mean, chol = _like(mean, x), _like(chol, x)
    d = mean.shape[-1]
    return -0.5 * (_maha(x, mean, chol) + chol_logdet(chol) + d * math.log(2.0 * math.pi))


def logpdf_mvn(x, mean, cov):
    """Log multivariate normal density (reference: src/stats/mvn.cpp dmvnormal)."""
    return logpdf_mvn_chol(x, mean, torch.linalg.cholesky(_like(cov, x)))


def logpdf_mvt_chol(x, mean, chol, nu):
    """Log multivariate-t density from a lower Cholesky factor of the scale
    matrix; `nu` is a number or a 0-d tensor."""
    mean, chol, nu = _like(mean, x), _like(chol, x), _like(nu, x)
    d = mean.shape[-1]
    maha = _maha(x, mean, chol)
    return (
        torch.lgamma(0.5 * (nu + d))
        - torch.lgamma(0.5 * nu)
        - 0.5 * d * torch.log(nu * math.pi)
        - 0.5 * chol_logdet(chol)
        - 0.5 * (nu + d) * torch.log1p(maha / nu)
    )


def logpdf_mvt(x, mean, scale, nu):
    """Log multivariate-t density (reference: src/stats/mvt.cpp dmvt)."""
    return logpdf_mvt_chol(x, mean, torch.linalg.cholesky(_like(scale, x)), nu)
