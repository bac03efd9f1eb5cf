"""Univariate log-densities and quantile functions on torch tensors.

Counterpart of bcm3_tpu/distributions/univariate.py, holding the families
that `Prior.log_pdf` dispatches on and the quantile functions `Prior.sample`
needs (reference: src/utils/ProbabilityDistributions.h:5-44 and
src/sampler/UnivariateMarginal.cpp). Every function is elementwise and
broadcasts; the dtype and device follow the arguments.

Parameterizations follow the reference:
- exponential(lambda):   rate, pdf = lambda * exp(-lambda x)
- gamma(k, theta):       shape/scale
- beta(a, b):            standard on [0, 1]
- half_cauchy(scale):    x >= 0
- beta_prime(a, b, scale): scale * (x/(1-x)) with x ~ Beta(a, b)
- exponential_mix(lambda, lambda2, mix): mix * Exp(lambda) + (1-mix) * Exp(lambda2)
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -math.inf

# log(2) - log(pi), used by the half-Cauchy log-pdf
_LOG_2_OVER_PI = -0.4515827052894548647
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def logpdf_normal(x, mu, sigma):
    d = (x - mu) / sigma
    return -0.5 * d * d - torch.log(sigma) - _HALF_LOG_2PI


def logpdf_uniform(x, lower, upper):
    inside = (x >= lower) & (x <= upper)
    return torch.where(inside, -torch.log(upper - lower), _NEG_INF)


def quantile_uniform(p, lower, upper):
    return lower + p * (upper - lower)


def logpdf_exponential(x, lam):
    return torch.where(x >= 0, torch.log(lam) - lam * x, _NEG_INF)


def quantile_exponential(p, lam):
    return -torch.log1p(-p) / lam


def logpdf_gamma(x, k, theta):
    valid = x > 0
    xs = torch.where(valid, x, 1.0)
    logp = (k - 1.0) * torch.log(xs) - xs / theta - torch.lgamma(k) - k * torch.log(theta)
    return torch.where(valid, logp, _NEG_INF)


def logpdf_beta(x, a, b):
    valid = (x > 0) & (x < 1)
    xs = torch.where(valid, x, 0.5)
    logp = (a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs) - _betaln(a, b)
    return torch.where(valid, logp, _NEG_INF)


def logpdf_half_cauchy(x, scale):
    # reference: UnivariateMarginal.cpp:524-528
    logp = _LOG_2_OVER_PI - torch.log(scale + x * x / scale)
    return torch.where(x > 0, logp, _NEG_INF)


def quantile_half_cauchy(p, scale):
    return scale * torch.tan(0.5 * math.pi * p)


def logpdf_beta_prime(x, a, b, scale):
    valid = x > 0
    z = torch.where(valid, x, 1.0) / scale
    logp = (
        (a - 1.0) * torch.log(z)
        - (a + b) * torch.log1p(z)
        - _betaln(a, b)
        - torch.log(scale)
    )
    return torch.where(valid, logp, _NEG_INF)


def logpdf_exponential_mix(x, lam, lam2, mix):
    lp1 = torch.log(mix) + logpdf_exponential(x, lam)
    lp2 = torch.log1p(-mix) + logpdf_exponential(x, lam2)
    return torch.logaddexp(lp1, lp2)
