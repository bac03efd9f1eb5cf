"""Univariate log-densities and quantile functions on torch tensors.

Counterpart of bcm3_tpu/distributions/univariate.py, holding the families
that `Prior.log_pdf` dispatches on, the quantile functions `Prior.sample`
needs and a gamma sampler that takes a `torch.Generator` (reference:
src/utils/ProbabilityDistributions.h:5-44 and
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


# candidates drawn per element and round of the gamma sampler: each is
# accepted with probability >= 0.95, so one round almost always settles
# every element and the loop's host check runs about once per call
_GAMMA_CANDIDATES = 4


def sample_standard_gamma(alpha, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws, one per element of `alpha` (any shape, > 0),
    from `generator` on its device; the dtype follows `alpha`.

    Marsaglia and Tsang's method (ACM TOMS 26(3), 2000): with d = a - 1/3,
    c = 1/sqrt(9d), x ~ N(0, 1) and v = (1 + c x)^3, d v is accepted when
    v > 0 and log u < x^2/2 + d - d v + d log v. Below shape 1 it draws at
    shape + 1 and multiplies by u^(1/alpha). torch's own gamma sampler
    cannot take a generator. Each round draws `_GAMMA_CANDIDATES`
    candidates for every element still pending and keeps the first one
    accepted; the loop ends when no element is pending."""
    alpha = torch.as_tensor(alpha)
    dev, dt = generator.device, alpha.dtype
    alpha = alpha.to(dev)
    boost = alpha < 1.0
    d = torch.where(boost, alpha + 1.0, alpha) - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.full_like(d, math.nan)
    pending = torch.ones_like(d, dtype=torch.bool)
    cand_shape = (_GAMMA_CANDIDATES, *d.shape)
    while True:
        x = torch.randn(cand_shape, generator=generator, dtype=dt, device=dev)
        u = torch.rand(cand_shape, generator=generator, dtype=dt, device=dev)
        v = (1.0 + c * x) ** 3
        pos = v > 0
        log_v = torch.log(torch.where(pos, v, 1.0))
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        first = ok.to(torch.uint8).argmax(dim=0, keepdim=True)
        take = pending & ok.any(dim=0)
        out = torch.where(take, (d * v).gather(0, first)[0], out)
        pending = pending & ~take
        if not bool(pending.any()):
            break
    u = torch.rand(d.shape, generator=generator, dtype=dt, device=dev)
    return torch.where(boost, out * u ** (1.0 / alpha), out)
