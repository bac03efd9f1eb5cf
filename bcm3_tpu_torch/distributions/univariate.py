"""Univariate densities, CDFs and quantile functions on torch tensors.

Counterpart of bcm3_tpu/distributions/univariate.py (reference:
src/utils/ProbabilityDistributions.h:5-44 and
src/sampler/UnivariateMarginal.cpp), plus a gamma sampler that takes a
`torch.Generator` and `betainc`, the regularized incomplete beta function
that torch lacks. Every function is elementwise and broadcasts; the
dtype and device follow the arguments, which are tensors.

Parameterizations follow the reference:
- exponential(lambda):   rate, pdf = lambda * exp(-lambda x)
- gamma(k, theta):       shape/scale
- beta(a, b):            standard on [0, 1]
- half_cauchy(scale):    x >= 0
- beta_prime(a, b, scale): scale * (x/(1-x)) with x ~ Beta(a, b)
- exponential_mix(lambda, lambda2, mix): mix * Exp(lambda) + (1-mix) * Exp(lambda2)
- student_t(x, mu, sigma, nu): location/scale t
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


# betainc's continued fraction: at most this many terms, convergence
# checked on the host every _BETAINC_CHECK terms
_BETAINC_MAX_TERMS = 512
_BETAINC_CHECK = 16


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b), by the modified Lentz method
    (Press et al., Numerical Recipes, 3rd ed., 6.4: `betacf`), batched:
    an element stops updating once its last factor is within the dtype's
    epsilon of 1, and the loop ends when every element has."""
    tiny = torch.finfo(x.dtype).tiny
    eps = torch.finfo(x.dtype).eps

    def guard(v):
        return torch.where(v.abs() < tiny, tiny, v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    done = torch.zeros_like(x, dtype=torch.bool)
    for m in range(1, _BETAINC_MAX_TERMS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = torch.where(done, h, h * d * c)
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        delta = d * c
        h = torch.where(done, h, h * delta)
        done = done | ((delta - 1.0).abs() <= eps)
        if m % _BETAINC_CHECK == 0 and bool(done.all()):
            break
    return h


def betainc(a, b, x):
    """Regularized incomplete beta function I_x(a, b) for a, b > 0 and x in
    [0, 1] (jax.scipy.special.betainc's contract; torch has none). The
    continued fraction converges fast for x < (a + 1) / (a + b + 2); above
    it the symmetry I_x(a, b) = 1 - I_{1-x}(b, a) is used. Use float64:
    the fraction is summed in the dtype of the arguments."""
    a, b, x = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (a, b, x)))
    inner = (x > 0) & (x < 1)
    xs = torch.where(inner, x, 0.5)
    swap = xs > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xs, xs)
    log_front = aa * torch.log(xx) + bb * torch.log1p(-xx) - _betaln(aa, bb)
    part = torch.exp(log_front) * _betacf(aa, bb, xx) / aa
    value = torch.where(swap, 1.0 - part, part)
    return torch.where(inner, value, torch.where(x >= 1, 1.0, 0.0))


# ---------------------------------------------------------------------------
# Normal


def logpdf_normal(x, mu, sigma):
    d = (x - mu) / sigma
    return -0.5 * d * d - torch.log(sigma) - _HALF_LOG_2PI


def pdf_normal(x, mu, sigma):
    return torch.exp(logpdf_normal(x, mu, sigma))


def _ndtr(z):
    """Standard normal CDF, accurate in both tails (erfc on the far side,
    as jax.scipy.special.ndtr computes it); torch.special.ndtr returns 0
    below about -8.3."""
    w = z * math.sqrt(0.5)
    a = w.abs()
    y = torch.where(
        a < math.sqrt(0.5),
        1.0 + torch.erf(w),
        torch.where(w > 0, 2.0 - torch.erfc(a), torch.erfc(a)),
    )
    return 0.5 * y


def cdf_normal(x, mu, sigma):
    return _ndtr((x - mu) / sigma)


def quantile_normal(p, mu, sigma):
    return mu + sigma * torch.special.ndtri(p)


# ---------------------------------------------------------------------------
# Uniform


def logpdf_uniform(x, lower, upper):
    inside = (x >= lower) & (x <= upper)
    return torch.where(inside, -torch.log(upper - lower), _NEG_INF)


def cdf_uniform(x, lower, upper):
    return torch.clamp((x - lower) / (upper - lower), 0.0, 1.0)


def quantile_uniform(p, lower, upper):
    return lower + p * (upper - lower)


# ---------------------------------------------------------------------------
# Exponential (rate lambda)


def logpdf_exponential(x, lam):
    return torch.where(x >= 0, torch.log(lam) - lam * x, _NEG_INF)


def cdf_exponential(x, lam):
    return torch.where(x >= 0, -torch.expm1(-lam * x), 0.0)


def quantile_exponential(p, lam):
    return -torch.log1p(-p) / lam


# ---------------------------------------------------------------------------
# Gamma (shape k, scale theta)


def logpdf_gamma(x, k, theta):
    valid = x > 0
    xs = torch.where(valid, x, 1.0)
    logp = (k - 1.0) * torch.log(xs) - xs / theta - torch.lgamma(k) - k * torch.log(theta)
    return torch.where(valid, logp, _NEG_INF)


def cdf_gamma(x, k, theta):
    return torch.where(x > 0, torch.special.gammainc(k, torch.clamp(x, min=0.0) / theta), 0.0)


# ---------------------------------------------------------------------------
# Beta


def logpdf_beta(x, a, b):
    valid = (x > 0) & (x < 1)
    xs = torch.where(valid, x, 0.5)
    logp = (a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs) - _betaln(a, b)
    return torch.where(valid, logp, _NEG_INF)


def cdf_beta(x, a, b):
    return betainc(a, b, torch.clamp(x, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Cauchy / half-Cauchy


def logpdf_cauchy(x, x0, scale):
    d = (x - x0) / scale
    return -torch.log(math.pi * scale * (1.0 + d * d))


def cdf_cauchy(x, x0, scale):
    return 0.5 + torch.arctan((x - x0) / scale) / math.pi


def logpdf_half_cauchy(x, scale):
    # reference: UnivariateMarginal.cpp:524-528
    logp = _LOG_2_OVER_PI - torch.log(scale + x * x / scale)
    return torch.where(x > 0, logp, _NEG_INF)


def cdf_half_cauchy(x, scale):
    return torch.where(x > 0, 2.0 * torch.arctan(x / scale) / math.pi, 0.0)


def quantile_half_cauchy(p, scale):
    return scale * torch.tan(0.5 * math.pi * p)


# ---------------------------------------------------------------------------
# Beta-prime (scaled)


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


def cdf_beta_prime(x, a, b, scale):
    z = torch.clamp(x, min=0.0) / scale
    return betainc(a, b, z / (1.0 + z))


# ---------------------------------------------------------------------------
# Exponential mixture


def logpdf_exponential_mix(x, lam, lam2, mix):
    lp1 = torch.log(mix) + logpdf_exponential(x, lam)
    lp2 = torch.log1p(-mix) + logpdf_exponential(x, lam2)
    return torch.logaddexp(lp1, lp2)


def cdf_exponential_mix(x, lam, lam2, mix):
    return mix * cdf_exponential(x, lam) + (1.0 - mix) * cdf_exponential(x, lam2)


# ---------------------------------------------------------------------------
# Student t (location/scale)


def logpdf_t(x, mu, sigma, nu):
    d = (x - mu) / sigma
    return (
        torch.lgamma(0.5 * (nu + 1.0))
        - torch.lgamma(0.5 * nu)
        - 0.5 * torch.log(nu * math.pi)
        - torch.log(sigma)
        - 0.5 * (nu + 1.0) * torch.log1p(d * d / nu)
    )


def cdf_t(x, mu, sigma, nu):
    d = (x - mu) / sigma
    z = nu / (nu + d * d)
    ib = 0.5 * betainc(0.5 * nu, torch.full_like(z, 0.5), z)
    return torch.where(d > 0, 1.0 - ib, ib)


def logpdf_truncated_t(x, mu, sigma, nu, lower, upper):
    lognorm = torch.log(cdf_t(upper, mu, sigma, nu) - cdf_t(lower, mu, sigma, nu))
    inside = (x >= lower) & (x <= upper)
    return torch.where(inside, logpdf_t(x, mu, sigma, nu) - lognorm, _NEG_INF)


# ---------------------------------------------------------------------------
# Truncated normal


def logpdf_truncated_normal(x, mu, sigma, lower, upper):
    lognorm = torch.log(cdf_normal(upper, mu, sigma) - cdf_normal(lower, mu, sigma))
    inside = (x >= lower) & (x <= upper)
    return torch.where(inside, logpdf_normal(x, mu, sigma) - lognorm, _NEG_INF)


# ---------------------------------------------------------------------------
# Generalized Pareto (reference: ProbabilityDistributions.h GPD entries)


def logpdf_gpd(x, mu, sigma, xi):
    z = (x - mu) / sigma
    # xi == 0 limit is the exponential; handle via where
    xi_safe = torch.where(xi == 0.0, 1.0, xi)
    logp_general = -(1.0 / xi_safe + 1.0) * torch.log1p(xi_safe * z) - torch.log(sigma)
    logp_exp = -z - torch.log(sigma)
    logp = torch.where(xi == 0.0, logp_exp, logp_general)
    support = (z >= 0) & ((xi >= 0) | (z <= -1.0 / xi_safe))
    return torch.where(support, logp, _NEG_INF)


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
