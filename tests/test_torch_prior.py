"""Port prior (bcm3_tpu_torch.model.prior) against the JAX package.

Log-densities are compared in float64 at rtol 1e-12 on identical inputs
made with numpy; prior draws cannot match bit for bit (threefry vs
Philox), so their moments are held to the analytic ones, and the draws of
the port's gamma sampler and of the families built on it to scipy's laws
(moments and a KS test)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bcm3_tpu.distributions import univariate as juv
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu_torch.distributions import univariate as tuv
from bcm3_tpu_torch.likelihoods.poppk_synth import write_poppk_prior_xml
from bcm3_tpu_torch.model.prior import Prior

RTOL = 1e-12

MIXED_PRIOR = """<?xml version="1.0" encoding="utf-8"?>
<prior>
  <variable name="u" distribution="uniform" lower="-1.0" upper="2.0"/>
  <variable name="n" distribution="normal" mu="0.5" sigma="1.5" repeat="2"/>
  <variable name="e" distribution="exponential" lambda="2.0"/>
  <variable name="g" distribution="gamma" k="2.5" theta="0.7"/>
  <variable name="b" distribution="beta" a="2.0" b="3.0"/>
  <variable name="h" distribution="half_cauchy" scale="0.3"/>
  <variable name="bp" distribution="beta_prime" a="2.0" b="4.0" scale="1.5"/>
  <variable name="m" distribution="exponential_mix" lambda="1.0" lambda2="5.0" mix="0.3"/>
  <variable name="d0" multivariate="true" distribution="dirichlet" id="1" alpha="1.5"/>
  <variable name="d1" multivariate="true" distribution="dirichlet" id="1" alpha="2.0"/>
  <variable name="d2" multivariate="true" distribution="dirichlet" id="1" alpha="3.0"/>
</prior>
"""

SAMPLED_PRIOR = """<?xml version="1.0" encoding="utf-8"?>
<prior>
  <variable name="u" distribution="uniform" lower="-1.0" upper="2.0"/>
  <variable name="n" distribution="normal" mu="0.5" sigma="1.5"/>
  <variable name="e" distribution="exponential" lambda="2.0"/>
  <variable name="h" distribution="half_cauchy" scale="0.3"/>
  <variable name="m" distribution="exponential_mix" lambda="1.0" lambda2="5.0" mix="0.3"/>
</prior>
"""


def _write(tmp_path, text, name):
    path = os.path.join(tmp_path, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _both(path):
    return Prior.from_xml(path), JPrior.from_xml(path)


def _points(rng, prior, n):
    """Rows inside every variable's support (first half) and rows spread
    over and beyond it (second half)."""
    D = prior.num_variables
    x = rng.normal(0.5, 1.5, (n, D))
    lo, hi = prior.lower, prior.upper
    for i in range(D):
        if np.isfinite(lo[i]) and np.isfinite(hi[i]):
            x[: n // 2, i] = rng.uniform(lo[i], hi[i], n // 2)
        elif np.isfinite(lo[i]):
            x[: n // 2, i] = lo[i] + rng.exponential(1.0, n // 2)
    for blk in prior.dirichlet_blocks:
        # half the rows on the simplex, the rest off it
        s = slice(blk.start, blk.start + blk.size)
        w = rng.dirichlet(blk.alphas, n // 2)
        x[: n // 2, s] = w
    return x


_FAMILIES = [
    ("normal", lambda x, p: (x, p[0], np.abs(p[1]) + 0.1)),
    ("uniform", lambda x, p: (x, p[0] - 1.0, p[0] + 1.0)),
    ("exponential", lambda x, p: (x, np.abs(p[0]) + 0.1)),
    ("gamma", lambda x, p: (x, np.abs(p[0]) + 0.2, np.abs(p[1]) + 0.1)),
    ("beta", lambda x, p: (x, np.abs(p[0]) + 0.2, np.abs(p[1]) + 0.2)),
    ("half_cauchy", lambda x, p: (x, np.abs(p[0]) + 0.1)),
    ("beta_prime", lambda x, p: (x, np.abs(p[0]) + 0.2, np.abs(p[1]) + 0.2, np.abs(p[2]) + 0.5)),
    ("exponential_mix", lambda x, p: (x, np.abs(p[0]) + 0.1, np.abs(p[1]) + 0.1, 0.3 + 0.0 * p[2])),
]


@pytest.mark.parametrize("family,args", _FAMILIES, ids=[f for f, _ in _FAMILIES])
def test_univariate_logpdf_matches_jax(family, args):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 200), rng.exponential(2.0, 200)])
    p = rng.normal(0.0, 1.0, (3, 400))
    a = args(x, p)
    got = getattr(tuv, f"logpdf_{family}")(*(torch.as_tensor(v) for v in a)).numpy()
    ref = np.asarray(getattr(juv, f"logpdf_{family}")(*(jnp.asarray(v) for v in a)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("which", ["poppk_one", "poppk_transit", "mixed"])
def test_prior_log_pdf_matches_jax(tmp_path, which):
    if which == "mixed":
        path = _write(tmp_path, MIXED_PRIOR, "prior.xml")
    else:
        path = os.path.join(tmp_path, "prior.xml")
        write_poppk_prior_xml(path, 5, "one" if which == "poppk_one" else "one_transit")
    port, ref = _both(path)
    np.testing.assert_array_equal(port.dist_type, ref.dist_type)
    x = _points(np.random.default_rng(11), port, 64)
    got = port.log_pdf(torch.as_tensor(x)).numpy()
    want = np.asarray(ref.log_pdf(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).sum() >= 8
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(port.marginal_mean(), ref.marginal_mean(), rtol=RTOL)
    np.testing.assert_allclose(
        port.marginal_variance(), ref.marginal_variance(), rtol=RTOL
    )


def test_prior_log_pdf_float32_edges(tmp_path):
    """float32 at the edges of the uniform priors: the bounds themselves
    score finite, just outside scores -inf, and nothing is NaN."""
    path = os.path.join(tmp_path, "prior.xml")
    write_poppk_prior_xml(path, 4, "one")
    prior, ref = _both(path)
    uniform = np.isfinite(prior.upper)  # the half-Cauchy sds sit at 0.5
    lo = np.where(uniform, prior.lower, 0.5)
    hi = np.where(uniform, prior.upper, 0.5)
    x = torch.as_tensor(np.stack([lo, hi]), dtype=torch.float32)
    lp = prior.log_pdf(x)
    assert torch.isfinite(lp).all()
    outside = x.clone()
    outside[:, 0] = torch.tensor([-2.5, 1.5])  # mean_absorption in [-2, 1]
    assert torch.isneginf(prior.log_pdf(outside)).all()
    want = np.asarray(ref.log_pdf(jnp.asarray(x.numpy())))
    assert want.dtype == np.float32
    np.testing.assert_allclose(lp.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        lp.numpy(), prior.log_pdf(x.double()).numpy(), rtol=1e-6
    )


def test_prior_sample_moments(tmp_path):
    prior = Prior.from_xml(_write(tmp_path, SAMPLED_PRIOR, "prior.xml"))
    n = 200_000
    g = torch.Generator().manual_seed(1)
    x = prior.sample(g, (n,), torch.float64).numpy()
    assert x.shape == (n, 5)
    assert np.isfinite(prior.log_pdf(torch.as_tensor(x)).numpy()).all()
    mean, var = prior.marginal_mean(), prior.marginal_variance()
    for i in (0, 1, 2):  # half-Cauchy (3) has no finite moments
        se = np.sqrt(var[i] / n)
        assert abs(x[:, i].mean() - mean[i]) < 5 * se, i
        assert abs(x[:, i].var() - var[i]) < 0.03 * var[i], i
    # half-Cauchy: median = scale, and P(x < scale) = 1/2
    frac = (x[:, 3] < 0.3).mean()
    assert abs(frac - 0.5) < 5 * np.sqrt(0.25 / n)
    # exponential mixture: the analytic variance of the mixture
    # (marginal_variance keeps the reference's formula, which is not it)
    m = x[:, 4]
    mix_var = 0.3 * 2 / 1.0**2 + 0.7 * 2 / 5.0**2 - (0.3 / 1.0 + 0.7 / 5.0) ** 2
    assert abs(m.mean() - mean[4]) < 5 * np.sqrt(mix_var / n)
    assert abs(m.var() - mix_var) < 0.03 * mix_var
    # the same generator seed gives the same draws
    x2 = prior.sample(torch.Generator().manual_seed(1), (n,), torch.float64).numpy()
    np.testing.assert_array_equal(x, x2)


@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, 30.0])
def test_standard_gamma_sampler(alpha):
    """Gamma(alpha, 1) against scipy: mean and variance within 5 standard
    errors, and a KS test at p > 1e-3. Below shape 1 the sampler takes
    its boosted path."""
    n = 100_000
    g = torch.Generator().manual_seed(2)
    x = tuv.sample_standard_gamma(torch.full((n,), alpha, dtype=torch.float64), g).numpy()
    assert np.isfinite(x).all() and (x >= 0).all()
    assert abs(x.mean() - alpha) < 5 * np.sqrt(alpha / n)
    # var of the sample variance of a gamma: (mu4 - sigma^4) / n
    var_se = np.sqrt((6.0 * alpha + 2.0 * alpha * alpha) / n)
    assert abs(x.var() - alpha) < 5 * var_se
    assert st.kstest(x, "gamma", args=(alpha,)).pvalue > 1e-3
    again = tuv.sample_standard_gamma(
        torch.full((n,), alpha, dtype=torch.float64), torch.Generator().manual_seed(2)
    )
    np.testing.assert_array_equal(x, again.numpy())


@pytest.fixture(scope="module")
def mixed_draws(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("mixed"), MIXED_PRIOR, "prior.xml")
    prior = Prior.from_xml(path)
    x = prior.sample(torch.Generator().manual_seed(4), (50_000,), torch.float64)
    return prior, x.numpy()


# variable index -> the scipy law of its marginal (MIXED_PRIOR)
_MARGINALS = {
    "gamma": [(4, st.gamma(2.5, scale=0.7))],
    "beta": [(5, st.beta(2.0, 3.0))],
    "beta_prime": [(7, st.betaprime(2.0, 4.0, scale=1.5))],
    # a Dirichlet member is Beta(alpha_i, sum(alpha) - alpha_i)
    "dirichlet": [(9, st.beta(1.5, 5.0)), (10, st.beta(2.0, 4.5)), (11, st.beta(3.0, 3.5))],
}


@pytest.mark.parametrize("family", list(_MARGINALS))
def test_prior_sample_gamma_families(mixed_draws, family):
    """Draws of the families that need the gamma sampler against scipy's
    law of each marginal: the mean within 5 standard errors and a KS test
    at p > 1e-3. Every draw has a finite prior density; Dirichlet rows sum
    to 1."""
    prior, x = mixed_draws
    n = len(x)
    assert np.isfinite(prior.log_pdf(torch.as_tensor(x)).numpy()).all()
    for i, law in _MARGINALS[family]:
        col = x[:, i]
        assert abs(col.mean() - law.mean()) < 5 * law.std() / np.sqrt(n), (family, i)
        assert st.kstest(col, law.cdf).pvalue > 1e-3, (family, i)
    if family == "dirichlet":
        np.testing.assert_allclose(x[:, 9:12].sum(axis=1), 1.0, rtol=1e-12)
