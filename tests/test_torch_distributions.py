"""The port's univariate and multivariate densities against the JAX package.

Every function of bcm3_tpu/distributions/univariate.py and mvn.py is
evaluated by both packages on the same float64 inputs, made from a seed
with numpy (points inside and outside each support, the GPD's xi == 0
branch and both signs of xi), and must agree to rtol 1e-10 with -inf at
the same places. The port's own regularized incomplete beta function is
held to jax.scipy.special.betainc on a grid of a, b in [0.5, 50] and x in
[0, 1] with 0, 1, 1e-12 and 1 - 1e-12 among the points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy import special as jsp

from bcm3_tpu.distributions import mvn as jmvn
from bcm3_tpu.distributions import univariate as juv
from bcm3_tpu_torch.distributions import mvn, univariate as uv

RTOL = 1e-10
N = 64


def _close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=1e-300)


def _args(rng, spec):
    """One float64 array of N per entry of spec: (low, high) uniform."""
    return [rng.uniform(lo, hi, N) for lo, hi in spec]


# name: (argument ranges); x ranges reach outside each support
_CASES = {
    "logpdf_normal": [(-4, 4), (-1, 1), (0.2, 3)],
    "pdf_normal": [(-4, 4), (-1, 1), (0.2, 3)],
    "cdf_normal": [(-4, 4), (-1, 1), (0.2, 3)],
    "quantile_normal": [(0.001, 0.999), (-1, 1), (0.2, 3)],
    "logpdf_uniform": [(-2, 3), (-1, 0), (1, 2)],
    "cdf_uniform": [(-2, 3), (-1, 0), (1, 2)],
    "quantile_uniform": [(0, 1), (-1, 0), (1, 2)],
    "logpdf_exponential": [(-1, 5), (0.1, 3)],
    "cdf_exponential": [(-1, 5), (0.1, 3)],
    "quantile_exponential": [(0, 0.999), (0.1, 3)],
    "logpdf_gamma": [(-1, 8), (0.5, 5), (0.3, 2)],
    "cdf_gamma": [(-1, 8), (0.5, 5), (0.3, 2)],
    "logpdf_beta": [(-0.2, 1.2), (0.5, 6), (0.5, 6)],
    "cdf_beta": [(-0.2, 1.2), (0.5, 6), (0.5, 6)],
    "logpdf_cauchy": [(-10, 10), (-1, 1), (0.2, 3)],
    "cdf_cauchy": [(-10, 10), (-1, 1), (0.2, 3)],
    "logpdf_half_cauchy": [(-1, 10), (0.2, 3)],
    "cdf_half_cauchy": [(-1, 10), (0.2, 3)],
    "quantile_half_cauchy": [(0, 0.99), (0.2, 3)],
    "logpdf_beta_prime": [(-1, 10), (0.5, 5), (0.5, 5), (0.5, 3)],
    "cdf_beta_prime": [(-1, 10), (0.5, 5), (0.5, 5), (0.5, 3)],
    "logpdf_exponential_mix": [(-1, 6), (0.1, 2), (2, 5), (0.05, 0.95)],
    "cdf_exponential_mix": [(-1, 6), (0.1, 2), (2, 5), (0.05, 0.95)],
    "logpdf_t": [(-8, 8), (-1, 1), (0.3, 3), (0.8, 30)],
    "cdf_t": [(-8, 8), (-1, 1), (0.3, 3), (0.8, 30)],
    "logpdf_truncated_t": [(-4, 4), (-1, 1), (0.3, 3), (0.8, 30), (-3, -1), (1, 3)],
    "logpdf_truncated_normal": [(-4, 4), (-1, 1), (0.3, 3), (-3, -1), (1, 3)],
    "logpdf_gpd": [(-1, 6), (-0.5, 0.5), (0.3, 2), (-0.6, 0.6)],
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_univariate_matches_jax(name):
    rng = np.random.default_rng(sorted(_CASES).index(name))
    args = _args(rng, _CASES[name])
    if name == "logpdf_gpd":
        args[3][::4] = 0.0  # the exponential (xi == 0) branch
    port = getattr(uv, name)(*(torch.as_tensor(a) for a in args))
    ref = getattr(juv, name)(*(jnp.asarray(a) for a in args))
    _close(port, ref)
    if name.startswith("logpdf_truncated") or name in ("logpdf_gpd", "logpdf_uniform"):
        assert np.isneginf(port.numpy()).any() and np.isfinite(port.numpy()).any()


def test_univariate_covers_the_jax_module():
    public = {n for n in dir(juv) if n.split("_")[0] in ("logpdf", "pdf", "cdf", "quantile")}
    assert public == set(_CASES)


def test_betainc_matches_jax_on_a_grid():
    ab = np.array([0.5, 0.9, 1.0, 2.5, 7.0, 20.0, 50.0])
    x = np.concatenate([[0.0, 1e-12, 1e-6, 1.0 - 1e-12, 1.0], np.linspace(0.01, 0.99, 25)])
    A, B, X = (g.ravel() for g in np.meshgrid(ab, ab, x, indexing="ij"))
    port = uv.betainc(torch.as_tensor(A), torch.as_tensor(B), torch.as_tensor(X)).numpy()
    ref = np.asarray(jsp.betainc(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)
    assert (port[X == 0.0] == 0.0).all() and (port[X == 1.0] == 1.0).all()


def test_betainc_random_points_match_jax():
    rng = np.random.default_rng(11)
    A, B = rng.uniform(0.5, 50.0, 2000), rng.uniform(0.5, 50.0, 2000)
    X = rng.uniform(0.0, 1.0, 2000)
    port = uv.betainc(torch.as_tensor(A), torch.as_tensor(B), torch.as_tensor(X)).numpy()
    ref = np.asarray(jsp.betainc(jnp.asarray(A), jnp.asarray(B), jnp.asarray(X)))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=1e-300)


def _spd(rng, d):
    m = rng.normal(size=(d, d))
    return m @ m.T + d * np.eye(d)


@pytest.mark.parametrize("d", [1, 3])
def test_mvn_and_mvt_match_jax(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(5, 7, d)) * 2.0  # batched over two leading axes
    mean, cov = rng.normal(size=d), _spd(rng, d)
    chol = np.linalg.cholesky(cov)
    tx = torch.as_tensor(x)
    _close(mvn.chol_logdet(torch.as_tensor(chol)), jmvn.chol_logdet(jnp.asarray(chol)))
    _close(mvn.logpdf_mvn(tx, mean, cov), jmvn.logpdf_mvn(jnp.asarray(x), mean, cov))
    _close(mvn.logpdf_mvn_chol(tx, mean, chol), jmvn.logpdf_mvn_chol(jnp.asarray(x), mean, chol))
    _close(mvn.logpdf_mvt(tx, mean, cov, 3.5), jmvn.logpdf_mvt(jnp.asarray(x), mean, cov, 3.5))
    _close(mvn.logpdf_mvt_chol(tx, mean, chol, 4.0),
           jmvn.logpdf_mvt_chol(jnp.asarray(x), mean, chol, 4.0))
