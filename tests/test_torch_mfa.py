"""The port's mixture-of-t-factor-analyzers fit (stats/mfa.py, numpy and
scipy in both packages) against the JAX package's: the same samples and
seed give the same fit, to rtol 1e-12, and leave the host RNG in the same
state."""

import numpy as np
import pytest

from bcm3_tpu.stats import mfa as jmfa
from bcm3_tpu_torch.stats import mfa as tmfa

RTOL = 1e-12


def _factor_data(seed, n=240, d=5, q=2):
    """Two components of a factor-analyzer mixture, t-distributed tails."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    B = rng.normal(size=(2, d, q))
    noise = 0.05 + 0.1 * rng.random(d)
    z = rng.normal(size=(n, q))
    x = np.einsum("ndq,nq->nd", B[labels], z) + rng.normal(size=(n, d)) * np.sqrt(noise)
    x /= np.sqrt(rng.chisquare(6.0, n) / 6.0)[:, None]
    return x + 5.0 * labels[:, None]


def test_factor_ladder_matches_jax():
    for d in (1, 2, 5, 10, 45):
        assert tmfa.factor_ladder(d) == jmfa.factor_ladder(d)


@pytest.mark.parametrize("g,q", [(1, 2), (2, 1)])
def test_fit_mtfa_matches_jax(g, q):
    x = _factor_data(1)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    ref = jmfa.fit_mtfa(x, g, q, jrng, n_kmeans=1, n_random=1, max_iter=40)
    got = tmfa.fit_mtfa(x, g, q, trng, n_kmeans=1, n_random=1, max_iter=40)
    assert ref is not None and got is not None
    for f in ("weights", "means", "loadings", "noise", "nu"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=RTOL, err_msg=f)
    assert got.bic == pytest.approx(ref.bic, rel=RTOL)
    np.testing.assert_allclose(got.covariances(), ref.covariances(), rtol=RTOL)
    assert jrng.bit_generator.state == trng.bit_generator.state


def test_fit_proposal_mtfa_matches_jax():
    """The whole fit_proposal.r procedure (grid over components and
    factors by BIC, against a full-covariance GMM) returns the same GMM."""
    x = _factor_data(2, n=100, d=3, q=1)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    ref = jmfa.fit_proposal_mtfa(x, jrng)
    got = tmfa.fit_proposal_mtfa(x, trng)
    assert got.num_components == ref.num_components
    for f in ("means", "covariances", "weights", "chols"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=RTOL, err_msg=f)
    assert jrng.bit_generator.state == trng.bit_generator.state
