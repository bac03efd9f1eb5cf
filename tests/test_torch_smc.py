"""The port's SMC against the JAX package's and against quadrature, on the CPU.

- One stage on the banana fixture (256 particles, float64; the
  population's likelihood through `log_prob_batched`, the JAX package's
  through vmap(log_prob)), given the JAX package's draws (its splits,
  bcm3_tpu/sampler/smc.py:127-160): the beta found by the bisection
  (equal to the JAX package's `_find_beta`), the log evidence's
  increment, the systematic resampling's indices and one random-walk
  sweep. The JAX sampler run for one stage and one sweep gives the
  particles, their log-likelihoods and the log evidence after it, which
  the port's stage equals to 1e-10.
- Whole runs on the banana fixture: 32 independent populations of 8,192
  particles (seeds 1-32), their means, sds and log evidences against the
  quadrature over the prior box (mean (-0.26568, 3.34495), sd (1.67843,
  3.80070), log Z -5.385663, the trapezoid rule on 1201 x 2401 points),
  each within 4 standard errors of the mean over the populations.
  The sampler reflects its proposals on the prior's bounds, as the JAX
  package's does (bcm3_tpu/sampler/smc.py:110-115). With the random walk's
  correlated covariance the reflection does not leave the posterior
  invariant (ROADMAP C): the test asserts that fault (after 20 sweeps a
  stage, 8 populations' x1 sd lies more than 4 standard errors below the
  oracle) and
  holds the rest of the algorithm to the oracle with proposals outside the
  box rejected instead of reflected (a test-side change: `reflect_on_bounds`
  replaced by the identity, so that the prior's -inf rejects them).
"""

import os

import jax
import numpy as np
import pytest
import torch

from bcm3_tpu.sampler.smc import SamplerSMC as JSamplerSMC
from bcm3_tpu.sampler.smc import SMCConfig as JSMCConfig
from bcm3_tpu_torch.sampler import SamplerSMC, SMCConfig
from bcm3_tpu_torch.sampler import smc
from test_torch_hmc import BANANA_MEAN, BANANA_SD, FIXTURES, models

BANANA_LOG_Z = -5.385663


def test_stage_matches_jax():
    (prior, lik), (jprior, jlik) = models(os.path.join(FIXTURES, "banana"))
    N, D, seed = 256, prior.num_variables, 9
    ref = JSamplerSMC(jprior, jlik, JSMCConfig(num_particles=N, mutation_steps=1, max_stages=1,
                                               seed=seed)).run()
    # the JAX sampler's draws, by its splits
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    x0 = np.asarray(jprior.sample(sub, (N,)))
    key, sub = jax.random.split(key)
    u = float(jax.random.uniform(sub))
    key, sub = jax.random.split(key)
    kz, ku = jax.random.split(sub)
    normal = np.asarray(jax.random.normal(kz, (N, D)))
    uniform = np.asarray(jax.random.uniform(ku, (N,)))

    s = SamplerSMC(prior, lik, SMCConfig(num_particles=N, device="cpu"))
    x = torch.as_tensor(x0)
    llh = s.log_likelihood(x)
    llh_host = llh.numpy()
    beta = smc.find_beta(llh_host, 0.0, 0.5)
    assert 0.0 < beta < 1.0 and beta == JSamplerSMC(
        jprior, jlik, JSMCConfig(num_particles=N))._find_beta(llh_host, 0.0)
    inc, w = smc.reweight(llh_host, 0.0, beta)
    np.testing.assert_allclose(inc, ref["log_marginal_likelihood"], rtol=1e-10)
    idx = smc.systematic_resample(w, u)
    # the JAX package's resampling written out (smc.py:140-142)
    np.testing.assert_array_equal(
        idx, np.clip(np.searchsorted(np.cumsum(w), u / N + np.arange(N) / N), 0, N - 1))
    assert len(np.unique(idx)) < N  # the weights did select
    x, llh = x[idx], llh[torch.as_tensor(idx)]
    x, llh, lprior, acc = s.mutate(x, llh, prior.log_pdf(x), beta, s.scaled_cholesky(x),
                                   torch.as_tensor(normal), torch.as_tensor(uniform))
    assert 0.0 < float(acc) < 1.0
    np.testing.assert_allclose(x.numpy(), ref["samples"][:, 0, :], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(llh.numpy(), ref["log_likelihood"][:, 0], rtol=1e-10)
    np.testing.assert_allclose(lprior.numpy(), ref["log_prior"][:, 0], rtol=1e-10)


def _replicates(banana, mutation_steps, seeds=range(1, 33)):
    """z of the means, sds and log evidence of independent populations
    against the oracle."""
    prior, lik = banana
    m, sd, lz = [], [], []
    for seed in seeds:
        res = SamplerSMC(prior, lik, SMCConfig(num_particles=8192, mutation_steps=mutation_steps,
                                               seed=seed, device="cpu")).run()
        x = res["samples"][:, 0, :]
        m.append(x.mean(axis=0))
        sd.append(x.std(axis=0))
        lz.append(res["log_marginal_likelihood"])
        assert res["stages"] >= 2 and res["betas"][-1] == 1.0
    R = len(m)

    def z(v, exact):
        v = np.asarray(v)
        return (v.mean(axis=0) - exact) / (v.std(axis=0, ddof=1) / np.sqrt(R))

    return z(m, BANANA_MEAN), z(sd, BANANA_SD), z(lz, BANANA_LOG_Z)


@pytest.fixture(scope="module")
def banana():
    return models(os.path.join(FIXTURES, "banana"))[0]


def test_banana_meets_the_oracle_without_the_reflection(banana, monkeypatch):
    monkeypatch.setattr(smc, "reflect_on_bounds", lambda x, lower, upper: x)
    z_mean, z_sd, z_lz = _replicates(banana, mutation_steps=5)
    assert np.all(np.abs(z_mean) <= 4) and np.all(np.abs(z_sd) <= 4), (z_mean, z_sd)
    assert abs(z_lz) <= 4, z_lz


def test_reflection_moves_the_population_off_the_oracle(banana):
    _, z_sd, _ = _replicates(banana, mutation_steps=20, seeds=range(1, 9))
    assert z_sd[0] < -4, z_sd
