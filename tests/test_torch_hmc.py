"""The port's HMC against the JAX package's, on the CPU in float64.

- One HMC step of every chain (momentum, L leapfrog steps, the
  Metropolis test) on the banana fixture (PopPK `one`'s gradient, through
  B1's autograd Function and B1T's plain version, is held to the JAX
  package's in tests/test_torch_grad.py),
  given the JAX package's own draws (bcm3_tpu/sampler/hmc.py:145-159: the
  momentum from the first split of each chain's key, the uniform from the
  second): new z, logp, acceptance probability and decision equal to
  1e-10, at a step size where some chains accept and others reject; and
  the same from a current density of -inf, which both accept from.
- A whole run on the banana fixture (`tests/fixtures/examples/banana`,
  64 chains) against the quadrature oracle over its prior box (mean
  (-0.26568, 3.34495), sd (1.67843, 3.80070), the oracle of
  tests/test_samplers_extra.py's `_banana_exact`): each coordinate's mean
  and sd within 4 Monte Carlo standard errors (a mean's from the spread
  of the per-chain means, an sd's from that of the sds of groups of 8
  chains; the chains are independent).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu.sampler.hmc import HMCConfig as JHMCConfig
from bcm3_tpu.sampler.hmc import SamplerHMC as JSamplerHMC
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.sampler import HMCConfig, SamplerHMC

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "examples")
BANANA_MEAN = np.array([-0.26567506, 3.34495242])
BANANA_SD = np.array([1.67842805, 3.80070236])


def models(d):
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    vs, jvs = VariableSet.from_xml(prior_xml), JVariableSet.from_xml(prior_xml)
    return ((Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)),
            (JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs)))


def oracle_z(x, group=8):
    """z of each coordinate's mean and sd of x (S, C, 2) against the banana
    oracle, with their Monte Carlo standard errors."""
    S, C, D = x.shape
    per_chain = x.mean(axis=0)
    mean, mean_se = per_chain.mean(axis=0), per_chain.std(axis=0, ddof=1) / np.sqrt(C)
    groups = x.reshape(S, C // group, group, D).transpose(1, 0, 2, 3).reshape(C // group, -1, D)
    sds = groups.std(axis=1)
    sd, sd_se = sds.mean(axis=0), sds.std(axis=0, ddof=1) / np.sqrt(len(sds))
    return (mean - BANANA_MEAN) / mean_se, (sd - BANANA_SD) / sd_se


STEP_EPS, STEP_CHAINS, STEP_LEAPFROG = 0.2, 6, 4  # accepts some chains, rejects others


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The banana's models, the JAX sampler and its jitted step of all
    chains (compiled once for the tests that use it)."""
    (prior, lik), (jprior, jlik) = models(os.path.join(FIXTURES, "banana"))
    js = JSamplerHMC(jprior, jlik, JHMCConfig(num_leapfrog_steps=STEP_LEAPFROG))
    step = jax.jit(jax.vmap(lambda z1, l1, k1, im: js._step(z1, l1, k1, STEP_EPS, im),
                            in_axes=(0, 0, 0, None)))
    return prior, lik, jprior, js, step


def _step_against_jax(minus_inf=()):
    """One step of 6 chains, the port's against the JAX package's with its
    draws; the chains at `minus_inf` are given a current density of -inf
    (as a chain started at a failing prior draw has), which enters the
    Hamiltonian of both as -inf. Returns the port's decisions."""
    prior, lik, jprior, js, step = _jax_step()
    eps, C, D, L = STEP_EPS, STEP_CHAINS, prior.num_variables, STEP_LEAPFROG
    x = np.asarray(jprior.sample(jax.random.PRNGKey(11), (C,)))
    z = js._reparam.from_x(x)
    inv_mass = np.random.default_rng(0).uniform(0.5, 2.0, D)
    logp = np.array(jax.jit(jax.vmap(js._logpost))(z))
    logp[list(minus_inf)] = -np.inf
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    ref = step(z, jnp.asarray(logp), keys, jnp.asarray(inv_mass))
    # the JAX step's draws: momentum from the first split, uniform from the second
    kp, ka = jax.vmap(jax.random.split, out_axes=1)(keys)
    normal = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (D,)))(kp))
    uniform = np.asarray(jax.vmap(jax.random.uniform)(ka))

    s = SamplerHMC(prior, lik, HMCConfig(num_leapfrog_steps=L, device="cpu"))

    def t(a, **kw):
        return torch.as_tensor(np.array(a), **kw)

    lp, grad = s.target.value_and_grad(t(z))
    fin = np.isfinite(logp)
    np.testing.assert_allclose(lp.numpy()[fin], logp[fin], rtol=1e-10)
    z1, lp1, _, alpha, accept = s.step(t(z), t(logp), grad, t(eps, dtype=torch.float64),
                                       t(inv_mass), t(normal), t(uniform))
    np.testing.assert_array_equal(accept.numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(z1.numpy(), np.asarray(ref[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lp1.numpy(), np.asarray(ref[1]), rtol=1e-10)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(ref[2]), rtol=1e-10, atol=1e-12)
    return accept


def test_step_matches_jax():
    accept = _step_against_jax()
    assert accept.any() and not accept.all()


def test_step_from_a_density_of_minus_inf_matches_jax():
    """h1 - h0 = +inf from a current density of -inf: both accept a finite
    end point with probability 1 (a -inf end point would give NaN, which
    both count as a rejection)."""
    accept = _step_against_jax(minus_inf=(0, 3))
    assert accept[0] and accept[3]


def test_banana_run_meets_the_oracle():
    (prior, lik), _ = models(os.path.join(FIXTURES, "banana"))
    s = SamplerHMC(prior, lik, HMCConfig(num_samples=100, num_warmup=100, num_chains=64,
                                         num_leapfrog_steps=16, seed=1, device="cpu"))
    res = s.run()
    assert 0.4 < res["accept_rate"] <= 1.0
    assert res["samples"].shape == (100 * 64, 1, 2)
    assert res["gradient_evaluations"] == 100 * 16  # L per step, the first carried over
    z_mean, z_sd = oracle_z(res["samples_per_chain"])
    assert np.all(np.abs(z_mean) <= 4) and np.all(np.abs(z_sd) <= 4), (z_mean, z_sd)
