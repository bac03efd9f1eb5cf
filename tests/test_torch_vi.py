"""The port's VI against the JAX package's, on the CPU in float64.

- The ELBO and its gradient in (mu, log_sigma) at fixed standard normals
  on the banana fixture, against the JAX package's formula
  (bcm3_tpu/sampler/vi.py:78-84) over its own `logpost_z`, to 1e-10.
- Five Adam steps from the same start with the same draws against
  `optax.adam` at the JAX sampler's learning rate, to 1e-10.
- A whole fit on a Gaussian target (uniform prior on [-10, 10]^2,
  likelihood N(1, 0.3) x N(-2, 0.7)), as tests/test_samplers_extra.py
  holds the JAX package's: mean-field is exact there, and the emitted
  draws' mean lies within 0.15 and their sd within 25% of the target's.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from bcm3_tpu.sampler.vi import SamplerVI as JSamplerVI
from bcm3_tpu.sampler.vi import VIConfig as JVIConfig
from bcm3_tpu_torch import Prior, VariableSet
from bcm3_tpu_torch.likelihoods import Likelihood
from bcm3_tpu_torch.sampler import SamplerVI, VIConfig
from test_torch_hmc import FIXTURES, models


def _jax_elbo(js, D):
    def elbo(params, eps):
        mu, log_sigma = params
        logp = jax.vmap(js._logpost)(mu + jnp.exp(log_sigma) * eps)
        logp = jnp.where(jnp.isfinite(logp), logp, -1e10)
        return jnp.mean(logp) + jnp.sum(log_sigma) + 0.5 * D * (1.0 + jnp.log(2 * jnp.pi))

    return elbo


def test_elbo_gradient_and_adam_match_jax():
    (prior, lik), (jprior, jlik) = models(os.path.join(FIXTURES, "banana"))
    D, M, lr = 2, 32, 0.05
    js = JSamplerVI(jprior, jlik, JVIConfig(learning_rate=lr))
    elbo = jax.jit(jax.value_and_grad(_jax_elbo(js, D)))
    rng = np.random.default_rng(1)
    mu, log_sigma = np.array([0.1, 0.3]), np.array([-0.5, -0.2])
    eps = rng.normal(size=(6, M, D))

    s = SamplerVI(prior, lik, VIConfig(learning_rate=lr, num_iterations=5, device="cpu"))
    t = torch.as_tensor
    m_t, ls_t = t(mu).requires_grad_(True), t(log_sigma).requires_grad_(True)
    val = s.elbo(m_t, ls_t, t(eps[0]))
    grads = torch.autograd.grad(val, [m_t, ls_t])
    ref_val, ref_grads = elbo((mu, log_sigma), eps[0])
    np.testing.assert_allclose(float(val), float(ref_val), rtol=1e-10)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12)

    opt = optax.adam(lr)
    params = (jnp.asarray(mu), jnp.asarray(log_sigma))
    state = opt.init(params)
    for e in eps[1:]:
        _, g = elbo(params, e)
        updates, state = opt.update(jax.tree_util.tree_map(lambda a: -a, g), state)
        params = optax.apply_updates(params, updates)
    got_mu, got_ls, cur = s.fit(t(mu), t(log_sigma), [t(e) for e in eps[1:]])
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(params[0]), rtol=1e-10)
    np.testing.assert_allclose(got_ls.numpy(), np.asarray(params[1]), rtol=1e-10)
    assert math.isfinite(cur)


def test_gaussian_target(tmp_path):
    prior_xml = tmp_path / "prior.xml"
    prior_xml.write_text(
        "<prior>\n"
        '<variable name="a" distribution="uniform" lower="-10" upper="10"/>\n'
        '<variable name="b" distribution="uniform" lower="-10" upper="10"/>\n'
        "</prior>\n"
    )
    vs = VariableSet.from_xml(str(prior_xml))
    prior = Prior.from_xml(str(prior_xml), vs)

    def log_prob_batched(xs):
        return -0.5 * ((xs[:, 0] - 1.0) / 0.3) ** 2 - 0.5 * ((xs[:, 1] + 2.0) / 0.7) ** 2

    s = SamplerVI(prior, Likelihood("gauss", log_prob_batched),
                  VIConfig(num_iterations=1500, num_mc_samples=64, learning_rate=0.02,
                           num_samples=4000, seed=3, device="cpu"))
    res = s.run()
    x = res["samples"][:, 0, :]
    assert res["samples"].shape == (4000, 1, 2) and res["gradient_evaluations"] == 1500
    np.testing.assert_allclose(x.mean(axis=0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(x.std(axis=0), [0.3, 0.7], rtol=0.25)
