"""Gradients of the port against torch autograd and against jax.grad, on the CPU.

- B1T, the reverse mode of kernel B1 (ops/poppk_kernels.py): its plain
  version against torch.autograd.grad through B1's plain recurrence and
  against jax.grad through the JAX package's scan oracle
  (bcm3_tpu/ops/poppk_pallas.py:134), float64, rtol 1e-10, with a
  degenerate lane (ka + ke == kel), at K = 9 and over K in {1, 2, 5, 14}; in
  float32 against jax.grad in float32 (limit below); the autograd
  Function saves only its inputs (B1T recomputes the forward); and
  torch.autograd.gradcheck of the autograd Function.
- The posterior in z (hmc.LogPosterior): value and gradient against
  jax.grad of the JAX package's `logpost_z` (bcm3_tpu/sampler/nuts.py:122-130)
  on PopPK `one`, `two`, `one_biphasic_uptake` (through tests/jax_shims.py)
  and the banana fixture, rtol 1e-8.
- The likelihood's gradient through the Function equals the gradient
  through B1's plain recurrence, so a trajectory that autograd takes for
  a constant cannot come back unnoticed.
- Gradients are finite wherever the log-density is (the double-where
  rule), on prior draws of every model above.
- HMC, NUTS, VI and SMC are built on the transit models (one_transit,
  two_transit) and take two steps each with chains (or VI's parameters)
  moving: the gradient samplers through the likelihood's gradient mode
  (kernel B2J's plain version here), SMC through log_prob_batched.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu.ops.poppk_pallas import propagate_intervals_reference as jax_b1_reference
from bcm3_tpu.sampler.hmc import _Reparam as JReparam
from bcm3_tpu.sampler.nuts import NUTSConfig as JNUTSConfig
from bcm3_tpu.sampler.nuts import SamplerNUTS as JSamplerNUTS
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.likelihoods import poppk
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.ops import build
from bcm3_tpu_torch.ops.poppk_kernels import (
    PropagateOneCompartment,
    propagate_intervals_adjoint,
    propagate_intervals_plain,
)
from bcm3_tpu_torch.sampler import (
    HMCConfig,
    NUTSConfig,
    SamplerHMC,
    SamplerNUTS,
    SamplerSMC,
    SamplerVI,
    SMCConfig,
    VIConfig,
)
from bcm3_tpu_torch.sampler.hmc import LogPosterior
from jax_shims import jax_biphasic_with_ka2

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "examples")


def _b1_problem(B=5, P=4, K=9, seed=0, degenerate=True):
    rng = np.random.default_rng(seed)
    ka = rng.uniform(0.5, 2.0, (B, P))
    ke = rng.uniform(0.01, 0.1, (B, P))
    kel = rng.uniform(0.1, 0.5, (B, P))
    if degenerate:
        kel[0, 1] = ka[0, 1] + ke[0, 1]  # ka + ke == kel: the closed form's limit
    data = (rng.uniform(100, 200, P), rng.uniform(12, 24, P), rng.uniform(50, 150, (P, K)))
    weights = rng.normal(size=(2, K, B, P))  # the loss: sum(w_gut * gut + w_cen * cen)
    return (ka, ke, kel), data, weights


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _torch_grad(f, rates, data, weights):
    x = [_t(r).requires_grad_(True) for r in rates]
    gut, cen = f(*x, *map(_t, data))
    loss = (gut * _t(weights[0])).sum() + (cen * _t(weights[1])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, x)]


def test_b1t_plain_matches_autograd_of_the_recurrence():
    rates, data, weights = _b1_problem()
    ref = _torch_grad(propagate_intervals_plain, rates, data, weights)
    got = _torch_grad(PropagateOneCompartment.apply, rates, data, weights)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12 * np.abs(r).max())


def test_b1t_plain_matches_jax_grad():
    rates, data, weights = _b1_problem(seed=1)

    def loss(ka, ke, kel):
        gut, cen = jax_b1_reference(ka, ke, kel, *(jnp.asarray(d) for d in data))
        return jnp.sum(gut * weights[0]) + jnp.sum(cen * weights[1])

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(r) for r in rates))
    # B1T itself, given B1's inputs and the loss's weights
    got = propagate_intervals_adjoint(*map(_t, rates), *map(_t, data), *map(_t, weights))
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-12 * np.abs(r).max())


# float32: both sides round every operation to float32 (unit roundoff u
# = 6e-8). Relative to each gradient's largest lane (the loss's random
# weights of both signs let a lane's sum cancel), the error is bounded by
# eg = exp(-(ka + ke) dt) with |(ka + ke) dt| up to ~50 here, whose
# argument rounded by u is a relative error of ~50 u = 3e-6 in eg, plus
# the rounding of the tangents' sums of up to K(K+1)/2 ~ 100 products,
# ~100 u = 6e-6: about 1e-5 in all. The limit: 2e-5 of the largest lane
# (measured: at most 1.8e-6).
_F32_LIMIT = 2e-5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("K", [1, 2, 5, 14])
def test_b1t_plain_matches_jax_grad_over_K(K, dtype):
    rates, data, weights = _b1_problem(B=6, P=3, K=K, seed=10 + K)
    rates, data, weights = ([np.asarray(a, dtype) for a in x] for x in (rates, data, weights))
    # degenerate lanes, ka + ke == kel in the working type
    for b, p in ((0, 1), (3, 2)):
        rates[2][b, p] = rates[0][b, p] + rates[1][b, p]

    def loss(ka, ke, kel):
        gut, cen = jax_b1_reference(ka, ke, kel, *(jnp.asarray(d) for d in data))
        return jnp.sum(gut * weights[0]) + jnp.sum(cen * weights[1])

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(r) for r in rates))
    assert all(r.dtype == np.dtype(dtype) for r in ref)
    tt = getattr(torch, dtype)
    got = propagate_intervals_adjoint(
        *(torch.as_tensor(a, dtype=tt) for a in (*rates, *data, *weights))
    )
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        assert g.dtype == np.dtype(dtype)
        if dtype == "float64":
            np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12 * np.abs(r).max())
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=_F32_LIMIT * np.abs(r).max())


def test_b1_function_saves_only_its_inputs():
    """B1T recomputes the forward, so autograd keeps no (K, B, P) state:
    the Function's saved tensors are its six inputs."""
    rates, data, _ = _b1_problem(B=4, P=3, K=7, seed=3)
    x = [_t(r).requires_grad_(True) for r in rates]
    data = [_t(d) for d in data]
    gut, cen = PropagateOneCompartment.apply(*x, *data)
    saved = gut.grad_fn.saved_tensors
    assert len(saved) == 6
    for s, inp in zip(saved, (*x, *data)):
        assert s.data_ptr() == inp.data_ptr() and s.shape == inp.shape
    assert all(s.numel() < gut.numel() for s in saved)


def test_b1_function_gradcheck():
    # no degenerate lane: finite differences step off the limit branch,
    # whose derivative is the limit's own (autograd's through the where)
    rates, data, _ = _b1_problem(B=3, P=2, K=5, seed=2, degenerate=False)
    rates = [_t(r).requires_grad_(True) for r in rates]
    data = [_t(d) for d in data]
    assert torch.autograd.gradcheck(
        lambda ka, ke, kel: PropagateOneCompartment.apply(ka, ke, kel, *data), rates
    )


def test_refuse_grad_names_the_kernel():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="my_kernel"):
        build.refuse_grad("my_kernel", [x])
    with torch.no_grad():
        build.refuse_grad("my_kernel", [x])  # autograd does not record: allowed
    build.refuse_grad("my_kernel", [x.detach()])


# ---------------------------------------------------------------------------
# the posterior in z


def _poppk(tmp_path, pk_type, P=4, T=10, seed=7):
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=T, seed=seed)
    d = str(tmp_path)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), P, pk_type)
    write_poppk_likelihood_xml(os.path.join(d, "likelihood.xml"), pk, "TRIAL1", "lapatinib",
                               pk_type)
    return d


def _models(d):
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    vs = VariableSet.from_xml(prior_xml)
    jvs = JVariableSet.from_xml(prior_xml)
    return ((Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)),
            (JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs)))


_MODELS = ["one", "two", "one_biphasic_uptake", "banana"]


@pytest.fixture(params=_MODELS)
def model(request, tmp_path, monkeypatch):
    name = request.param
    d = os.path.join(FIXTURES, "banana") if name == "banana" else _poppk(tmp_path, name)
    port, ref = _models(d)
    if name == "one_biphasic_uptake":
        jax_biphasic_with_ka2(ref[1], monkeypatch)
    return name, port, ref


def _z_rows(jprior, n, seed):
    """Prior draws of the JAX package mapped to z by its own reparametrization."""
    x = np.asarray(jprior.sample(jax.random.PRNGKey(seed), (n,)))
    return JReparam(jprior.lower, jprior.upper).from_x(x)


def test_posterior_gradient_matches_jax(model):
    name, (prior, lik), (jprior, jlik) = model
    lik.learning_rate = jlik.learning_rate = 0.7  # the tempering enters both
    z = _z_rows(jprior, 12, seed=3)
    jn = JSamplerNUTS(jprior, jlik, JNUTSConfig())
    ref_v, ref_g = (np.asarray(a) for a in jax.jit(jax.vmap(jax.value_and_grad(jn._logpost)))(z))
    fin = np.isfinite(ref_v)
    assert fin.sum() >= 6, f"{name}: too few finite rows"
    v, g = LogPosterior(prior, lik).value_and_grad(_t(z))
    np.testing.assert_array_equal(np.isfinite(v.numpy()), fin)
    np.testing.assert_allclose(v.numpy()[fin], ref_v[fin], rtol=1e-8)
    # relative to each row's largest component (a component can cancel to 0)
    scale = np.abs(ref_g[fin]).max(axis=1, keepdims=True)
    np.testing.assert_allclose(g.numpy()[fin] / scale, ref_g[fin] / scale, rtol=1e-8, atol=1e-8)


def test_gradients_finite_where_the_density_is(model):
    name, (prior, lik), _ = model
    x = prior.sample(torch.Generator().manual_seed(4), (256,), torch.float64)
    target = LogPosterior(prior, lik)
    v, g = target.value_and_grad(target.reparam.from_x(x))
    fin = torch.isfinite(v)
    if lik.model is not None:
        # a draw whose rate overflows (a half-Cauchy population sd of ~600
        # puts kel = 10^(mu + sd * ndtri(u)) at inf) scores a finite
        # density in which that rate no longer enters, and a NaN gradient,
        # in the JAX package as here; such rows are left out
        params, _, _ = lik.model._patient_params(x)
        for p in params.values():
            fin &= torch.isfinite(p.reshape(len(x), -1)).all(dim=1)
    assert fin.sum() >= 64, name
    assert torch.isfinite(g[fin]).all(), f"{name}: non-finite gradient at a finite density"


def test_likelihood_gradient_through_the_function(tmp_path, monkeypatch):
    (prior, lik), _ = _models(_poppk(tmp_path, "one"))
    target = LogPosterior(prior, lik)
    x = prior.sample(torch.Generator().manual_seed(5), (16,), torch.float64)
    z = target.reparam.from_x(x)
    v, g = target.value_and_grad(z)
    assert torch.isfinite(v).sum() >= 8 and g.abs().sum() > 0
    # the same through B1's plain recurrence, differentiated by autograd
    monkeypatch.setattr(poppk, "PropagateOneCompartment",
                        types.SimpleNamespace(apply=propagate_intervals_plain))
    v2, g2 = target.value_and_grad(z)
    fin = torch.isfinite(v)
    torch.testing.assert_close(v2, v, rtol=1e-12, atol=0)
    torch.testing.assert_close(g2[fin], g[fin], rtol=1e-10, atol=1e-10)
    # the rates' share of the gradient is not zero: a constant trajectory
    # would leave only the observation-noise terms
    k = lik.model.num_pk_params
    assert (g[fin][:, k + 2 :]).abs().max() > 1e-6


def _finite_start(target, prior, C, seed=1):
    """C prior draws of finite log-posterior, in z, with their values and
    gradients (float64)."""
    z = target.reparam.from_x(prior.sample(torch.Generator().manual_seed(seed), (4 * C,),
                                           torch.float64))
    v, g = target.value_and_grad(z)
    keep = torch.isfinite(v).nonzero()[:C, 0]
    assert len(keep) == C
    return z[keep], v[keep], g[keep]


@pytest.mark.parametrize("sampler", ["hmc", "nuts", "vi", "smc"])
@pytest.mark.parametrize("pk_type", ["one_transit", "two_transit"])
def test_transit_models_need_b2s_adjoint(tmp_path, sampler, pk_type):
    """Each sampler on a transit model: two steps with chains moving (the
    gradient samplers differentiate through B2's counterpart with tangents,
    B2J, in the likelihood's gradient mode). A trip budget of 128 (these
    trajectories take tens) keeps the CPU's eager solves short."""
    (prior, lik), _ = _models(_poppk(tmp_path, pk_type, T=6))
    lik.model.solver_trips = 128
    C, D, f64 = 4, prior.num_variables, torch.float64
    kw = dict(device="cpu", dtype=f64)
    if sampler == "smc":
        s = SamplerSMC(prior, lik, SMCConfig(num_particles=4 * C, **kw))
        x = prior.sample(torch.Generator().manual_seed(1), (4 * C,), f64)
        llh = s.log_likelihood(x)
        x, llh = x[torch.isfinite(llh)], llh[torch.isfinite(llh)]
        lprior = prior.log_pdf(x)
        chol = 0.1 * s.scaled_cholesky(x)
        moved = torch.zeros(len(x), dtype=torch.bool)
        for _ in range(2):
            normal = torch.randn(x.shape, generator=s.generator, dtype=f64)
            uniform = torch.rand(len(x), generator=s.generator, dtype=f64)
            x_new, llh, lprior, _ = s.mutate(x, llh, lprior, 0.5, chol, normal, uniform)
            moved |= (x_new != x).any(dim=1)
            x = x_new
        assert moved.any() and torch.isfinite(llh).all()
        return
    if sampler == "vi":
        s = SamplerVI(prior, lik, VIConfig(num_mc_samples=C, **kw))
        mu, log_sigma = s.initial_parameters()
        eps = [torch.randn((C, D), generator=s.generator, dtype=f64) for _ in range(2)]
        mu2, log_sigma2, elbo = s.fit(mu, log_sigma, eps)
        assert s.target.gradient_evaluations == 2 and np.isfinite(elbo)
        assert torch.isfinite(mu2).all() and (mu2 != mu).any() and (log_sigma2 != log_sigma).any()
        return
    inv_mass, eps = torch.ones(D, dtype=f64), torch.tensor(1e-3, dtype=f64)
    if sampler == "hmc":
        s = SamplerHMC(prior, lik, HMCConfig(num_chains=C, num_leapfrog_steps=2, **kw))
    else:
        s = SamplerNUTS(prior, lik, NUTSConfig(num_chains=C, max_tree_depth=2, **kw))
    z, lp, g = _finite_start(s.target, prior, C)
    moved = torch.zeros(C, dtype=torch.bool)
    for _ in range(2):
        if sampler == "hmc":
            z_new, lp, g, _, _ = s.step(z, lp, g, eps, inv_mass, *s.draws(C, D, f64))
        else:
            z_new, lp, g, _, _, _ = s.transition(z, lp, g, eps, inv_mass, *s.draws(C, D, f64))
        moved |= (z_new != z).any(dim=1)
        z = z_new
    assert moved.all()
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("example", ["multimodal_circular_ridge", "multimodal_gaussians",
                                     "truncated_t"])
def test_analytic_gradients_finite_where_the_density_is(example):
    """The other analytic fixtures (circular ridges, a Gaussian mixture, a
    t mixture, over bounded priors): finite gradients on every prior draw
    of finite density."""
    d = os.path.join(FIXTURES, example)
    vs = VariableSet.from_xml(os.path.join(d, "prior.xml"))
    prior = Prior.from_xml(os.path.join(d, "prior.xml"), vs)
    target = LogPosterior(prior, create_likelihood(os.path.join(d, "likelihood.xml"), vs))
    x = prior.sample(torch.Generator().manual_seed(6), (256,), torch.float64)
    v, g = target.value_and_grad(target.reparam.from_x(x))
    fin = torch.isfinite(v)
    assert fin.all(), example
    assert torch.isfinite(g).all(), example
