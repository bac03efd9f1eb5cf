"""The transit PopPK models' gradients (the likelihood's gradient mode), on the CPU.

The JAX package's gradient samplers differentiate `log_prob` ->
`_simulate_transit` -> `solve_at_times_budget` (its XLA path) by reverse
mode. The port's gradient mode takes the same solve through
ops/transit_tangent_kernels.py (kernel B2J on the card, its plain version
here: the eager solve with forward-mode tangents).

- The JAX package's gradient through the solve is NaN on every row of
  finite density (the reverse mode of sqrt at 0, bcm3_tpu/ode/dp5.py:308-310);
  the port's sqrt is zero-safe (ode/dp5.py `_safe_sqrt`), a recorded
  departure. Under tests/jax_shims.py's `jax_dp5_zero_safe_sqrt` the
  posterior's value and gradient in z (hmc.LogPosterior, in the gradient
  mode) match jax.value_and_grad of the JAX package's `logpost_z`, rtol
  1e-8, on both transit models.
- B2J's plain version: its central amounts are the eager solve's bit for
  bit, and its Jacobian contracted with a random weight equals
  torch.autograd.grad through the eager solve (`_simulate_transit`), rtol
  1e-10 in float64; in float32, where the floor 1e-300 of log(k_t s) is 0,
  autograd's gradient is finite on every lane that finishes (the
  double-where of `_simulate_transit`) and within 1e-3 of the plain
  version's.
- Gradients are finite wherever the density is, on 256 prior draws, in
  float32 and float64.
- A patient's uniform at exactly 0 or 1 (ndtri +-inf, a rate inf or 0)
  leaves the rates' values as they were and the gradient finite.
- A short NUTS run on one_transit stores the JAX package's `log_prob` of
  its rows (rtol 1e-8); PT on one_transit still runs kernel B2's path and
  never the gradient mode, also after a gradient sampler used the same
  likelihood.

The JAX package's value-and-gradient through the 768-trip loop is
compiled once per model and shim (about 10-14 s each).
"""

import os

import jax
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
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
from bcm3_tpu_torch.ops.transit_tangent_kernels import RATES, transit_jacobian_plain
from bcm3_tpu_torch.sampler import NUTSConfig, PTConfig, SamplerNUTS, SamplerPT
from bcm3_tpu_torch.sampler.hmc import LogPosterior
from jax_shims import jax_dp5_zero_safe_sqrt

TYPES = ["one_transit", "two_transit"]
P, T = 4, 6


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Both transit models over synthesize_trial(4, 6, seed=7), in the port
    and in the JAX package, from the same XML files."""
    out = {}
    for pk_type in TYPES:
        d = str(tmp_path_factory.mktemp(pk_type))
        trial, _ = synthesize_trial(num_patients=P, num_timepoints=T, seed=7)
        pk = os.path.join(d, "pkdata.nc")
        trial.save(pk, "TRIAL1", "lapatinib")
        prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
        write_poppk_prior_xml(prior_xml, P, pk_type)
        write_poppk_likelihood_xml(lik_xml, pk, "TRIAL1", "lapatinib", pk_type)
        vs, jvs = VariableSet.from_xml(prior_xml), JVariableSet.from_xml(prior_xml)
        out[pk_type] = ((Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)),
                        (JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs)))
    return out


def _z_rows(jprior, n, seed):
    """Prior draws of the JAX package mapped to z by its own reparametrization."""
    x = np.asarray(jprior.sample(jax.random.PRNGKey(seed), (n,)))
    return JReparam(jprior.lower, jprior.upper).from_x(x)


def _jax_value_and_grad(jprior, jlik, z):
    jn = JSamplerNUTS(jprior, jlik, JNUTSConfig())
    out = jax.jit(jax.vmap(jax.value_and_grad(jn._logpost)))(z)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("pk_type", TYPES)
def test_jax_gradient_is_nan_through_the_solve(models, pk_type):
    """The caveat, shown: without the shim the JAX package's gradient is
    NaN on every row of finite density."""
    _, (jprior, jlik) = models[pk_type]
    v, g = _jax_value_and_grad(jprior, jlik, _z_rows(jprior, 12, seed=3))
    fin = np.isfinite(v)
    assert fin.sum() >= 6
    assert np.isnan(g[fin]).any(axis=1).all()


@pytest.mark.parametrize("pk_type", TYPES)
def test_posterior_in_the_gradient_mode_matches_jax(models, pk_type, monkeypatch):
    (prior, lik), (jprior, jlik) = models[pk_type]
    jax_dp5_zero_safe_sqrt(monkeypatch)
    # the tempering enters both
    monkeypatch.setattr(lik, "learning_rate", 0.7)
    monkeypatch.setattr(jlik, "learning_rate", 0.7)
    z = _z_rows(jprior, 12, seed=3)
    ref_v, ref_g = _jax_value_and_grad(jprior, jlik, z)
    fin = np.isfinite(ref_v)
    assert fin.sum() >= 6
    calls = []
    apply = poppk.TransitCentral.apply
    monkeypatch.setattr(poppk.TransitCentral, "apply",
                        lambda *a: (calls.append(1), apply(*a))[1])
    v, g = (a.numpy() for a in LogPosterior(prior, lik).value_and_grad(torch.as_tensor(z)))
    assert calls and not lik.model.gradient_mode  # the mode is set around the call only
    np.testing.assert_array_equal(np.isfinite(v), fin)
    np.testing.assert_allclose(v[fin], ref_v[fin], rtol=1e-8)
    assert np.isfinite(g[fin]).all()
    # relative to each row's largest component (a component can cancel to 0)
    scale = np.abs(ref_g[fin]).max(axis=1, keepdims=True)
    np.testing.assert_allclose(g[fin] / scale, ref_g[fin] / scale, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pk_type", TYPES)
def test_plain_version_matches_autograd_of_the_eager_solve(models, pk_type, dtype):
    (prior, lik), _ = models[pk_type]
    pk = lik.model
    B = 4
    x = prior.sample(torch.Generator().manual_seed(4), (B,), dtype)
    tb = pk._tables(x.device, dtype)
    p, _, _ = pk._patient_params(x)
    tables, options, rates = pk.transit_jacobian_inputs(p, tb)
    names = RATES[: len(rates)]
    central, jac, ok = transit_jacobian_plain(dict(zip(names, rates)), **tables, **options)
    # autograd through the eager solve, the lane rates as leaves
    leaves = [r.clone().requires_grad_(True) for r in rates]
    q = dict(p, **{k: v.reshape(B, P) for k, v in zip(names, leaves)})
    ref = pk._simulate_transit(q, tb).reshape(B * P, T)
    assert ok.sum() >= B * P // 2
    assert torch.equal(ok, torch.isfinite(ref).all(dim=1))
    assert torch.equal(central[ok], ref.detach()[ok]) and torch.isnan(central[~ok]).all()
    w = torch.randn((B * P, T), generator=torch.Generator().manual_seed(5), dtype=dtype)
    grads = torch.autograd.grad((torch.where(torch.isfinite(ref), ref, 0.0) * w).sum(), leaves)
    want = torch.stack(grads, dim=1)[ok]
    got = torch.einsum("lt,ltk->lk", w, jac)[ok]
    assert torch.isfinite(want).all()
    rtol = 1e-10 if dtype == torch.float64 else 1e-3
    # relative to each rate's largest derivative over the lanes
    scale = want.abs().amax(dim=0)
    torch.testing.assert_close(got / scale, want / scale, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pk_type", TYPES)
def test_gradients_finite_where_the_density_is(models, pk_type, dtype):
    (prior, lik), _ = models[pk_type]
    x = prior.sample(torch.Generator().manual_seed(4), (256,), dtype)
    target = LogPosterior(prior, lik)
    v, g = target.value_and_grad(target.reparam.from_x(x))
    # a draw whose rate overflows has a finite density in which that rate
    # no longer enters, and a NaN gradient, in the JAX package as here
    fin = torch.isfinite(v)
    params, _, _ = lik.model._patient_params(x)
    for q in params.values():
        fin &= torch.isfinite(q.reshape(len(x), -1)).all(dim=1)
    assert fin.sum() >= 64
    assert torch.isfinite(g[fin]).all()


def test_nuts_stores_the_jax_log_prob(models, monkeypatch):
    (prior, lik), (_, jlik) = models["one_transit"]
    # a budget of 128 trips on both sides (these trajectories take tens)
    monkeypatch.setattr(lik.model, "solver_trips", 128)
    monkeypatch.setattr(jlik.model, "solver_trips", 128)
    cfg = NUTSConfig(num_warmup=1, num_samples=2, num_chains=4, max_tree_depth=1, seed=3,
                     device="cpu", dtype=torch.float64)
    res = SamplerNUTS(prior, lik, cfg).run()
    x = res["samples"][:, 0, :]
    ll = res["log_likelihood"][:, 0]
    ref = np.asarray(jax.jit(jax.vmap(jlik.log_prob))(x))
    np.testing.assert_array_equal(np.isfinite(ll), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= 4
    np.testing.assert_allclose(ll[fin], ref[fin], rtol=1e-8)


def test_pt_on_one_transit_still_runs_b2(models, monkeypatch):
    (prior, lik), _ = models["one_transit"]
    # a gradient sampler's evaluation first: the mode ends with it
    target = LogPosterior(prior, lik)
    target.value_and_grad(target.reparam.from_x(
        prior.sample(torch.Generator().manual_seed(2), (2,), torch.float64)))
    calls = []
    solve = poppk.transit_solve
    monkeypatch.setattr(poppk, "transit_solve",
                        lambda *a, **k: (calls.append(1), solve(*a, **k))[1])

    def refuse(*args):
        raise AssertionError("PT ran the gradient mode")

    monkeypatch.setattr(poppk.TransitCentral, "apply", refuse)
    cfg = PTConfig(num_samples=2, use_every_nth=1, num_chains=2, num_ensembles=2,
                   adapt_proposal_samples=0, adapt_proposal_times=0, seed=1, device="cpu",
                   dtype=torch.float32)
    res = SamplerPT(prior, lik, cfg).run()
    assert calls
    rows = torch.as_tensor(res["samples"][:, 0, :], dtype=torch.float32)
    ll = res["log_likelihood"][:, 0]
    np.testing.assert_array_equal(lik.log_prob_batched(rows).double().numpy(), ll)


@pytest.mark.parametrize("pk_type", TYPES)
def test_a_rate_at_its_range_edge_keeps_the_gradient_finite(models, pk_type, monkeypatch):
    """A patient's uniform at exactly 1 or 0 (its z beyond the sigmoid's
    range, as a VI draw of large sigma lands) makes ndtri(u) +-inf and the
    rate inf or 0: the row's density is unchanged (-inf where the solve
    fails) and its gradient finite (the likelihood's share 0, the recorded
    departure), where 0 times ndtri's infinite derivative was NaN."""
    (prior, lik), _ = models[pk_type]
    monkeypatch.setattr(lik.model, "solver_trips", 128)
    target = LogPosterior(prior, lik)
    x = prior.sample(torch.Generator().manual_seed(4), (6,), torch.float64)
    z = target.reparam.from_x(x)
    names = list(prior.varset.names)
    z[0, names.index("patient_abs_0")] = 40.0  # u = 1: ka = inf, the solve fails
    z[1, names.index("patient_abs_1")] = -800.0  # u = 0: ka = 0
    z[2, names.index("patient_elim_2")] = 40.0  # kel = inf
    v, g = target.value_and_grad(z)
    x = target.reparam.to_x(z)
    plain, _, _ = lik.model._patient_params(x)
    lik.model.gradient_mode = True
    try:
        guarded, _, _ = lik.model._patient_params(x)
    finally:
        lik.model.gradient_mode = False
    assert torch.isinf(plain["ka"][0, 0]) and plain["ka"][1, 1] == 0
    assert torch.isinf(plain["kel"][2, 2])
    for k in ("ka", "kel"):
        assert torch.equal(guarded[k], plain[k])  # the same values, edges included
    assert torch.isneginf(v[0]) and torch.isneginf(v[2])
    assert torch.isfinite(g).all()
