"""The port's importance sampler and sampler factory against the JAX
package (reference: src/sampler/SamplerIS.cpp, SamplerFactory.cpp).

- The running-max filter keeps the same rows in both packages on the same
  batches: each sampler's batch evaluation is replaced on the instance by
  one that returns fixed batches (no file of the JAX package changes).
- A short run on PopPK `one` (float64, CPU): weights == exp(llh), and the
  kept rows' log-prior and log-likelihood are the JAX package's to 1e-10.
- The factory builds every sampler type on the option map's device, each
  with the count of rows it emits.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu.sampler import ISConfig as JISConfig
from bcm3_tpu.sampler import SamplerIS as JSamplerIS
from bcm3_tpu.sampler import create_sampler as jax_create_sampler
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.sampler import (
    ISConfig,
    SamplerHMC,
    SamplerIS,
    SamplerNUTS,
    SamplerPT,
    SamplerSMC,
    SamplerVI,
    create_sampler,
)
from bcm3_tpu_torch.sampler.importance import LOG_WEIGHT_CUTOFF


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("poppk_is"))
    P = 4
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=6, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, P, "one")
    write_poppk_likelihood_xml(lik_xml, pk, "TRIAL1", "lapatinib", "one")
    jvs, vs = JVariableSet.from_xml(prior_xml), VariableSet.from_xml(prior_xml)
    return {
        "jax": (JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs)),
        "port": (Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)),
    }


def _batches(seed=3, n_batches=4, B=64, D=5):
    """Log-likelihoods that climb, dip and jump (so that the running max
    and the cutoff both act within and across batches), non-finite
    log-priors and log-likelihoods on some rows."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ll = rng.normal(-40.0 + 15.0 * b, 12.0, B)
        ll[5] = -np.inf
        lp = rng.normal(-3.0, 1.0, B)
        lp[7] = -np.inf
        lp[9] = np.nan
        out.append((rng.normal(size=(B, D)), lp, ll))
    return out


@pytest.mark.parametrize("num_samples", [40, 1000], ids=["target_reached", "max_rounds"])
def test_filter_keeps_the_same_rows(models, num_samples):
    batches = _batches()
    jprior, jlik = models["jax"]
    js = JSamplerIS(jprior, jlik, JISConfig(num_samples=num_samples, max_rounds=len(batches)))
    jbatches = iter(batches)
    js._batch_eval = lambda key: next(jbatches)
    pprior, plik = models["port"]
    ps = SamplerIS(pprior, plik, ISConfig(num_samples=num_samples, max_rounds=len(batches),
                                          device="cpu"))
    pbatches = iter(batches)
    ps._batch_eval = lambda: next(pbatches)
    jres, pres = js.run(), ps.run()
    for k in ("samples", "log_prior", "log_likelihood", "weights"):
        np.testing.assert_array_equal(pres[k], np.asarray(jres[k]), err_msg=k)
    assert pres["num_evaluations"] == jres["num_evaluations"]
    kept = len(pres["log_likelihood"])
    assert 0 < kept <= num_samples and (kept == num_samples) == (num_samples == 40)
    lw = pres["log_likelihood"][:, 0]
    assert np.all(lw >= np.maximum.accumulate(lw) - LOG_WEIGHT_CUTOFF)


def test_short_run_weights_and_densities(models):
    pprior, plik = models["port"]
    s = create_sampler(pprior, plik, {
        "sampler.type": "is", "sampler.num_samples": "30", "issampler.batch_size": "256",
        "sampler.rngseed": "4", "device": "cpu", "dtype": "float64",
    })
    res = s.run()
    x, lp, ll = res["samples"], res["log_prior"], res["log_likelihood"]
    assert x.shape == (30, 1, pprior.num_variables) and res["num_evaluations"] % 256 == 0
    np.testing.assert_array_equal(res["weights"], np.exp(ll))
    jprior, jlik = models["jax"]
    rows = x[:, 0, :]
    np.testing.assert_allclose(lp[:, 0], np.asarray(jprior.log_pdf(rows)), rtol=1e-10)
    jll = np.asarray(jax.jit(jax.vmap(jlik.log_prob))(rows))
    np.testing.assert_allclose(ll[:, 0], jll, rtol=1e-10)


# (type, class, emitted rows for 10 samples: the gradient samplers pool
# their 8 default chains, SMC emits its 2048 default particles)
_TYPES = [
    ("ptmh", SamplerPT, 10), ("is", SamplerIS, 10), ("hmc", SamplerHMC, 80),
    ("nuts", SamplerNUTS, 80), ("smc", SamplerSMC, 2048), ("vi", SamplerVI, 10),
]


@pytest.mark.parametrize("stype,expected,rows", _TYPES, ids=[t[0] for t in _TYPES])
def test_factory_dispatch(models, stype, expected, rows):
    prior, lik = models["port"]
    opts = {"sampler.type": stype, "sampler.num_samples": "10", "device": "cpu"}
    s = create_sampler(prior, lik, opts)
    assert isinstance(s, expected) and s.device == torch.device("cpu")
    assert s.expected_emitted_samples == rows
    with pytest.raises(ValueError, match="Unknown sampler.type"):
        create_sampler(prior, lik, dict(opts, **{"sampler.type": stype + "_x"}))


_OPTIONS = {
    "hmc": {"hmcsampler.num_chains": "3", "hmcsampler.num_warmup": "7",
            "hmcsampler.num_leapfrog_steps": "5", "hmcsampler.target_accept": "0.7"},
    "nuts": {"nutssampler.num_chains": "3", "nutssampler.num_warmup": "7",
             "nutssampler.max_tree_depth": "4", "nutssampler.target_accept": "0.85"},
    "smc": {"smcsampler.num_particles": "64", "smcsampler.mutation_steps": "2",
            "smcsampler.ess_target": "0.6"},
    "vi": {"visampler.num_iterations": "9", "visampler.num_mc_samples": "4",
           "visampler.learning_rate": "0.01"},
}


@pytest.mark.parametrize("stype", sorted(_OPTIONS))
def test_factory_options_match_jax(stype):
    """The factory reads the JAX factory's option names into the same
    config values, defaults included, and the port's device and dtype."""
    d = os.path.join(os.path.dirname(__file__), "fixtures", "examples", "banana")
    jvs = JVariableSet.from_xml(os.path.join(d, "prior.xml"))
    jprior = JPrior.from_xml(os.path.join(d, "prior.xml"), jvs)
    jlik = jax_create_likelihood(os.path.join(d, "likelihood.xml"), jvs)
    vs = VariableSet.from_xml(os.path.join(d, "prior.xml"))
    prior = Prior.from_xml(os.path.join(d, "prior.xml"), vs)
    lik = create_likelihood(os.path.join(d, "likelihood.xml"), vs)
    for opts in ({"sampler.type": stype},
                 {"sampler.type": stype, "sampler.num_samples": "11", "sampler.rngseed": "4",
                  "sampler.use_every_nth": "2", **_OPTIONS[stype]}):
        ref = jax_create_sampler(jprior, jlik, opts).config
        got = create_sampler(prior, lik, dict(opts, device="cpu", dtype="float64")).config
        for field in dataclasses.fields(ref):
            assert getattr(got, field.name) == getattr(ref, field.name), field.name
        assert got.device == "cpu" and got.dtype == torch.float64
