"""The port's PopPK likelihood against the JAX package on the CPU.

Both packages read the same prior.xml, likelihood.xml and pkdata file.
- `one`: port (kernel B1's plain version + closed-form observation
  propagation) against JAX `vmap(log_prob)` (the lax.scan path), float64,
  rtol 1e-10, including rows that must score -inf.
- `one_transit`: port (B2's plain version, float32 solve) against the JAX
  Pallas path (float32 solve in interpret mode): the finite sets must be
  equal and the finite values agree to rtol 5e-3, as
  tests/test_poppk_pallas.py:115-134 holds the JAX package's own paths.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from jax_shims import jax_biphasic_with_ka2
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)


def _setup(tmp_path, pk_type, P=4, T=10, seed=7):
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=T, seed=seed)
    pk = os.path.join(tmp_path, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    prior_xml = os.path.join(tmp_path, "prior.xml")
    lik_xml = os.path.join(tmp_path, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, P, pk_type)
    write_poppk_likelihood_xml(lik_xml, pk, "TRIAL1", "lapatinib", pk_type)
    vs = VariableSet.from_xml(prior_xml)
    port = (Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs))
    jvs = JVariableSet.from_xml(prior_xml)
    ref = (JPrior.from_xml(prior_xml, jvs), jax_create_likelihood(lik_xml, jvs))
    return port, ref


def _u_index(model, patient, which):
    """Column of a patient's absorption (0) or elimination (1) uniform."""
    return model.num_pk_params + 2 * (patient + 1) + which


def test_log_prob_one_matches_jax(tmp_path):
    (prior, lik), (jprior, jlik) = _setup(str(tmp_path), "one")
    xs = np.array(jprior.sample(jax.random.PRNGKey(0), (10,)))
    m = lik.model
    # rows that must score -inf: an absorption uniform at 1 (ka = inf
    # makes inf * 0 = NaN in the recurrence) and a NaN parameter
    xs[7, _u_index(m, 2, 0)] = 1.0
    xs[8, 1] = np.nan
    # a row at the other edge stays finite (u = 0 gives ka = 0)
    xs[9, _u_index(m, 1, 0)] = 0.0
    ref = np.asarray(jax.vmap(jlik.log_prob)(xs))
    got = lik.log_prob_batched(torch.as_tensor(xs))
    assert got.dtype == torch.float64 and got.shape == (10,)
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(got[[7, 8]]).all() and np.isfinite(got[[0, 9]]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_log_prob_transit_matches_jax_pallas(tmp_path, monkeypatch):
    (prior, lik), (jprior, jlik) = _setup(str(tmp_path), "one_transit")
    xs = np.array(jprior.sample(jax.random.PRNGKey(2), (6,)))
    monkeypatch.setenv("BCM3_TRANSIT_PALLAS", "1")
    ref = np.asarray(jlik.model.log_prob_batched(xs))
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= 2
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-3)


def test_log_prob_float32_matches_float64(tmp_path):
    """The card's working type, on the CPU: float32 scores the same rows
    finite as float64 (including uniforms at exactly 0 and 1, where ndtri
    is -inf/inf) and agrees to rtol 1e-4 on them."""
    (prior, lik), _ = _setup(str(tmp_path), "one", P=4, T=24)
    g = torch.Generator().manual_seed(3)
    xs = prior.sample(g, (32,), torch.float64)
    m = lik.model
    for row, (patient, which, u) in enumerate(
        [(0, 0, 0.0), (1, 1, 0.0), (2, 0, 1.0), (3, 1, 1.0)]
    ):
        xs[row, _u_index(m, patient, which)] = u
    lp64 = lik.log_prob_batched(xs)
    lp32 = lik.log_prob_batched(xs.float())
    assert lp32.dtype == torch.float32
    assert not torch.isnan(lp32).any()
    fin = torch.isfinite(lp64)
    assert torch.equal(torch.isfinite(lp32), fin) and fin.sum() >= 20
    torch.testing.assert_close(lp32[fin].double(), lp64[fin], rtol=1e-4, atol=0.0)


def test_pkdata_round_trip(tmp_path):
    """PopPKTrial.save/load keep every field the likelihood reads."""
    from bcm3_tpu_torch.likelihoods.poppk import PopPKTrial

    trial, _ = synthesize_trial(num_patients=3, num_timepoints=8, seed=1)
    path = os.path.join(tmp_path, "pk.nc")
    trial.save(path, "T", "afatinib")
    back = PopPKTrial.load(path, "T", "afatinib")
    for name in ("time", "observed", "dose", "dosing_interval", "interruptions"):
        np.testing.assert_array_equal(getattr(back, name), getattr(trial, name))


_RTOL = {"two": 1e-10, "one_biphasic_uptake": 1e-10, "two_biphasic_uptake": 1e-10,
         "two_transit": 1e-8}


@pytest.mark.parametrize("pk_type", ["two", "one_biphasic_uptake", "two_transit",
                                     "two_biphasic_uptake"])
def test_unported_pk_types_raise(tmp_path, monkeypatch, pk_type):
    """The pk_types that the port used to refuse (hence the name) against
    the JAX package's `vmap(log_prob)` in float64 (two and the biphasic
    models: closed form; two_transit: the budgeted DP5 solve), including
    rows that must score -inf: an absorption uniform at 1 and a NaN
    parameter."""
    (prior, lik), (jprior, jlik) = _setup(str(tmp_path), pk_type, P=3, T=8)
    if "biphasic" in pk_type:
        jax_biphasic_with_ka2(jlik, monkeypatch)
    xs = np.array(jprior.sample(jax.random.PRNGKey(4), (8,)))
    m = lik.model
    xs[5, _u_index(m, 2, 0)] = 1.0
    xs[6, 1] = np.nan
    ref = np.asarray(jax.vmap(jlik.log_prob)(xs))
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(got[[5, 6]]).all() and np.isfinite(got).sum() >= 3
    np.testing.assert_allclose(got, ref, rtol=_RTOL[pk_type])


def test_unported_likelihood_type_raises(tmp_path):
    """Every likelihood type of the JAX package is ported: a type neither
    package knows raises ValueError (the name is the test's from before
    fISA was ported)."""
    path = os.path.join(tmp_path, "lik.xml")
    with open(path, "w") as f:
        f.write('<bcm_likelihood type="no_such_type"/>')
    with pytest.raises(ValueError, match="Unknown likelihood type 'no_such_type'"):
        create_likelihood(path, VariableSet())


@pytest.mark.parametrize("pk_type", ["two", "one_biphasic_uptake"])
def test_float32_range_matches_jax(tmp_path, monkeypatch, pk_type):
    """In float32 the two-compartment closed form leaves float32's range on
    some rows whose rates fit in it (tr * tr in `_expm_2x2`, `det_p` of the
    particular solution) and scores them -inf where float64 is finite. The
    JAX package's float32 `vmap(log_prob)` does so on the same rows: at
    chip_smoke.py's shape (16 patients x 24 timepoints, trial seed 42, 256
    prior draws of seed 5) the finite sets of both float32 paths are
    equal, and some rows differ from float64's."""
    (prior, lik), (_, jlik) = _setup(str(tmp_path), pk_type, P=16, T=24, seed=42)
    if "biphasic" in pk_type:
        jax_biphasic_with_ka2(jlik, monkeypatch)
    xs = prior.sample(torch.Generator().manual_seed(5), (256,), torch.float64)
    fin64 = np.isfinite(lik.log_prob_batched(xs).numpy())
    fin32 = np.isfinite(lik.log_prob_batched(xs.float()).numpy())
    with jax.enable_x64(False):
        ref = jax.vmap(jlik.log_prob)(xs.float().numpy())
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(fin32, np.isfinite(np.asarray(ref)))
    assert (fin32 != fin64).sum() >= 3
