"""The port's single-patient PK likelihood (`pharmacokinetic_trajectory`)
against the JAX package on the CPU.

Both packages build it from the same likelihood.xml and pkdata file
(patient "3" of synthesize_trial's 4 x 12 trial, seed 7). The port
inherits PopPKLikelihood's evaluation at P = 1: B1's plain version for
`one`, B2's for `one_transit`, the closed form and the eager DP5 for the
others; the JAX package's `log_prob` (jitted, row by row: the function
its registry's `vmap(log_prob)` batches) is its lax.scan and XLA DP5.
Tolerances: float64 rtol 1e-10 (closed form) and 1e-8 (`two_transit`'s
DP5) with equal -inf sets; `one_transit` in float32 on both sides, the
central compartment at B2's float32 stack tolerance (rtol 3e-4, atol
3e-6 x dose) and the log-likelihoods at rtol 5e-3 with equal finite sets
(as tests/test_torch_poppk.py holds B2's); the gradient of `one` through
B1's autograd Function against `jax.grad` at rtol 1e-8.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.likelihoods.pk_single import select_patient as jax_select_patient
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.likelihoods.pk_single import SinglePatientPKLikelihood, select_patient
from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial
from bcm3_tpu_torch.model.variables import VariableSet
from jax_shims import jax_biphasic_with_ka2

PATIENT = "3"


def _jax_rows(fn, xs):
    """A JAX function of one row on each row, jitted once."""
    f = jax.jit(fn)
    return np.array([f(x) for x in xs])

# the variables of each model in the reference's layout: (name, logspace,
# value); indices 0-3 absorption, excretion, elimination (clearance),
# volume; 4/5 periphery; 6/7 biphasic switch time and second absorption
_BASE = [("absorption", True, np.log10(0.5)), ("excretion", True, np.log10(0.03)),
         ("elimination", True, np.log10(18.0)), ("volume_of_distribution", True, np.log10(120.0))]
_PERIPHERY = [("k_periphery_fwd", True, np.log10(0.08)), ("k_periphery_bwd", True, np.log10(0.05))]
_TRANSIT = [("n_transit", True, np.log10(3.0)), ("mean_transit_time", True, np.log10(2.0))]
_SD = [("standard_deviation", False, 20.0), ("proportional_standard_deviation", False, 0.08)]
_LAYOUT = {
    "one": _BASE + _SD,
    "two": _BASE + _PERIPHERY + _SD,
    "one_biphasic_uptake": _BASE + _PERIPHERY + [("biphasic_uptake_time", False, 2.0),
                                                 ("absorption2", True, np.log10(0.2))] + _SD,
    "one_transit": _BASE + _TRANSIT + _SD,
    "two_transit": _BASE + _PERIPHERY + _TRANSIT + _SD,
}


def _case(tmp_path, pk_type, rows=16, extra=""):
    """Both packages' likelihoods from one likelihood.xml and pkdata file,
    and the rows: the layout's values with jitter 0.03 (seed 1), the last
    with a NaN parameter."""
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=12, seed=7)
    pk = os.path.join(tmp_path, "pkdata.nc")
    trial.save(pk, "T1", "lapatinib")
    xml = os.path.join(tmp_path, "likelihood.xml")
    with open(xml, "w") as f:
        f.write('<bcm_likelihood type="pharmacokinetic_trajectory">\n'
                f'  <pk_model drug="lapatinib" type="{pk_type}" trial="T1" patient="{PATIENT}" '
                f'pkdata_file="{pk}" {extra}/>\n</bcm_likelihood>\n')
    vs, jvs = VariableSet(), JVariableSet()
    for name, logspace, _ in _LAYOUT[pk_type]:
        vs.add_variable(name, logspace=logspace)
        jvs.add_variable(name, logspace=logspace)
    vals = np.array([v for _, _, v in _LAYOUT[pk_type]])
    xs = vals + 0.03 * np.random.default_rng(1).normal(size=(rows, len(vals)))
    xs[-1, 0] = np.nan
    return create_likelihood(xml, vs), jax_create_likelihood(xml, jvs), xs


def test_select_patient_matches_jax():
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=12, seed=7)
    got, ref = select_patient(trial, PATIENT), jax_select_patient(trial, PATIENT)
    assert got.num_patients == 1
    for name in ("time", "patient_ids", "observed", "dose", "dose_after_dose_change",
                 "dose_change_time", "dosing_interval", "intermittent", "interruptions"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    with pytest.raises(ValueError, match="Cannot find patient"):
        select_patient(trial, "99")


@pytest.mark.parametrize("pk_type, rtol", [("one", 1e-10), ("two", 1e-10),
                                           ("one_biphasic_uptake", 1e-10),
                                           ("two_transit", 1e-8)])
def test_log_prob_matches_jax(tmp_path, monkeypatch, pk_type, rtol):
    lik, jlik, xs = _case(str(tmp_path), pk_type)
    assert isinstance(lik.model, SinglePatientPKLikelihood) and lik.model.trial.num_patients == 1
    if "biphasic" in pk_type:
        jax_biphasic_with_ka2(jlik, monkeypatch)
    ref = _jax_rows(jlik.log_prob, xs)
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(got[-1]) and np.isfinite(got).sum() >= 12
    np.testing.assert_allclose(got, ref, rtol=rtol)


def test_one_transit_float32_matches_jax(tmp_path):
    """B2's plain version in float32 against the JAX package's float32 XLA
    DP5, which solve the same problem in another order of operations."""
    lik, jlik, xs = _case(str(tmp_path), "one_transit")
    x32 = xs.astype(np.float32)
    m, jm = lik.model, jlik.model
    with jax.enable_x64(False):
        ref = _jax_rows(jlik.log_prob, x32)
        central_ref = _jax_rows(lambda v: jm._simulate_transit(jm._patient_params(v)[0]), x32)
        central_ref = central_ref[:, 0]
    assert ref.dtype == np.float32
    xt = torch.as_tensor(x32)
    got = lik.log_prob_batched(xt).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= 12
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-3)
    p, _, _ = m._patient_params(xt)
    central = m._central_transit(p, m._tables(xt.device, xt.dtype), xt.dtype)[:, 0].numpy()
    atol = 3e-6 * float(m.trial.dose.min())
    np.testing.assert_allclose(central[fin], central_ref[fin], rtol=3e-4, atol=atol)


def test_fixed_vod(tmp_path):
    """volume_of_distribution in the XML replaces the sampled slot 3, as
    in the JAX package."""
    lik, jlik, xs = _case(str(tmp_path), "one", extra='volume_of_distribution="120.0"')
    assert lik.model.fixed_vod == 120.0
    xs[:, 3] = 7.0  # unused
    ref = _jax_rows(jlik.log_prob, xs)
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    free, _, _ = _case(str(tmp_path), "one")
    xs[:, 3] = np.log10(120.0)
    np.testing.assert_allclose(free.log_prob_batched(torch.as_tensor(xs)).numpy(), got,
                               rtol=1e-12)


def test_patient_attribute(tmp_path):
    """The XML's patient attribute selects the patient; without it the
    factory refuses, as the JAX package's does."""
    lik, _, xs = _case(str(tmp_path), "one")
    assert str(lik.model.trial.patient_ids[0]) == PATIENT
    xml = lik.attrs["_xml_path"]
    with open(xml) as f:
        text = f.read()
    with open(xml, "w") as f:
        f.write(text.replace(f'patient="{PATIENT}"', 'patient="1"'))
    other = create_likelihood(xml, lik.model.varset)
    assert str(other.model.trial.patient_ids[0]) == "1"
    x = torch.as_tensor(xs[:2])
    assert not torch.equal(other.log_prob_batched(x), lik.log_prob_batched(x))
    with open(xml, "w") as f:
        f.write(text.replace(f'patient="{PATIENT}"', ""))
    with pytest.raises(ValueError, match="Patient ID has not been specified"):
        create_likelihood(xml, lik.model.varset)


def test_gradient_of_one_matches_jax(tmp_path):
    """d log-likelihood / d xs of `one` through PropagateOneCompartment
    (B1 forward, its adjoint B1T backward; their plain versions here)
    against jax.grad of the JAX package's log_prob, on 4 rows."""
    lik, jlik, xs = _case(str(tmp_path), "one", rows=5)
    xs = xs[:4]
    ref = _jax_rows(jax.grad(jlik.log_prob), xs)
    x = torch.as_tensor(xs).requires_grad_(True)
    (grad,) = torch.autograd.grad(lik.log_prob_batched(x).sum(), [x])
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-8, atol=1e-10)
