"""The port's general-PK likelihoods (`pharmaco_single`,
`pharmaco_population`) against the JAX package on the CPU.

Both packages build each likelihood from the same likelihood.xml and
pkdata file through `create_likelihood`, on a 4-patient trial with the
intermittent patterns 1/2/3, an interrupted day, a dose change and a
12-hour dosing interval. The rows are bench.py's values with jitter
(`_bench_batched_loglik`'s 0.03), plus rows that must score -inf.
Tolerances, float64: `build_matrix` exact; `expm` rtol 1e-12 at n = 2 and
5 (the same algorithms) and 1e-9 at n = 9 (`torch.linalg.matrix_exp`
against `jax.scipy.linalg.expm`); `log_prob_batched` against the JAX package's
`log_prob` of each row (`_jax_rows`) rtol 1e-10 at n <= 8 and 1e-9 at
n > 8, with equal -inf sets; float32 against the JAX package's float32
rtol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.likelihoods import pharmaco as jp
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.likelihoods import pharmaco as tp
from bcm3_tpu_torch.likelihoods.poppk_synth import synthesize_trial
from bcm3_tpu_torch.model.variables import VariableSet

P = 4


def _jax_rows(fn, xs):
    """A JAX function of one row (log_prob, expm) on each row, jitted
    once: the function that the JAX registry's vmap(log_prob) batches,
    whose batched trace takes twice as long (7-14 s at n = 5)."""
    f = jax.jit(fn)
    return np.array([f(x) for x in xs])


def _trial():
    """synthesize_trial's 4 x 12 trial with every schedule feature: the
    intermittent patterns 1, 2 and 3, an interrupted day, a dose change
    and a 12-hour interval (K = 58 for that patient)."""
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=12, seed=31)
    trial.intermittent[1:] = [1, 2, 3]
    trial.interruptions[0, 5] = True
    trial.dose_change_time[1] = 100.0
    trial.dose_after_dose_change[1] = 50.0
    trial.dosing_interval[3] = 12.0
    return trial


def test_build_matrix_variants():
    """The seven variants of tests/test_pharmaco.py:59-89, exactly."""
    for cfg_kw, kw in [
        ({}, {}),
        (dict(use_peripheral=True), dict(pf=0.1, pb=0.05)),
        (dict(num_transit=3), dict(tr=0.7)),
        (dict(num_transit=2), dict(tr=0.7)),  # the reference's quirk path
        (dict(use_biphasic=True), dict(da=0.3)),
        (dict(use_metabolite=True), dict(mc=0.2)),
        (dict(use_peripheral=True, num_transit=4, use_metabolite=True),
         dict(pf=0.1, pb=0.05, tr=0.7, mc=0.2)),
    ]:
        args = dict(peripheral_fwd=kw.get("pf", 0.0), peripheral_bwd=kw.get("pb", 0.0),
                    transit_rate=kw.get("tr", 0.0), direct_absorption=kw.get("da", 0.0),
                    metabolite_conversion=kw.get("mc", 0.0))
        ref = jp.build_matrix(jp.PharmacoModelConfig(**cfg_kw), jnp.asarray(0.5),
                              jnp.asarray(0.02), jnp.asarray(0.3), **args)
        rates = torch.tensor([0.5, 0.02, 0.3], dtype=torch.float64)
        got = tp.build_matrix(tp.PharmacoModelConfig(**cfg_kw), *rates, **args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # batched over (rows, patients): each entry is the unbatched call's
    cfg = tp.PharmacoModelConfig(use_peripheral=True, num_transit=3)
    rates = torch.rand(5, 3, 5, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    A = tp.build_matrix(cfg, *rates[..., :3].unbind(-1), peripheral_fwd=rates[..., 3],
                        transit_rate=rates[..., 4])
    one = tp.build_matrix(cfg, *rates[2, 1, :3], peripheral_fwd=rates[2, 1, 3],
                          transit_rate=rates[2, 1, 4])
    assert A.shape == (5, 3, 6, 6)
    assert torch.equal(A[2, 1], one)


@pytest.mark.parametrize("n, rtol", [(2, 1e-12), (5, 1e-12), (9, 1e-9)])
def test_expm_matches_jax(n, rtol):
    """16 system matrices of n compartments at dosing-interval scale."""
    cfg = tp.PharmacoModelConfig(use_peripheral=n > 2, num_transit=n - 3 if n > 2 else 0)
    rng = np.random.default_rng(n)
    r = 10 ** rng.uniform(-2.0, 0.0, (16, 5))
    A = tp.build_matrix(cfg, *torch.as_tensor(r[:, :3]).unbind(-1),
                        peripheral_fwd=torch.as_tensor(r[:, 3]),
                        peripheral_bwd=torch.as_tensor(r[:, 3] / 2),
                        transit_rate=torch.as_tensor(r[:, 4])) * 24.0
    assert A.shape == (16, n, n)
    ref = _jax_rows(jp.expm, A.numpy())
    np.testing.assert_allclose(tp.expm(A).numpy(), ref, rtol=rtol, atol=rtol * 1e-3)


def test_schedule_matches_jax():
    trial = _trial()
    ref = jp.PharmacoSchedule.from_trial(trial)
    got = tp.PharmacoSchedule.from_trial(trial)
    assert ref.dose_amount.shape == (P, 58)
    for name in ("interval", "dose_amount", "obs_interval", "obs_offset", "obs_values",
                 "obs_mask", "obs_times"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    # each schedule feature shows in its patient's row
    assert (ref.dose_amount[:, :29] == 0).sum(axis=1).min() >= 1
    assert (ref.dose_amount[1] == 50.0).any()


# the variables of each case, in prior order: (name, logspace, value)
_BENCH = [("mean_absorption", False, -0.3), ("sigma_absorption", False, 0.2),
          ("mean_clearance", False, np.log10(18.0)),
          ("mean_volume_of_distribution", False, np.log10(120.0))]
_BENCH += [(f"p{j + 1}_absorption", False, 0.3 + 0.02 * j) for j in range(P)]
_BENCH += [("additive_error_standard_deviation", False, 25.0)]
_SINGLE = [("absorption", True, np.log10(0.5)), ("excretion", True, -2.0),
           ("clearance", True, np.log10(18.0)), ("volume_of_distribution", True, np.log10(120.0)),
           ("additive_error_standard_deviation", False, 20.0),
           ("proportional_error_standard_deviation", False, 0.08)]
_RATES = {
    "use_peripheral": [("peripheral_forward_rate", True, np.log10(0.08)),
                       ("peripheral_backward_rate", True, np.log10(0.05))],
    "num_transit": [("mean_transit_time", True, np.log10(2.0))],
    "use_biphasic": [("direct_absorption", True, np.log10(0.3))],
    "use_metabolite": [("metabolite_conversion_rate", True, np.log10(0.1))],
}
# random effects on every base parameter, and per-patient bioavailability
_EFFECTS = [("mean_excretion", False, -2.0), ("sigma_excretion", False, 0.2),
            ("sigma_clearance", False, 0.15), ("sigma_volume_of_distribution", False, 0.1),
            ("sigma_transit_time", False, 0.2)]
_EFFECTS += [(f"p{j + 1}_{name}", False, 0.2 + 0.15 * j)
             for name in ("excretion", "clearance", "volume_of_distribution", "transit_time")
             for j in range(P)]
_EFFECTS += [(f"p{j + 1}_bioavailability", False, 0.9 - 0.05 * j) for j in range(P)]

_XML_FLAGS = {"use_peripheral": 'peripheral_compartment="true"',
              "use_biphasic": 'biphasic_absorption="true"', "use_metabolite": 'metabolite="true"'}


def _case(tmp_path, kind, cfg_kw, effects=False, rows=32):
    """Both packages' likelihoods from one likelihood.xml and pkdata file,
    and the rows: the case's values with jitter 0.03 (seed 0), the last
    with a NaN parameter."""
    trial = _trial()
    pk = os.path.join(tmp_path, "pkdata.nc")
    trial.save(pk, "T1", "lapatinib")
    flags = [_XML_FLAGS[k] for k in cfg_kw if k in _XML_FLAGS]
    if cfg_kw.get("num_transit"):
        flags.append(f'num_transit_compartments="{cfg_kw["num_transit"]}"')
    if effects:
        flags.append('bioavailability="true"')
    if kind == "pharmaco_single":
        flags.append('patient="2"')
    xml = os.path.join(tmp_path, "likelihood.xml")
    with open(xml, "w") as f:
        f.write(f'<bcm_likelihood type="{kind}">\n  <pk_model drug="lapatinib" trial="T1" '
                f'pkdata_file="{pk}" {" ".join(flags)}/>\n</bcm_likelihood>\n')
    spec = list(_SINGLE if kind == "pharmaco_single" else _BENCH)
    for k in cfg_kw:
        spec += _RATES[k]
    if effects:
        spec += _EFFECTS
    vs, jvs = VariableSet(), JVariableSet()
    for name, logspace, _ in spec:
        vs.add_variable(name, logspace=logspace)
        jvs.add_variable(name, logspace=logspace)
    vals = np.array([v for _, _, v in spec])
    xs = vals + 0.03 * np.random.default_rng(0).normal(size=(rows, len(vals)))
    xs[-1, 0] = np.nan
    return create_likelihood(xml, vs), jax_create_likelihood(xml, jvs), xs


_CASES = [{}, dict(use_peripheral=True), dict(use_biphasic=True), dict(use_metabolite=True)]


# the transit cases: the single at n = 9 (matrix_exp), the population at
# n = 5 (small_expm) with random effects on every base parameter and
# bioavailability: both solve through the same code, and the JAX package's
# trace of small_expm at n = 5 (3-7 s) is paid once
@pytest.mark.parametrize(
    "kind, cfg_kw, effects",
    [(kind, c, False) for kind in ("pharmaco_single", "pharmaco_population") for c in _CASES]
    + [("pharmaco_single", dict(num_transit=7), False),
       ("pharmaco_population", dict(num_transit=3), True)],
    ids=lambda v: str(v) if not isinstance(v, dict) else "-".join(v) or "default",
)
def test_log_prob_matches_jax(tmp_path, kind, cfg_kw, effects):
    lik, jlik, xs = _case(str(tmp_path), kind, cfg_kw, effects)
    assert lik.name == kind and lik.model.cfg == tp.PharmacoModelConfig(**cfg_kw)
    ref = _jax_rows(jlik.log_prob, xs)
    got = lik.log_prob_batched(torch.as_tensor(xs))
    assert got.dtype == torch.float64 and got.shape == (32,)
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(got[-1]) and np.isfinite(got).sum() >= 24
    n = lik.model.cfg.num_compartments
    np.testing.assert_allclose(got, ref, rtol=1e-10 if n <= 8 else 1e-9)


def test_log_prob_chunks_rows(tmp_path, monkeypatch):
    """At n > 2 the rows are evaluated EXPM_CHUNK_ROWS at a time, with the
    same results."""
    lik, _, xs = _case(str(tmp_path), "pharmaco_population", dict(use_peripheral=True))
    whole = lik.log_prob_batched(torch.as_tensor(xs))
    monkeypatch.setattr(tp, "EXPM_CHUNK_ROWS", 5)
    assert torch.equal(lik.log_prob_batched(torch.as_tensor(xs)), whole)


def test_float32_matches_jax_float32(tmp_path):
    """bench.py's configuration in float32 against the JAX package's
    float32: the same finite rows, rtol 1e-4."""
    lik, jlik, xs = _case(str(tmp_path), "pharmaco_population", {}, rows=64)
    with jax.enable_x64(False):
        ref = _jax_rows(jlik.log_prob, xs.astype(np.float32))
    assert ref.dtype == np.float32
    got = lik.log_prob_batched(torch.as_tensor(xs, dtype=torch.float32)).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() == 63
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4)


def test_simulate_functions_match_jax(tmp_path):
    """simulate_patient_trajectory at requested times (a dose time, inside
    intervals, past the horizon) against the JAX package's, on the patient
    with the 12-hour interval; simulate_trajectories equals it at the
    observation times; observed as the JAX package's. The single
    likelihood's simulate_trajectory and simulate likewise."""
    lik, jlik, xs = _case(str(tmp_path), "pharmaco_population", {}, rows=2)
    m, jm = lik.model, jlik.model
    times = np.array([0.0, 5.0, 12.0, 100.5, 400.0, 800.0])
    x = torch.as_tensor(xs)
    conc, traj, ok = m.simulate_patient_trajectory(x, 3, times)
    assert traj.shape == (2, 6, 2) and ok[0] and not ok[1]
    jc, jt, _ = jax.jit(lambda v: jm.simulate_patient_trajectory(v, 3, times))(xs[0])
    np.testing.assert_allclose(traj[0].numpy(), np.asarray(jt), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(conc[0].numpy(), np.asarray(jc), rtol=1e-10)
    obs_t, obs = m.observed(3)
    np.testing.assert_array_equal(obs, jm.observed(3)[1])
    at_obs, _, _ = m.simulate_patient_trajectory(x, 3, obs_t)
    all_conc, all_ok = m.simulate_trajectories(x)
    assert all_ok.shape == (2, P) and all_ok[0].all() and not all_ok[1].any()
    torch.testing.assert_close(all_conc[0, 3], at_obs[0], rtol=1e-12, atol=0.0)

    lik, jlik, xs = _case(str(tmp_path), "pharmaco_single", {}, rows=2)
    m, jm = lik.model, jlik.model
    conc, traj, ok = m.simulate_trajectory(torch.as_tensor(xs), times)
    jc, jt, _ = jax.jit(lambda v: jm.simulate_trajectory(v, times))(xs[0])
    assert ok[0] and not ok[1]
    np.testing.assert_allclose(traj[0].numpy(), np.asarray(jt), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(conc[0].numpy(), np.asarray(jc), rtol=1e-10)
    obs_t, obs = m.observed()
    np.testing.assert_array_equal(obs, jm.observed()[1])
    sim, sim_ok = m.simulate(torch.as_tensor(xs))
    at_obs, _, _ = m.simulate_trajectory(torch.as_tensor(xs), obs_t)
    assert sim_ok[0] and not sim_ok[1]
    torch.testing.assert_close(sim[0], at_obs[0], rtol=1e-12, atol=0.0)


def test_bare_type_and_missing_patient(tmp_path):
    """The XML types need their XML; the single type needs a patient."""
    vs = VariableSet()
    vs.add_variable("additive_error_standard_deviation")
    with pytest.raises(ValueError, match="requires an XML definition"):
        create_likelihood("pharmaco_population", vs)
    lik, _, _ = _case(str(tmp_path), "pharmaco_single", {}, rows=1)
    xml = lik.attrs["_xml_path"]
    with open(xml) as f:
        text = f.read()
    with open(xml, "w") as f:
        f.write(text.replace('patient="2"', ""))
    with pytest.raises(ValueError, match="Patient ID"):
        create_likelihood(xml, vs)


_CLI_CONFIG = """[sampler]
num_samples=12
use_every_nth=1
rngseed=5

[ptmhsampler]
num_chains=2
num_ensembles=8
proposal_type=global_covariance
adapt_proposal_samples=6
adapt_proposal_times=1
"""


def test_cli_run_writes_the_r_schema(tmp_path):
    """The port's CLI (port only) on a pharmaco_population config on the
    CPU: output.nc loads through the JAX package's R-side loader, and each
    stored row's log-likelihood is the likelihood's at its values."""
    from bcm3_tpu.io.hdf5r_compat import bcm3_load_results
    from bcm3_tpu_torch import cli
    from bcm3_tpu_torch.io.output import load_results

    d = str(tmp_path)
    lik, _, _ = _case(d, "pharmaco_population", {}, rows=1)
    bounds = {"mean_absorption": (-1.3, 0.7), "sigma_absorption": (0.01, 1.0),
              "mean_clearance": (0.5, 2.0), "mean_volume_of_distribution": (1.5, 2.7),
              "additive_error_standard_deviation": (1.0, 100.0)}
    with open(os.path.join(d, "prior.xml"), "w") as f:
        f.write("<prior>\n")
        for name, _, _ in _BENCH:
            lo, hi = bounds.get(name, (0.0, 1.0))
            f.write(f'  <variable name="{name}" distribution="uniform" lower="{lo}" '
                    f'upper="{hi}"/>\n')
        f.write("</prior>\n")
    with open(os.path.join(d, "config.txt"), "w") as f:
        f.write(_CLI_CONFIG)
    argv = ["-c", os.path.join(d, "config.txt"), "--prior", os.path.join(d, "prior.xml"),
            "--likelihood", lik.attrs["_xml_path"], "--output.folder", os.path.join(d, "out"),
            "--device", "cpu", "--dtype", "float64"]
    assert cli.main(argv) == 0
    model = bcm3_load_results(d, "out")
    post = model["posterior"]
    assert post["samples"].shape == (len(_BENCH), 2, 12 * 8)  # [var, temp, sample]
    assert np.isfinite(post["lposterior"][-1]).all()
    res = load_results(os.path.join(d, "out", "output.nc"))
    rows = torch.as_tensor(res["samples"][:, -1, :])
    np.testing.assert_allclose(lik.log_prob_batched(rows).numpy(), res["log_likelihood"][:, -1],
                               rtol=1e-10)
