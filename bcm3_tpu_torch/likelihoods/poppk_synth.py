"""Synthetic PopPK trial generation.

The reference repository ships no PK data files (the pkdata NetCDF is
external clinical data), so benchmarks and tests generate synthetic
trials with known ground-truth parameters in the exact layout
LikelihoodPopPKTrajectory reads (reference:
src/likelihoods/LikelihoodPopPKTrajectory.cpp:90-160).
"""

from __future__ import annotations

import numpy as np

from bcm3_tpu_torch.likelihoods.poppk import DRUG_MOLWEIGHTS, PopPKTrial
from bcm3_tpu_torch.model.variables import VariableSet


def synthesize_trial(
    num_patients: int = 16,
    num_timepoints: int = 24,
    drug: str = "lapatinib",
    dosing_interval: float = 24.0,
    horizon_hours: float = 14 * 24.0,
    seed: int = 0,
    pk_type: str = "one",
) -> tuple[PopPKTrial, dict]:
    """Simulate a trial from the one/two-compartment model with known
    population parameters. Returns (trial, truth)."""
    rng = np.random.default_rng(seed)
    P, T = num_patients, num_timepoints

    # observation grid: dense on day 1, then sparser
    t_day1 = np.array([0.5, 1.0, 2.0, 4.0, 8.0, 12.0])
    t_rest = np.linspace(24.0, horizon_hours, T - len(t_day1))
    time = np.concatenate([t_day1, t_rest])[:T]

    truth = {
        "mu_abs": -0.3,  # log10 absorption mean
        "sigma_abs": 0.2,
        "mu_elim": 0.3,  # log10 elimination mean (pre-vod division)
        "sigma_elim": 0.15,
        "ke": 0.03,
        "vod": 120.0,
        "kpf": 0.08,
        "kpb": 0.05,
        "sd": 20.0,
        "sd2": 0.08,
    }

    u_abs = rng.uniform(0.02, 0.98, P)
    u_elim = rng.uniform(0.02, 0.98, P)
    from scipy.stats import norm

    ka = 10 ** (truth["mu_abs"] + truth["sigma_abs"] * norm.ppf(u_abs))
    kel = 10 ** (truth["mu_elim"] + truth["sigma_elim"] * norm.ppf(u_elim)) / truth[
        "vod"
    ]

    dose = rng.choice([100.0, 150.0, 200.0], P)
    interruptions = np.zeros((P, 29), dtype=bool)
    # a few random skipped days (not day 1, which truncates simulation)
    for j in range(P):
        if rng.uniform() < 0.3:
            interruptions[j, rng.integers(2, 14)] = True

    conversion = (1e6 / DRUG_MOLWEIGHTS[drug]) / truth["vod"]

    # simulate with the closed-form propagator in numpy (independent of
    # the likelihood implementation under test)
    def simulate_patient(j):
        y = np.zeros(3)
        y[0] = dose[j]
        K = int(np.ceil(time.max() / dosing_interval))
        states = [y.copy()]
        a = ka[j] + truth["ke"]
        for k in range(1, K + 1):
            y = _propagate_np(
                y, dosing_interval, ka[j], truth["ke"], kel[j],
                truth["kpf"], truth["kpb"], pk_type,
            )
            t_dose = k * dosing_interval
            day = int(t_dose // 24)
            if not (day < 29 and interruptions[j, day]):
                y[0] += dose[j]
            states.append(y.copy())
        conc = np.empty(len(time))
        for i, t in enumerate(time):
            k = max(0, int(np.floor((t - 1e-9) / dosing_interval)))
            dt = t - k * dosing_interval
            yy = _propagate_np(
                states[k], dt, ka[j], truth["ke"], kel[j],
                truth["kpf"], truth["kpb"], pk_type,
            )
            conc[i] = yy[1] * conversion
        return conc

    observed = np.stack([simulate_patient(j) for j in range(P)])
    noise_sd = truth["sd"] + truth["sd2"] * np.maximum(observed, 0)
    observed = observed + noise_sd * rng.standard_t(4, size=observed.shape)
    # missing values
    observed[rng.uniform(size=observed.shape) < 0.1] = np.nan

    trial = PopPKTrial(
        time=time,
        patient_ids=np.arange(1, P + 1),
        observed=observed,
        dose=dose,
        dose_after_dose_change=np.full(P, np.nan),
        dose_change_time=np.full(P, np.nan),
        dosing_interval=np.full(P, dosing_interval),
        intermittent=np.zeros(P, dtype=np.int32),
        interruptions=interruptions,
    )
    truth["u_abs"] = u_abs
    truth["u_elim"] = u_elim
    truth["ka"] = ka
    truth["kel"] = kel
    return trial, truth


def _propagate_np(y, dt, ka, ke, kel, kpf, kpb, pk_type):
    """Exact numpy propagation via scipy expm (oracle-grade)."""
    from scipy.linalg import expm

    if pk_type == "one":
        A = np.array([[-(ka + ke), 0.0, 0.0], [ka, -kel, 0.0], [0.0, 0.0, 0.0]])
    else:
        A = np.array(
            [
                [-(ka + ke), 0.0, 0.0],
                [ka, -(kel + kpf), kpb],
                [0.0, kpf, -kpb],
            ]
        )
    return expm(A * dt) @ y


BIPHASIC = ("one_biphasic_uptake", "two_biphasic_uptake")
# The biphasic model reads 7 structural values by position (kpf and kpb
# at 4 and 5) and its switch time and second absorption rate by name
# (bcm3_tpu/likelihoods/poppk.py:237-245, :362-389), with no slot left
# for an eighth: mean_absorption2 takes slot 5, so kpb and ka2 are one
# sampled rate here.
BIPHASIC_NAMES = ["k_periphery_fwd", "mean_absorption2", "biphasic_uptake_time"]


def make_poppk_varset(num_patients: int, pk_type: str = "one") -> VariableSet:
    """Prior variable layout matching the reference's expectations
    (reference: LikelihoodPopPKTrajectory.cpp:127, 283-310): structural
    params (log10 space), 2 population sds, 2 uniforms per patient,
    standard_deviation(+2)."""
    vs = VariableSet()
    names = ["mean_absorption", "mean_excretion", "mean_elimination",
             "volume_of_distribution"]
    if pk_type == "two":
        names += ["k_periphery_fwd", "k_periphery_bwd"]
    if pk_type in BIPHASIC:
        names += BIPHASIC_NAMES
    if pk_type == "one_transit":
        names += ["n_transit", "mean_transit_time"]
    if pk_type == "two_transit":
        names += ["k_periphery_fwd", "k_periphery_bwd", "n_transit",
                  "mean_transit_time"]
    # de-duplicate while preserving order (two_transit composes both lists)
    seen = set()
    names = [n for n in names if not (n in seen or seen.add(n))]
    # mean_absorption / mean_elimination are used RAW as log10-space means of
    # the population distribution (reference: cpp:283-287); the other rates
    # go through TransformVariable, so they carry the log10 output transform.
    raw_names = {"mean_absorption", "mean_elimination", "biphasic_uptake_time"}
    for n in names:
        vs.add_variable(n, logspace=n not in raw_names)
    vs.add_variable("population_sd_absorption")
    vs.add_variable("population_sd_elimination")
    for j in range(num_patients):
        vs.add_variable(f"patient_abs_{j}")
        vs.add_variable(f"patient_elim_{j}")
    vs.add_variable("standard_deviation", logspace=True)
    vs.add_variable("standard_deviation2", logspace=True)
    return vs


def write_poppk_prior_xml(path: str, num_patients: int, pk_type: str = "one"):
    """Emit a prior.xml for the synthetic trial (same schema the reference
    parses, reference: VariableSet.cpp:16-95)."""
    lines = ['<?xml version="1.0" encoding="utf-8"?>', "<prior>"]

    def var(name, dist, logspace=False, **kw):
        attrs = " ".join(f'{k}="{v}"' for k, v in kw.items())
        ls = ' logspace="true"' if logspace else ""
        lines.append(f'  <variable name="{name}" distribution="{dist}"{ls} {attrs}/>')

    var("mean_absorption", "uniform", lower=-2.0, upper=1.0)
    var("mean_excretion", "uniform", logspace=True, lower=-4.0, upper=0.0)
    var("mean_elimination", "uniform", lower=-1.0, upper=1.5)
    var("volume_of_distribution", "uniform", logspace=True, lower=1.0, upper=3.0)
    if pk_type in ("two", "two_transit"):
        var("k_periphery_fwd", "uniform", logspace=True, lower=-3.0, upper=0.0)
        var("k_periphery_bwd", "uniform", logspace=True, lower=-3.0, upper=0.0)
    if pk_type in BIPHASIC:
        var("k_periphery_fwd", "uniform", logspace=True, lower=-3.0, upper=0.0)
        var("mean_absorption2", "uniform", logspace=True, lower=-3.0, upper=0.0)
        var("biphasic_uptake_time", "uniform", lower=0.5, upper=6.0)
    if pk_type == "two_transit" or pk_type == "one_transit":
        var("n_transit", "uniform", logspace=True, lower=0.0, upper=1.0)
        var("mean_transit_time", "uniform", logspace=True, lower=-1.0, upper=1.5)
    var("population_sd_absorption", "half_cauchy", scale=0.3)
    var("population_sd_elimination", "half_cauchy", scale=0.3)
    for j in range(num_patients):
        var(f"patient_abs_{j}", "uniform", lower=0.0, upper=1.0)
        var(f"patient_elim_{j}", "uniform", lower=0.0, upper=1.0)
    var("standard_deviation", "uniform", logspace=True, lower=0.0, upper=2.5)
    var("standard_deviation2", "uniform", logspace=True, lower=-3.0, upper=0.5)
    lines.append("</prior>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_poppk_likelihood_xml(
    path: str, pkdata_file: str, trial: str = "TRIAL1",
    drug: str = "lapatinib", pk_type: str = "one",
):
    with open(path, "w") as f:
        f.write(
            f"""<?xml version="1.0" encoding="utf-8"?>
<bcm_likelihood type="pop_pk_trajectory">
  <pk_model drug="{drug}" type="{pk_type}" trial="{trial}" pkdata_file="{pkdata_file}"/>
</bcm_likelihood>
"""
        )


def truth_to_values(truth: dict, varset: VariableSet, pk_type: str = "one"):
    """Assemble the flat parameter vector for the ground-truth parameters."""
    import numpy as np

    P = len(truth["u_abs"])
    vals = []
    vals.append(truth["mu_abs"])  # mean_absorption (raw log10 mean)
    vals.append(np.log10(truth["ke"]))  # mean_excretion (logspace)
    vals.append(truth["mu_elim"])  # mean_elimination (raw log10 mean)
    vals.append(np.log10(truth["vod"]))  # volume_of_distribution (logspace)
    if pk_type in ("two", "two_transit"):
        vals.append(np.log10(truth["kpf"]))
        vals.append(np.log10(truth["kpb"]))
    vals.append(truth["sigma_abs"])
    vals.append(truth["sigma_elim"])
    for j in range(P):
        vals.append(truth["u_abs"][j])
        vals.append(truth["u_elim"][j])
    vals.append(np.log10(truth["sd"]))
    vals.append(np.log10(truth["sd2"]))
    assert len(vals) == varset.num_variables
    return np.array(vals)
