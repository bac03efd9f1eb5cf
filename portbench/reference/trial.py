"""The synthetic PopPK trial and the static tables the likelihood derives from it.

Frozen copies, in numpy and scipy only, of
- `bcm3_tpu_torch/likelihoods/poppk_synth.py` `synthesize_trial` and
  `_propagate_np` (the trial generator), and
- `bcm3_tpu_torch/likelihoods/poppk.py` `_give_treatment_mask`,
  `_simulate_until`, the dosing grid of `PopPKLikelihood.__init__` and
  `_prepare_transit_grid` (the tables),
as of commit d9dda7d00f62b25b3647d9a412570757ad8fc7e2. The generator's
parameters (the population truth, the observation grid, the dose levels)
come from the configuration file instead of constants, so that the
benchmark owns them. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

# reference: LikelihoodPopPKTrajectory.cpp:377-394
DRUG_MOLWEIGHTS = {
    "lapatinib": 581.06,
    "dacomitinib": 469.95,
    "afatinib": 485.94,
    "trametinib": 615.404,
    "mirdametinib": 482.19,
    "selumetinib": 457.68,
}


def _propagate_np(y, dt, ka, ke, kel, kpf, kpb, pk_type):
    """Exact propagation of the linear model over dt by scipy's expm."""
    from scipy.linalg import expm

    if pk_type == "one":
        A = np.array([[-(ka + ke), 0.0, 0.0], [ka, -kel, 0.0], [0.0, 0.0, 0.0]])
    else:
        A = np.array([[-(ka + ke), 0.0, 0.0], [ka, -(kel + kpf), kpb], [0.0, kpf, -kpb]])
    return expm(A * dt) @ y


def synthesize_trial(cfg: dict, seed: int) -> dict:
    """A trial of cfg's shape simulated from the generator's truth, with
    Student-t(4) noise and 10% missing observations, from a numpy stream
    seeded by `seed`. Returns the raw arrays in the layout of the
    reference's pkdata file."""
    gen = cfg["trial_generator"]
    truth = gen["truth"]
    rng = np.random.default_rng(seed)
    P, T = cfg["num_patients"], cfg["num_timepoints"]
    interval, horizon = float(cfg["dosing_interval_hours"]), float(cfg["horizon_hours"])
    drug = cfg["drug"]

    t_day1 = np.asarray(gen["day1_times_hours"], dtype=np.float64)
    t_rest = np.linspace(24.0, horizon, T - len(t_day1))
    time = np.concatenate([t_day1, t_rest])[:T]

    u_abs = rng.uniform(0.02, 0.98, P)
    u_elim = rng.uniform(0.02, 0.98, P)
    from scipy.stats import norm

    ka = 10 ** (truth["mu_abs"] + truth["sigma_abs"] * norm.ppf(u_abs))
    kel = 10 ** (truth["mu_elim"] + truth["sigma_elim"] * norm.ppf(u_elim)) / truth["vod"]

    dose = rng.choice(np.asarray(gen["dose_levels_mg"], dtype=np.float64), P)
    interruptions = np.zeros((P, 29), dtype=bool)
    for j in range(P):
        if rng.uniform() < gen["skip_day_probability"]:
            interruptions[j, rng.integers(2, 14)] = True

    conversion = (1e6 / DRUG_MOLWEIGHTS[drug]) / truth["vod"]
    model = gen["pk_type"]

    def simulate_patient(j):
        y = np.zeros(3)
        y[0] = dose[j]
        K = int(np.ceil(time.max() / interval))
        states = [y.copy()]
        for k in range(1, K + 1):
            y = _propagate_np(y, interval, ka[j], truth["ke"], kel[j], truth["kpf"],
                              truth["kpb"], model)
            day = int((k * interval) // 24)
            if not (day < 29 and interruptions[j, day]):
                y[0] += dose[j]
            states.append(y.copy())
        conc = np.empty(len(time))
        for i, t in enumerate(time):
            k = max(0, int(np.floor((t - 1e-9) / interval)))
            yy = _propagate_np(states[k], t - k * interval, ka[j], truth["ke"], kel[j],
                               truth["kpf"], truth["kpb"], model)
            conc[i] = yy[1] * conversion
        return conc

    observed = np.stack([simulate_patient(j) for j in range(P)])
    noise_sd = truth["sd"] + truth["sd2"] * np.maximum(observed, 0)
    observed = observed + noise_sd * rng.standard_t(4, size=observed.shape)
    observed[rng.uniform(size=observed.shape) < gen["missing_share"]] = np.nan
    return dict(
        time=time,
        patient_ids=np.arange(1, P + 1),
        observed=observed,
        dose=dose,
        dose_after_dose_change=np.full(P, np.nan),
        dose_change_time=np.full(P, np.nan),
        dosing_interval=np.full(P, interval),
        intermittent=np.zeros(P, dtype=np.int32),
        interruptions=interruptions,
    )


def _give_treatment_mask(trial, dose_times):
    """CheckGiveTreatment as a static (P, K) mask."""
    P, K = dose_times.shape
    give = np.ones((P, K), dtype=bool)
    day = np.floor(dose_times / 24.0).astype(int)
    for j in range(P):
        skipped = np.zeros(K, dtype=bool)
        valid = (day[j] >= 0) & (day[j] < trial["interruptions"].shape[1])
        skipped[valid] = trial["interruptions"][j, day[j][valid]]
        give[j] &= ~skipped
        mode = trial["intermittent"][j]
        if mode == 1:
            give[j] &= dose_times[j] - 168.0 * np.floor(dose_times[j] / 168.0) < 120.0
        elif mode == 2:
            give[j] &= dose_times[j] - 672.0 * np.floor(dose_times[j] / 672.0) < 504.0
        elif mode == 3:
            give[j] &= dose_times[j] - 168.0 * np.floor(dose_times[j] / 168.0) < 96.0
    return give


def _simulate_until(trial):
    """Per-patient number of trusted timepoints."""
    P, T = len(trial["patient_ids"]), len(trial["time"])
    until = np.full(P, T, dtype=int)
    for j in range(P):
        if trial["interruptions"][j, 1]:
            for i, t in enumerate(trial["time"]):
                if t >= 24.0:
                    until[j] = i
                    break
        finite = np.where(np.isfinite(trial["observed"][j]))[0]
        if len(finite) and trial["time"][finite[0]] > 15 * 24.0:
            until[j] = 0
    return until


def tables(trial: dict, drug: str) -> dict:
    """The likelihood's static tables of a trial: the dosing grid (K
    intervals), dose amounts, the observation -> interval map, the scored
    and simulated masks, and the merged per-patient stop grid of the
    transit models. numpy arrays."""
    P, T = len(trial["patient_ids"]), len(trial["time"])
    t_max = float(trial["time"].max())
    K = int(np.ceil(t_max / trial["dosing_interval"]).astype(int).max())
    k_idx = np.arange(1, K + 1)
    dose_times = trial["dosing_interval"][:, None] * k_idx[None, :]
    give = _give_treatment_mask(trial, dose_times)
    changed = np.where(np.isfinite(trial["dose_change_time"][:, None]),
                       dose_times >= trial["dose_change_time"][:, None], False)
    amount = np.where(changed, np.nan_to_num(trial["dose_after_dose_change"][:, None]),
                      trial["dose"][:, None])
    dose_amount = np.where(give, amount, 0.0)

    t = trial["time"][None, :]
    interval = trial["dosing_interval"][:, None]
    obs_interval = np.clip(np.floor((t - 1e-9) / interval).astype(int), 0, K - 1)
    obs_offset = np.maximum(t - obs_interval * interval, 0.0)
    until = _simulate_until(trial)
    window = np.arange(T)[None, :] < until[:, None]
    obs_mask = np.isfinite(trial["observed"]) & window

    S = T + K
    grid = np.empty((P, S))
    is_dose = np.zeros((P, S), dtype=bool)
    amt = np.zeros((P, S))
    obs_pos = np.zeros((P, T), dtype=int)
    for j in range(P):
        times = np.concatenate([trial["time"], dose_times[j]])
        flags = np.concatenate([np.zeros(T, bool), np.ones(K, bool)])
        amts = np.concatenate([np.zeros(T), dose_amount[j]])
        order = np.argsort(times, kind="stable")
        grid[j], is_dose[j], amt[j] = times[order], flags[order], amts[order]
        inv = np.empty(S, dtype=int)
        inv[order] = np.arange(S)
        obs_pos[j] = inv[:T]
    return dict(
        K=K,
        initial_dose=trial["dose"].copy(),
        interval=trial["dosing_interval"].copy(),
        dose_amount=dose_amount,
        obs_interval=obs_interval,
        obs_offset=obs_offset,
        observed=trial["observed"],
        obs_mask=obs_mask,
        window_mask=window,
        grid=grid,
        amt=np.where(is_dose, amt, 0.0),
        obs_pos=obs_pos,
        conversion_base=1e6 / DRUG_MOLWEIGHTS[drug],
        atol=float(np.min(trial["dose"])) * 1e-6,
    )
