"""Population pharmacokinetic trajectory likelihood on torch tensors.

Counterpart of bcm3_tpu/likelihoods/poppk.py (reference:
src/likelihoods/LikelihoodPopPKTrajectory.cpp). The whole (chains x
patients) population is scored in one batched call, `log_prob_batched`,
which is the only evaluation entry. The central compartment comes from
one of four paths, by structural model:

- `one`: kernel B1 (ops/poppk_kernels.py) runs the exact dosing-interval
  recurrence, then every observation is propagated in closed form from the
  start of its interval (bcm3_tpu/likelihoods/poppk.py:763-800);
- `two` and the biphasic models (`one_biphasic_uptake` and
  `two_biphasic_uptake` both mean the two-compartment biphasic model, the
  reference's quirk): the same recurrence in closed form, batched over
  (chains, patients) with a loop over the K intervals (`_simulate_linear`,
  bcm3_tpu/likelihoods/poppk.py:397-469);
- `one_transit`: kernel B2 (ops/transit_kernels.py) runs the budgeted DP5
  solve over the merged stop grid in float32, as the JAX package's Pallas
  path does (bcm3_tpu/likelihoods/poppk.py:646-712);
- `two_transit`: the budgeted DP5 solve of ode/dp5.py in the dtype of the
  parameters over lanes (chain, patient), as the JAX package's XLA path
  does (bcm3_tpu/likelihoods/poppk.py:500-613);
- both transit models in the gradient mode (`gradient_mode`, which the
  gradient samplers set around their evaluations): that XLA path's solve
  with its Jacobian in the lane rates, kernel B2J
  (ops/transit_tangent_kernels.py `TransitCentral`), differentiable, in
  the parameters' dtype: the JAX package's gradient samplers evaluate and
  differentiate `log_prob`, whose transit solve is that path's.

All end in the same scoring: a Student-t(nu=4) residual with additive +
proportional sd over the (B, P, T) observation grid, the double-where for
unscored entries, and -inf for any NaN inside the simulated window
(reference: LikelihoodPopPKTrajectory.cpp:400-424). The host-side tables
(dosing schedule, observation -> interval map, transit grid) are built
exactly as in the JAX package. `simulate_trajectories` and
`simulate_states` give the trajectories themselves (every model through
`_simulate_linear` or the DP5 path, as the JAX package's do).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from bcm3_tpu_torch.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)
from bcm3_tpu_torch.ode import linear_pk
from bcm3_tpu_torch.ode.dp5 import solve_at_times_budget
from bcm3_tpu_torch.ops.poppk_kernels import PropagateOneCompartment
from bcm3_tpu_torch.ops.transit_kernels import transit_solve
from bcm3_tpu_torch.ops.transit_tangent_kernels import (
    RATES,
    TRANSIT_LOG_FLOOR,
    TransitCentral,
    log_floor_is_zero,
)

# reference: LikelihoodPopPKTrajectory.cpp:377-394
DRUG_MOLWEIGHTS = {
    "lapatinib": 581.06,
    "dacomitinib": 469.95,
    "afatinib": 485.94,
    "trametinib": 615.404,
    "mirdametinib": 482.19,
    "selumetinib": 457.68,
}

_LOG_TNU4_C = -0.9808292530117262  # log(Gamma(2.5)/(Gamma(2) sqrt(4 pi)))

TRANSIT_TYPES = ("one_transit", "two_transit")


def log_pdf_tnu4(x, mu, sigma):
    """Student-t nu=4 log-density (reference: ProbabilityDistributions.cpp:216-224)."""
    xn = (x - mu) / sigma
    return _LOG_TNU4_C - 2.5 * torch.log1p(0.25 * xn * xn) - torch.log(sigma)


@dataclass
class PopPKTrial:
    """Observed trial data (layout mirrors the reference pkdata NetCDF)."""

    time: np.ndarray  # (T,) hours
    patient_ids: np.ndarray  # (P,)
    observed: np.ndarray  # (P, T) concentrations in nM; NaN = missing
    dose: np.ndarray  # (P,) mg
    dose_after_dose_change: np.ndarray  # (P,) NaN if no change
    dose_change_time: np.ndarray  # (P,) NaN if no change
    dosing_interval: np.ndarray  # (P,) hours
    intermittent: np.ndarray  # (P,) int {0,1,2,3}
    interruptions: np.ndarray  # (P, 29) bool, day-granularity skips

    @property
    def num_patients(self) -> int:
        return len(self.patient_ids)

    @classmethod
    def load(cls, filename: str, trial: str, drug: str) -> "PopPKTrial":
        """Read the reference pkdata layout from HDF5/NetCDF-4 (h5py) with
        a NetCDF-3 fallback (scipy)."""
        data = {}
        names = [
            "time",
            "patients",
            f"{drug}_plasma_concentration",
            f"{drug}_dose",
            f"{drug}_dose_after_dose_change",
            f"{drug}_dose_change_time",
            f"{drug}_dosing_interval",
            f"{drug}_intermittent",
            "treatment_interruptions",
        ]
        try:
            import h5py

            with h5py.File(filename, "r") as f:
                g = f[trial]
                for name in names:
                    data[name] = np.asarray(g[name])
        except OSError:
            from scipy.io import netcdf_file

            with netcdf_file(filename, "r", mmap=False) as f:
                # NetCDF-3 files have no groups; variables are <trial>_<name>
                for name in names:
                    data[name] = np.asarray(f.variables[f"{trial}_{name}"][:])
        get = data.__getitem__
        return cls(
            time=get("time").astype(np.float64),
            patient_ids=get("patients"),
            observed=get(f"{drug}_plasma_concentration").astype(np.float64),
            dose=get(f"{drug}_dose").astype(np.float64),
            dose_after_dose_change=get(f"{drug}_dose_after_dose_change").astype(
                np.float64
            ),
            dose_change_time=get(f"{drug}_dose_change_time").astype(np.float64),
            dosing_interval=get(f"{drug}_dosing_interval").astype(np.float64),
            intermittent=get(f"{drug}_intermittent").astype(np.int32),
            interruptions=get("treatment_interruptions").astype(bool),
        )

    def save(self, filename: str, trial: str, drug: str):
        import h5py

        with h5py.File(filename, "w") as f:
            g = f.create_group(trial)
            g.create_dataset("time", data=self.time)
            g.create_dataset("patients", data=self.patient_ids)
            g.create_dataset(f"{drug}_plasma_concentration", data=self.observed)
            g.create_dataset(f"{drug}_dose", data=self.dose)
            g.create_dataset(
                f"{drug}_dose_after_dose_change", data=self.dose_after_dose_change
            )
            g.create_dataset(f"{drug}_dose_change_time", data=self.dose_change_time)
            g.create_dataset(f"{drug}_dosing_interval", data=self.dosing_interval)
            g.create_dataset(f"{drug}_intermittent", data=self.intermittent)
            g.create_dataset(
                "treatment_interruptions", data=self.interruptions.astype(np.uint32)
            )


def _give_treatment_mask(trial: PopPKTrial, dose_times: np.ndarray) -> np.ndarray:
    """CheckGiveTreatment as a static (P, K) mask
    (reference: LikelihoodPopPKTrajectory.cpp:643-669)."""
    P, K = dose_times.shape
    give = np.ones((P, K), dtype=bool)
    day = np.floor(dose_times / 24.0).astype(int)
    for j in range(P):
        skipped = np.zeros(K, dtype=bool)
        valid_day = (day[j] >= 0) & (day[j] < trial.interruptions.shape[1])
        skipped[valid_day] = trial.interruptions[j, day[j][valid_day]]
        give[j] &= ~skipped
        if trial.intermittent[j] == 1:
            tw = dose_times[j] - 7 * 24.0 * np.floor(dose_times[j] / (7 * 24.0))
            give[j] &= tw < 5 * 24.0
        elif trial.intermittent[j] == 2:
            tc = dose_times[j] - 28 * 24.0 * np.floor(dose_times[j] / (28 * 24.0))
            give[j] &= tc < 21 * 24.0
        elif trial.intermittent[j] == 3:
            tw = dose_times[j] - 7 * 24.0 * np.floor(dose_times[j] / (7 * 24.0))
            give[j] &= tw < 4 * 24.0
    return give


def _simulate_until(trial: PopPKTrial) -> np.ndarray:
    """Per-patient number of trusted timepoints
    (reference: LikelihoodPopPKTrajectory.cpp:163-186)."""
    P = trial.num_patients
    T = len(trial.time)
    until = np.full(P, T, dtype=int)
    for j in range(P):
        if trial.interruptions[j, 1]:
            # unknown interruption schedule from day 2: first day only
            for i, t in enumerate(trial.time):
                if t >= 24.0:
                    until[j] = i
                    break
        obs = trial.observed[j]
        finite_ix = np.where(np.isfinite(obs))[0]
        if len(finite_ix) and trial.time[finite_ix[0]] > 15 * 24.0:
            until[j] = 0
    return until


class PopPKLikelihood:
    """Batched PopPK log-likelihood over the full patient population."""

    # the prior variables that `_patient_params` reads by name, by model
    NAMED_PARAMS = {
        "two_biphasic": ("biphasic_uptake_time", "mean_absorption2"),
        "one_transit": ("n_transit", "mean_transit_time"),
        "two_transit": ("n_transit", "mean_transit_time"),
    }

    def __init__(
        self,
        varset: VariableSet,
        trial: PopPKTrial,
        pk_type: str,
        drug: str,
        fixed_vod: float = np.nan,
        fixed_periphery_fwd: float = np.nan,
        fixed_periphery_bwd: float = np.nan,
        solver_trips: int = 768,
    ):
        self.varset = varset
        self.trial = trial
        self.drug = drug
        # whole-trajectory adaptive-step budget for the transit-model DP5
        # solve (a static trip count, as in the JAX package)
        self.solver_trips = int(solver_trips)
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")

        # reference quirk preserved: both biphasic names map to the
        # two-compartment biphasic model (LikelihoodPopPKTrajectory.cpp:70-84)
        aliases = {
            "one": "one",
            "two": "two",
            "one_biphasic_uptake": "two_biphasic",
            "two_biphasic_uptake": "two_biphasic",
            "one_transit": "one_transit",
            "two_transit": "two_transit",
        }
        if pk_type not in aliases:
            raise ValueError(f"Invalid PK model type '{pk_type}'")
        self.pk_type = aliases[pk_type]
        self.n_states = 2 if self.pk_type in ("one", "one_transit") else 3
        # reference: LikelihoodPopPKTrajectory.cpp:102-119
        self.num_pk_params = {
            "one": 4,
            "two": 6,
            "two_biphasic": 7,
            "one_transit": 6,
            "two_transit": 8,
        }[self.pk_type]
        self.fixed_vod = fixed_vod
        self.fixed_periphery_fwd = fixed_periphery_fwd
        self.fixed_periphery_bwd = fixed_periphery_bwd

        P, T = trial.num_patients, len(trial.time)
        fixed_count = int(np.isfinite(fixed_vod)) + int(
            np.isfinite(fixed_periphery_fwd)
        ) + int(np.isfinite(fixed_periphery_bwd))
        expected = self.num_pk_params - fixed_count + 2 * (P + 1) + 2
        # a subclass with another variable layout (the single-patient
        # likelihood, likelihoods/pk_single.py) sets _skip_varset_check
        if not getattr(self, "_skip_varset_check", False) and varset.num_variables != expected:
            raise ValueError(
                f"Incorrect number of variables in prior: got "
                f"{varset.num_variables}, expected {expected}"
            )

        self.sd_ix = varset.index_of("standard_deviation")
        self._named_ix = {}
        for name in (
            "n_transit",
            "mean_transit_time",
            "biphasic_uptake_time",
            "mean_absorption2",
        ):
            if name in varset.names:
                self._named_ix[name] = varset.index_of(name)
        for name in self.NAMED_PARAMS.get(self.pk_type, ()):
            if name not in self._named_ix:
                raise ValueError(f"pk_type '{pk_type}' needs a prior variable named '{name}'")

        self.simulate_until = _simulate_until(trial)
        self.conversion_base = 1e6 / DRUG_MOLWEIGHTS[drug]

        # static dosing grid: K intervals cover the full simulated horizon
        t_max = float(trial.time.max())
        k_per_patient = np.ceil(t_max / trial.dosing_interval).astype(int)
        self.K = int(k_per_patient.max())
        k_idx = np.arange(1, self.K + 1)
        # dose event times (P, K): t = k * interval (the t=0 dose is the
        # initial condition, reference: LikelihoodPopPKTrajectory.cpp:369-374)
        self.dose_times = trial.dosing_interval[:, None] * k_idx[None, :]
        give = _give_treatment_mask(trial, self.dose_times)
        # dose amount at each event: changes after dose_change_time
        changed = np.where(
            np.isfinite(trial.dose_change_time[:, None]),
            self.dose_times >= trial.dose_change_time[:, None],
            False,
        )
        amount = np.where(
            changed,
            np.nan_to_num(trial.dose_after_dose_change[:, None]),
            trial.dose[:, None],
        )
        self.dose_amount = np.where(give, amount, 0.0)  # (P, K)
        self.give_dose = give

        # observation -> interval mapping (pre-dose at exact event times)
        t = trial.time[None, :]  # (1, T)
        interval = trial.dosing_interval[:, None]
        k_obs = np.floor((t - 1e-9) / interval).astype(int)
        self.obs_interval = np.clip(k_obs, 0, self.K - 1)  # (P, T)
        self.obs_offset = np.maximum(t - self.obs_interval * interval, 0.0)  # (P, T)

        # mask of scored observations and of the simulated window
        idx = np.arange(T)[None, :]
        self.window_mask = idx < self.simulate_until[:, None]  # (P, T)
        self.obs_mask = np.isfinite(trial.observed) & self.window_mask
        # the t=0 dose is unconditional (reference: initial_conditions[0] = dose,
        # LikelihoodPopPKTrajectory.cpp:369-374 — no CheckGiveTreatment at t=0)
        self.initial_dose = trial.dose.copy()
        # biphasic: the ka1->ka2 switch only happens in intervals whose
        # starting dose was actually given (reference: TreatmentCallbackBiphasic
        # leaves biphasic_switch false over skipped intervals)
        self.interval_start_given = np.concatenate(
            [np.ones((P, 1), dtype=bool), self.dose_amount[:, : self.K - 1] > 0],
            axis=1,
        )  # (P, K): interval k starts with a dose?

        if self.pk_type in TRANSIT_TYPES:
            self._prepare_transit_grid()
        self._tensors = {}
        # the gradient samplers' switch (hmc.LogPosterior sets it around its
        # evaluations): the transit models then follow the JAX package's
        # `log_prob` (its XLA path, which JAX differentiates) through kernel
        # B2J with its Jacobian, in the rows' dtype; outside it one_transit
        # runs B2 (the JAX package's batched Pallas path) in float32
        self.gradient_mode = False

    # ------------------------------------------------------------------

    def _prepare_transit_grid(self):
        """Merge observation and dosing times into one static sorted grid
        per patient, with event flags at dosing positions."""
        P, T = self.trial.num_patients, len(self.trial.time)
        S = T + self.K
        grid = np.empty((P, S))
        is_dose = np.zeros((P, S), dtype=bool)
        dose_amt = np.zeros((P, S))
        obs_pos = np.zeros((P, T), dtype=int)
        for j in range(P):
            times = np.concatenate([self.trial.time, self.dose_times[j]])
            flags = np.concatenate([np.zeros(T, bool), np.ones(self.K, bool)])
            amts = np.concatenate([np.zeros(T), self.dose_amount[j]])
            # stable sort keeps obs before a dose at identical times
            order = np.argsort(times, kind="stable")
            grid[j] = times[order]
            is_dose[j] = flags[order]
            dose_amt[j] = amts[order]
            inv = np.empty(S, dtype=int)
            inv[order] = np.arange(S)
            obs_pos[j] = inv[:T]
        self.tr_grid = grid
        self.tr_is_dose = is_dose
        self.tr_dose_amt = dose_amt
        self.tr_obs_pos = obs_pos

    def _tables(self, device, dtype) -> dict:
        """The static host tables as tensors, made once per (device, dtype)."""
        key = (str(device), dtype)
        if key not in self._tensors:

            def f(a, dt=dtype):
                return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

            tb = {
                "initial_dose": f(self.initial_dose),
                "interval": f(self.trial.dosing_interval),
                "dose_amount": f(self.dose_amount).contiguous(),
                "obs_interval": f(self.obs_interval, torch.long),
                "obs_offset": f(self.obs_offset),
                "observed": f(self.trial.observed),
                "obs_mask": f(self.obs_mask, torch.bool),
                "window_mask": f(self.window_mask, torch.bool),
                "start_given": f(self.interval_start_given, torch.bool),
            }
            if self.pk_type in TRANSIT_TYPES:
                tb["grid"] = f(self.tr_grid)
                tb["amt"] = f(np.where(self.tr_is_dose, self.tr_dose_amt, 0.0))
                tb["obs_pos"] = f(self.tr_obs_pos, torch.long)
            if self.pk_type == "one_transit":
                f32 = torch.float32
                tb["tr_grid"] = f(self.tr_grid, f32)
                tb["tr_amt"] = f(
                    np.where(self.tr_is_dose, self.tr_dose_amt, 0.0), f32
                )
                tb["tr_dose0"] = f(self.initial_dose, f32)
            self._tensors[key] = tb
        return self._tensors[key]

    def _transform(self, ix: int, v):
        """Per-variable output transform (reference: VariableSet.cpp:97-112)."""
        t = self.varset.transforms[ix]
        if t == TRANSFORM_LOG:
            return torch.exp(v)
        if t == TRANSFORM_LOG10:
            return torch.pow(10.0, v)
        if t == TRANSFORM_LOGIT:
            return torch.sigmoid(v)
        return v

    def _patient_params(self, xs):
        """Population -> per-patient parameter transforms for a batch
        xs (B, D) (reference: LikelihoodPopPKTrajectory.cpp:283-310).
        Per-patient entries are (B, P), per-chain entries (B,)."""
        npk = self.num_pk_params
        P = self.trial.num_patients
        j = torch.arange(P, device=xs.device)
        u_abs = xs[:, npk + 2 * (j + 1)]
        u_elim = xs[:, npk + 2 * (j + 1) + 1]
        ndtri = torch.special.ndtri
        guard = self.gradient_mode and self.pk_type in TRANSIT_TYPES

        def rate(mean, sd, u, per=None):
            """10^(mean + sd ndtri(u)), divided by `per` if given, (B, P). In
            the transit models' gradient mode with the double-where rule:
            where the exponent or the rate is not finite (u at 0 or 1, where
            ndtri is -inf or inf, or an overflow) the rate keeps its value
            and gets derivative 0, so that such a row's density of -inf keeps
            its gradient 0 (the recorded departure; else 0 times an infinite
            derivative, NaN, which VI's mean over its Monte Carlo rows
            carries into every parameter)."""

            def f(u):
                r = torch.pow(10.0, mean + sd * ndtri(u))
                return r if per is None else r / per

            if not guard:
                return f(u)
            with torch.no_grad():
                value = f(u)
                ok = torch.isfinite(mean + sd * ndtri(u)) & torch.isfinite(value)
            return torch.where(ok, f(torch.where(ok, u, 0.5)), value)

        ka = rate(xs[:, 0:1], xs[:, npk : npk + 1], u_abs)
        ke = self._transform(1, xs[:, 1])
        if np.isfinite(self.fixed_vod):
            vod = torch.full_like(ke, float(self.fixed_vod))
        else:
            vod = self._transform(3, xs[:, 3])
        kel = rate(xs[:, 2:3], xs[:, npk + 1 : npk + 2], u_elim, vod[:, None])
        params = {"ka": ka, "ke": ke, "vod": vod, "kel": kel}
        if self.n_states == 3:
            if not np.isfinite(self.fixed_periphery_fwd):
                params["kpf"] = self._transform(4, xs[:, 4])
                params["kpb"] = self._transform(5, xs[:, 5])
            else:
                params["kpf"] = torch.full_like(ke, float(self.fixed_periphery_fwd))
                params["kpb"] = torch.full_like(ke, float(self.fixed_periphery_bwd))
        if self.pk_type in TRANSIT_TYPES:
            nt_ix = self._named_ix["n_transit"]
            mt_ix = self._named_ix["mean_transit_time"]
            n_transit = self._transform(nt_ix, xs[:, nt_ix])
            params["n_transit"] = n_transit
            params["k_transit"] = (n_transit + 1.0) / self._transform(
                mt_ix, xs[:, mt_ix]
            )
        if self.pk_type == "two_biphasic":
            bt_ix = self._named_ix["biphasic_uptake_time"]
            a2_ix = self._named_ix["mean_absorption2"]
            switch = self._transform(bt_ix, xs[:, bt_ix])
            interval = torch.as_tensor(self.trial.dosing_interval).to(xs)
            # reference clamps to interval - 1e-2 (cpp:305-307)
            params["switch_time"] = torch.minimum(switch[:, None], interval - 1e-2)  # (B, P)
            params["ka2"] = self._transform(a2_ix, xs[:, a2_ix])
        sd = self._transform(self.sd_ix, xs[:, self.sd_ix])
        sd2 = self._transform(self.sd_ix + 1, xs[:, self.sd_ix + 1])
        return params, sd, sd2

    def _central_one(self, p, tb):
        """Central compartment (B, P, T) in mg: kernel B1 over the dosing
        intervals, then exact propagation of each observation from the
        start of its interval (bcm3_tpu/likelihoods/poppk.py:751-785).
        Differentiable in the rates through B1's autograd Function."""
        ka, kel = p["ka"].contiguous(), p["kel"].contiguous()
        B, P = ka.shape
        ke = p["ke"][:, None].expand(B, P).contiguous()
        ys_gut, ys_cen = PropagateOneCompartment.apply(
            ka, ke, kel, tb["initial_dose"], tb["interval"], tb["dose_amount"]
        )  # (K, B, P) each
        T = tb["obs_interval"].shape[1]
        idx = tb["obs_interval"][None].expand(B, P, T)
        gut_b = ys_gut.permute(1, 2, 0).gather(2, idx)  # (B, P, T)
        cen_b = ys_cen.permute(1, 2, 0).gather(2, idx)
        # the central row of linear_pk.propagate_one_compartment, without
        # stacking a (B, P, T, 2) state
        dt = tb["obs_offset"][None]
        ka, kel = ka[:, :, None], kel[:, :, None]
        a = ka + p["ke"][:, None, None]
        return cen_b * torch.exp(-kel * dt) + ka * gut_b * linear_pk._expm_ratio(
            a, kel, dt
        )

    def _central_transit(self, p, tb, dtype):
        """Central compartment (B, P, T) in mg: kernel B2 in float32 over
        the merged stop grid, failed lanes NaN
        (bcm3_tpu/likelihoods/poppk.py:657-696). Lanes are patient-minor
        (lane b * P + j is patient j), so B2 reads the per-patient (P, S)
        stop tables directly."""
        B, P = p["ka"].shape
        f32 = torch.float32

        def flat(x):
            if x.dim() == 1:
                x = x[:, None]
            return x.to(f32).expand(B, P).reshape(B * P).contiguous()

        params = {
            "ka": flat(p["ka"]),
            "ke": flat(p["ke"]),
            "kel": flat(p["kel"]),
            "k_transit": flat(p["k_transit"]),
            "n_transit": flat(p["n_transit"]),
            "dose0": tb["tr_dose0"],
        }
        central, ok = transit_solve(
            params,
            tb["tr_grid"],
            tb["tr_amt"],
            trips=self.solver_trips,
            rtol=1e-6,
            atol=float(np.min(self.trial.dose)) * 1e-6,
            min_dt=1e-5,
        )
        S = self.tr_grid.shape[1]
        T = tb["obs_pos"].shape[1]
        central = central.reshape(B, P, S)
        central_obs = central.gather(2, tb["obs_pos"][None].expand(B, P, T))
        central_obs = torch.where(
            ok.reshape(B, P, 1), central_obs, float("nan")
        )
        return central_obs.to(dtype)

    def _simulate_linear(self, p, tb, full_state=False):
        """Every linear model in closed form (bcm3_tpu/likelihoods/poppk.py
        `_simulate_linear`, batched over (chains, patients)): the state at
        the start of each of the K dosing intervals, then each observation
        propagated from the start of its interval. Returns the central
        compartment (B, P, T) in mg, or with full_state the states (B, P,
        T, n)."""
        ka, kel = p["ka"], p["kel"]  # (B, P)
        B, P = ka.shape
        n = self.n_states

        def col(name):  # a per-chain rate (B,) as (B, 1)
            return p[name][:, None] if name in p else None

        ke, kpf, kpb, ka2 = col("ke"), col("kpf"), col("kpb"), col("ka2")
        biphasic = self.pk_type == "two_biphasic"
        if biphasic:
            # (B, P, K): no ka1 phase in intervals without a starting dose
            switch_eff = torch.where(tb["start_given"], p["switch_time"][:, :, None], 0.0)

        def prop(y, dt, sw, ka, ka2, ke, kel, kpf, kpb):
            if biphasic:
                return linear_pk.propagate_biphasic(y, dt, sw, ka, ka2, ke, kel, kpf, kpb)
            return linear_pk.propagate(y, dt, ka, ke, kel, kpf, kpb)

        y = torch.zeros(B, P, n, dtype=ka.dtype, device=ka.device)
        y[..., 0] = tb["initial_dose"]
        starts = []
        for k in range(self.K):
            starts.append(y)
            sw = switch_eff[:, :, k] if biphasic else None
            y = prop(y, tb["interval"], sw, ka, ka2, ke, kel, kpf, kpb)
            y = torch.cat([(y[..., 0] + tb["dose_amount"][:, k])[..., None], y[..., 1:]], dim=-1)
        ys = torch.stack(starts, dim=2)  # (B, P, K, n): state at each interval start

        T = tb["obs_interval"].shape[1]
        obs_k = tb["obs_interval"][None].expand(B, P, T)
        y_base = ys.gather(2, obs_k[..., None].expand(B, P, T, n))
        sw = switch_eff.gather(2, obs_k) if biphasic else None

        def cell(v):  # (B, 1) or (B, P) as (B, 1 or P, 1)
            return None if v is None else v[:, :, None]

        y_obs = prop(y_base, tb["obs_offset"], sw, cell(ka), cell(ka2), cell(ke), cell(kel),
                     cell(kpf), cell(kpb))
        return y_obs if full_state else y_obs[..., 1]

    def _simulate_transit(self, p, tb, full_state=False):
        """Transit models through the budgeted DP5 solve of ode/dp5.py in
        the parameters' dtype (bcm3_tpu/likelihoods/poppk.py
        `_simulate_transit`), over lanes (chain, patient), lane b * P + j
        being patient j. Augmented state [gut, central, (peripheral),
        last_treatment, dose]. Returns the central compartment (B, P, T),
        failed lanes NaN, or with full_state the augmented states (B, P,
        T, n + 2)."""
        B, P = p["ka"].shape
        n = self.n_states
        two_comp = n == 3
        pat = torch.arange(P, device=p["ka"].device).repeat(B)

        def lane(v):
            return (v[:, None] if v.dim() == 1 else v).expand(B, P).reshape(B * P)

        zero = torch.zeros_like(p["ke"])
        ka, ke, kel, kpf, kpb, k_transit, n_transit = (
            lane(v)
            for v in (p["ka"], p["ke"], p["kel"], p.get("kpf", zero), p.get("kpb", zero),
                      p["k_transit"], p["n_transit"])
        )
        # the per-lane constants of the right-hand side, made once per solve
        # (the same operations as inside it: Stirling's log-factorial of the
        # Erlang-shaped transit inflow, reference:
        # LikelihoodPopPKTrajectory.cpp:574-596)
        log_nfac = (
            0.9189385332046727
            + (n_transit + 0.5) * torch.log(n_transit)
            - n_transit
            + torch.log(1.0 + 1.0 / (12.0 * n_transit))
        )
        ka_ke = ka + ke
        # the floor of log(k_transit * t_since), 1e-300, is 0 in float32: at
        # t_since = 0 (the first stage after every dose) the log is -inf and
        # the Erlang term exp(-inf) = 0, whose derivative is then NaN (0 times
        # the infinite derivative of log at 0). Where autograd records, the
        # double-where takes the log of 1 there and the term is set to its
        # value, exp(n_transit * -inf - log_nfac) (0, or NaN as before for a
        # NaN n_transit), so every value stays what it was.
        guard = log_floor_is_zero(p["ka"].dtype) and torch.is_grad_enabled() and any(
            v.requires_grad for v in (ka, ke, kel, kpf, kpb, k_transit, n_transit))
        if guard:
            fill = torch.exp(n_transit * -math.inf - log_nfac).detach()

        def deriv(t, y, _args):
            t_since = torch.clamp(t - y[:, n], min=0.0)
            arg = torch.clamp(k_transit * t_since, min=TRANSIT_LOG_FLOOR)
            if guard:
                zero = arg == 0
                log_t = torch.log(torch.where(zero, 1.0, arg))
            else:
                log_t = torch.log(arg)
            transit = torch.exp(n_transit * log_t - k_transit * t_since - log_nfac)
            if guard:
                transit = torch.where(zero, fill, transit)
            transit = k_transit * transit * y[:, n + 1]
            dgut = transit - ka_ke * y[:, 0]
            if two_comp:
                dcen = ka * y[:, 0] - kel * y[:, 1] - kpf * y[:, 1] + kpb * y[:, 2]
                dper = kpf * y[:, 1] - kpb * y[:, 2]
                rest = (dcen, dper)
            else:
                rest = (ka * y[:, 0] - kel * y[:, 1],)
            z = torch.zeros_like(dgut)
            return torch.stack([dgut, *rest, z, z], dim=-1)

        S = self.tr_grid.shape[1]
        amt_flat = tb["amt"].reshape(-1)

        def event(i, t, y, _args):
            # at dose events: last_treatment <- t, dose level <- amount
            # (only where the dose is given: amount > 0)
            amt = amt_flat[pat * S + i]
            fire = amt > 0
            return torch.cat(
                [y[:, :n], torch.where(fire, t, y[:, n])[:, None],
                 torch.where(fire, amt, y[:, n + 1])[:, None]],
                dim=-1,
            )

        y0 = torch.zeros(B * P, n + 2, dtype=p["ka"].dtype, device=p["ka"].device)
        # the t=0 dose enters through the transit chain: last_treatment 0,
        # dose level the initial dose (reference: initial gut = 0)
        y0[:, n + 1] = tb["initial_dose"][pat]
        # tolerances as the reference configures them: rel 1e-6, abs =
        # minimum dose * 1e-6 (LikelihoodPopPKTrajectory.cpp:238)
        res = solve_at_times_budget(
            deriv,
            y0,
            tb["grid"][pat],
            event_fn=event,
            rtol=1e-6,
            atol=float(np.min(self.trial.dose)) * 1e-6,
            total_trips=self.solver_trips,
            min_dt=1e-5,
        )
        ys = res.ys.reshape(B, P, S, n + 2)
        T = tb["obs_pos"].shape[1]
        out = ys.gather(2, tb["obs_pos"][None, :, :, None].expand(B, P, T, n + 2))
        return out if full_state else out[..., 1]

    def transit_jacobian_inputs(self, p, tb):
        """The arguments of `TransitCentral.apply` (and of B2J) for the
        per-patient parameters p: the tables, the solver's options (the
        tolerances of `_simulate_transit`) and the lane rates (B * P,) in
        RATES order, lane b * P + j being patient j."""
        B, P = p["ka"].shape
        names = RATES[: 5 if self.n_states == 2 else 7]
        rates = [(p[k][:, None] if p[k].dim() == 1 else p[k]).expand(B, P).reshape(B * P)
                 .contiguous() for k in names]
        tables = {"grid": tb["grid"], "amt": tb["amt"], "dose0": tb["initial_dose"],
                  "obs_pos": tb["obs_pos"]}
        options = {"trips": self.solver_trips, "rtol": 1e-6,
                   "atol": float(np.min(self.trial.dose)) * 1e-6, "min_dt": 1e-5}
        return tables, options, rates

    def _central_transit_jacobian(self, p, tb):
        """Central compartment (B, P, T) in mg of the transit models in the
        gradient mode: the budgeted DP5 solve of `_simulate_transit` in the
        parameters' dtype through `TransitCentral` (kernel B2J on the card,
        its plain version on the CPU), differentiable in the rates; failed
        lanes NaN."""
        B, P = p["ka"].shape
        tables, options, rates = self.transit_jacobian_inputs(p, tb)
        central = TransitCentral.apply(tables, options, *rates)
        return central.reshape(B, P, -1)

    def _central(self, p, tb, dtype):
        if self.pk_type in TRANSIT_TYPES and self.gradient_mode:
            return self._central_transit_jacobian(p, tb)
        if self.pk_type == "one":
            return self._central_one(p, tb)
        if self.pk_type == "one_transit":
            return self._central_transit(p, tb, dtype)
        if self.pk_type == "two_transit":
            return self._simulate_transit(p, tb)
        return self._simulate_linear(p, tb)

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        """Log-likelihood of every row of xs (B, D); returns (B,).

        Runs on xs's device in xs's dtype (the `one_transit` solve itself
        in float32, outside the gradient mode)."""
        tb = self._tables(xs.device, xs.dtype)
        p, sd, sd2 = self._patient_params(xs)
        central = self._central(p, tb, xs.dtype)
        failed = None
        if self.gradient_mode:
            # the amounts of a failed solve (NaN) leave the arithmetic here,
            # and the row is -inf below as before: its gradient is 0 rather
            # than the JAX package's NaN (0 times the derivatives at NaN),
            # which VI's mean over its Monte Carlo rows would carry into
            # every parameter
            failed = torch.isnan(central)
            central = torch.where(failed, 0.0, central)

        # mg -> nM conversion (reference: cpp:377-394)
        x = central * (self.conversion_base / p["vod"])[:, None, None]
        mask = tb["obs_mask"][None]
        # double-where: sanitize the unscored entries before the pdf so the
        # masked-out branch is NaN-free (see bcm3_tpu/likelihoods/poppk.py:632)
        x_sc = torch.where(mask, x, 0.0)
        obs_sc = torch.where(mask, tb["observed"][None], 0.0)
        sigma = sd[:, None, None] + sd2[:, None, None] * torch.clamp(x_sc, min=0.0)
        pointwise = log_pdf_tnu4(x_sc, obs_sc, sigma)
        logp = torch.where(mask, pointwise, 0.0).sum(dim=(1, 2))
        # NaN anywhere in the simulated window -> reject
        # (reference: LikelihoodPopPKTrajectory.cpp:416-424)
        window = tb["window_mask"][None]
        nan = torch.isnan(x) if failed is None else torch.isnan(x) | failed
        bad = (window & nan).any(dim=2).any(dim=1) | torch.isnan(logp)
        return torch.where(bad, -math.inf, logp)


    def simulate_trajectories(self, xs: torch.Tensor) -> torch.Tensor:
        """Central-compartment concentrations (B, P, T) in nM of every row
        of xs (B, D): the JAX package's `simulate_trajectories` (the
        analogue of the R bridge's get_simulated_data, reference:
        interface_popPK.cpp:79) batched over rows, every model through
        `_simulate_linear` or the DP5 path in xs's dtype."""
        conc, _ = self.simulate_states(xs)
        return conc

    def simulate_states(self, xs: torch.Tensor):
        """Concentrations (B, P, T) in nM and the compartment states (B, P,
        T, n_states) in mg at the observation grid, for every row of xs
        (B, D) (the JAX package's `simulate_states`; reference:
        interface_popPK.cpp:79-120 out_trajectories)."""
        tb = self._tables(xs.device, xs.dtype)
        p, _, _ = self._patient_params(xs)
        if self.pk_type in TRANSIT_TYPES:
            states = self._simulate_transit(p, tb, full_state=True)[..., : self.n_states]
        else:
            states = self._simulate_linear(p, tb, full_state=True)
        conc = states[..., 1] * (self.conversion_base / p["vod"])[:, None, None]
        return conc, states


def create_poppk_likelihood(varset: VariableSet, attrs) -> PopPKLikelihood:
    """Factory entry (reference: LikelihoodFactory.cpp 'pop_pk_trajectory')."""
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("pop_pk_trajectory likelihood requires an XML definition")
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    trial = PopPKTrial.load(node.get("pkdata_file"), node.get("trial"), node.get("drug"))
    return PopPKLikelihood(
        varset,
        trial,
        node.get("type"),
        node.get("drug"),
        fixed_vod=float(node.get("volume_of_distribution", "nan")),
        fixed_periphery_fwd=float(node.get("k_periphery_fwd", "nan")),
        fixed_periphery_bwd=float(node.get("k_periphery_bwd", "nan")),
        solver_trips=int(node.get("solver_trips", "768")),
    )
