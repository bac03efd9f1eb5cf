"""General linear-compartment PK models solved by matrix exponential.

Counterpart of bcm3_tpu/likelihoods/pharmaco.py (reference:
src/pharmaco/PharmacokineticModel.cpp, PharmacoLikelihoodSingle.cpp,
PharmacoLikelihoodPopulation.cpp, PharmacoPatient.cpp). The system
matrix A is built from the enabled model options; each patient's state
steps through a uniform grid of K dosing intervals with one
``expm(A * interval)``, and each observation is propagated from the start
of its interval by ``expm(A * offset)``. Here everything is batched over
(rows, patients): `log_prob_batched(xs (B, D)) -> (B,)` on xs's device
and dtype, the single-patient likelihood with P = 1.

- `expm`: n = 2 by the closed form (ode/linear_pk.py `_expm_2x2`), n <= 8
  by the Pade-6 scaling and squaring `small_expm`, larger n by
  `torch.linalg.matrix_exp` (the JAX package calls
  `jax.scipy.linalg.expm` there: another algorithm);
- at n = 2 the read-out computes the four entries of expm(A * offset) as
  (B, P, T) tensors and only the rows it needs, never a (B, P, T, 2, 2)
  matrix; at n > 2 `log_prob_batched` evaluates EXPM_CHUNK_ROWS rows at a
  time, so that the (rows, P, T, n, n) matrices of the read-out stay a
  few GB;
- failure (a non-finite state at an observation) maps to -inf
  (PharmacoLikelihoodSingle.cpp:203-224).

Structural options (reference: PharmacokineticModel.h:9-23): peripheral
compartment, metabolite compartment, N transit compartments, biphasic
(direct) absorption, per-patient bioavailability. The schedule is built
on the host by the JAX package's code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from bcm3_tpu_torch.likelihoods.poppk import DRUG_MOLWEIGHTS, PopPKTrial, log_pdf_tnu4
from bcm3_tpu_torch.model.variables import (
    TRANSFORM_LOG,
    TRANSFORM_LOG10,
    TRANSFORM_LOGIT,
    VariableSet,
)
from bcm3_tpu_torch.ode.linear_pk import _expm_2x2, small_expm

TREATMENT_HORIZON_HOURS = 696.0  # reference: PharmacoPatient.cpp:50

# rows per evaluation of log_prob_batched at n > 2: at 16 patients x 24
# observations that is 3.1 M read-out matrices, 0.6 GB per (.., 7, 7)
# float32 tensor
EXPM_CHUNK_ROWS = 8192


def expm(A):
    """exp(A) of a batch of matrices (..., n, n), dispatched on n as the
    JAX package does (bcm3_tpu/likelihoods/pharmaco.py:42-58)."""
    n = A.shape[-1]
    if n == 2:
        e00, e01, e10, e11 = _expm_2x2(A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1], 1.0)
        return torch.stack([torch.stack([e00, e01], -1), torch.stack([e10, e11], -1)], -2)
    if n <= 8:
        return small_expm(A)
    return torch.linalg.matrix_exp(A)


@dataclass(frozen=True)
class PharmacoModelConfig:
    """Static structural options selected in the likelihood XML."""

    use_peripheral: bool = False
    num_transit: int = 0
    use_biphasic: bool = False
    use_metabolite: bool = False

    @property
    def num_compartments(self) -> int:
        # reference: PharmacokineticModel.cpp ConstructMatrix:188-201
        return 2 + int(self.use_peripheral) + int(self.use_metabolite) + self.num_transit

    @property
    def metabolite_ix(self) -> int:
        return 2 + int(self.use_peripheral)

    @property
    def first_transit_ix(self) -> int:
        return 2 + int(self.use_peripheral) + int(self.use_metabolite)


def build_matrix(
    cfg: PharmacoModelConfig,
    absorption,
    excretion,
    elimination,
    peripheral_fwd=0.0,
    peripheral_bwd=0.0,
    transit_rate=0.0,
    direct_absorption=0.0,
    metabolite_conversion=0.0,
    metabolite_elimination=1.0,
):
    """System matrices A (..., n, n) over the broadcast shape of the rates,
    entry by entry in the JAX package's order (reference:
    PharmacokineticModel.cpp ConstructMatrix:188-246), including its quirk
    that for exactly 2 transit compartments the inter-transit flow is
    skipped (the ``> 2`` guard at :212)."""
    n = cfg.num_compartments
    absorption = torch.as_tensor(absorption)
    rates = [torch.as_tensor(v) for v in (excretion, elimination, peripheral_fwd,
                                          peripheral_bwd, transit_rate, direct_absorption,
                                          metabolite_conversion)]
    shape = torch.broadcast_shapes(absorption.shape, *(r.shape for r in rates))
    A = torch.zeros(shape + (n, n), dtype=absorption.dtype, device=absorption.device)
    A[..., 0, 0] += -excretion - absorption

    if cfg.num_transit > 0:
        ft = cfg.first_transit_ix
        k = cfg.num_transit
        A[..., ft, 0] += absorption
        if k > 2:  # reference quirk: chain only wired for > 2
            for i in range(k - 1):
                A[..., ft + i, ft + i] += -transit_rate
                A[..., ft + i + 1, ft + i] += transit_rate
        A[..., ft + k - 1, ft + k - 1] = -transit_rate
        A[..., 1, ft + k - 1] += transit_rate
    else:
        A[..., 1, 0] += absorption

    if cfg.use_peripheral:
        A[..., 1, 1] += -peripheral_fwd
        A[..., 2, 1] += peripheral_fwd
        A[..., 1, 2] += peripheral_bwd
        A[..., 2, 2] += -peripheral_bwd

    if cfg.use_biphasic:
        A[..., 0, 0] += -direct_absorption
        A[..., 1, 0] += direct_absorption

    if cfg.use_metabolite:
        m = cfg.metabolite_ix
        A[..., 1, 1] += -metabolite_conversion
        A[..., m, 1] += metabolite_conversion
        A[..., m, m] += -metabolite_elimination

    A[..., 1, 1] += -elimination
    return A


@dataclass
class PharmacoSchedule:
    """Host-precomputed static dosing/observation structure for patients.

    Doses land on a uniform grid of K intervals (t = k * interval,
    k = 0..K-1, amount 0 where treatment was skipped); observation i of
    patient j belongs to interval obs_interval[j, i] at offset
    obs_offset[j, i] past that interval's start.
    """

    interval: np.ndarray  # (P,)
    dose_amount: np.ndarray  # (P, K) — 0 where no dose given
    obs_interval: np.ndarray  # (P, T) int
    obs_offset: np.ndarray  # (P, T)
    obs_values: np.ndarray  # (P, T) observed concentrations, NaN padded
    obs_mask: np.ndarray  # (P, T) finite & real observation
    obs_times: np.ndarray  # (P, T)

    @classmethod
    def from_trial(cls, trial: PopPKTrial) -> "PharmacoSchedule":
        """Compile the reference's per-patient treatment plan
        (reference: PharmacoPatient.cpp Load:48-95, including the fixed
        696-hour treatment horizon and intermittent patterns 1/2/3)."""
        P, T = trial.num_patients, len(trial.time)
        K = int(np.max(np.ceil(TREATMENT_HORIZON_HOURS / trial.dosing_interval)))
        dose_times = trial.dosing_interval[:, None] * np.arange(K)[None, :]
        give = np.ones((P, K), dtype=bool)
        give &= dose_times < TREATMENT_HORIZON_HOURS
        day = np.floor(dose_times / 24.0).astype(int)
        for j in range(P):
            valid = (day[j] >= 0) & (day[j] < trial.interruptions.shape[1])
            skipped = np.zeros(K, dtype=bool)
            skipped[valid] = trial.interruptions[j, day[j][valid]]
            give[j] &= ~skipped
            t = dose_times[j]
            if trial.intermittent[j] == 1:
                give[j] &= (t - 7 * 24.0 * np.floor(t / (7 * 24.0))) < 5 * 24.0
            elif trial.intermittent[j] == 2:
                give[j] &= (t - 28 * 24.0 * np.floor(t / (28 * 24.0))) < 21 * 24.0
            elif trial.intermittent[j] == 3:
                give[j] &= (t - 7 * 24.0 * np.floor(t / (7 * 24.0))) < 4 * 24.0
        changed = np.where(
            np.isfinite(trial.dose_change_time[:, None]),
            dose_times >= trial.dose_change_time[:, None],
            False,
        )
        amount = np.where(
            changed,
            np.nan_to_num(trial.dose_after_dose_change[:, None]),
            trial.dose[:, None],
        )
        dose_amount = np.where(give, amount, 0.0)

        t = trial.time[None, :]
        interval = trial.dosing_interval[:, None]
        # an observation exactly at a dose time belongs to the *preceding*
        # interval (pre-dose), matching the reference's <= target_t loop
        # (PharmacokineticModel.cpp:141-155)
        k_obs = np.ceil(t / interval).astype(int) - 1
        k_obs = np.clip(k_obs, 0, K - 1)
        obs_offset = np.maximum(t - k_obs * interval, 0.0)
        obs_mask = np.isfinite(trial.observed)
        return cls(
            interval=trial.dosing_interval,
            dose_amount=dose_amount,
            obs_interval=k_obs,
            obs_offset=obs_offset,
            obs_values=trial.observed,
            obs_mask=obs_mask,
            obs_times=np.broadcast_to(trial.time, (P, T)).copy(),
        )


def _mv(M, y):
    """M (..., n, n) @ y (..., n), summed over k in order."""
    acc = M[..., :, 0] * y[..., 0:1]
    for k in range(1, M.shape[-1]):
        acc = acc + M[..., :, k] * y[..., k : k + 1]
    return acc


def interval_starts(A, interval, doses, bioavailability):
    """The post-dose state (B, P, K, n) at each of the K interval starts of
    every (row, patient): a recurrence with one step matrix expm(A *
    interval) per (row, patient), dose x bioavailability added to the gut
    at each interval start. A (B, P, n, n); interval (P,); doses (P, K);
    bioavailability broadcastable to (B, P)."""
    B, P, n = A.shape[0], A.shape[1], A.shape[-1]
    M = expm(A * interval[:, None, None])
    y = torch.zeros(B, P, n, dtype=A.dtype, device=A.device)
    starts = []
    for k in range(doses.shape[1]):
        y = torch.cat([y[..., :1] + (doses[:, k] * bioavailability)[..., None], y[..., 1:]], -1)
        starts.append(y)
        y = _mv(M, y)
    return torch.stack(starts, dim=2)


def solve_patient(A, interval, doses, obs_interval, obs_offset, bioavailability,
                  full_state=True):
    """Propagate every (row, patient): the state at each interval start
    (`interval_starts`), then each observation from the start of its
    interval (bcm3_tpu/likelihoods/pharmaco.py `solve_patient`, batched;
    reference: PharmacokineticModel.cpp Solve:110-176).

    A (B, P, n, n); interval (P,); doses (P, K); obs_interval (P, T) long;
    obs_offset (P, T); bioavailability broadcastable to (B, P). Returns the
    trajectory (B, P, T, n), or with full_state False its central
    compartment (B, P, T), and ok (B, P): every compartment finite at
    every observation."""
    B, P, n = A.shape[0], A.shape[1], A.shape[-1]
    ys = interval_starts(A, interval, doses, bioavailability)  # (B, P, K, n)
    T = obs_interval.shape[1]
    y_obs = ys.gather(2, obs_interval[None, :, :, None].expand(B, P, T, n))
    if n == 2 and not full_state:
        # the closed form's four entries as (B, P, T) tensors, both rows
        # read out (ok covers the gut as well)
        off = obs_offset[None]
        a = [A[..., i, j][:, :, None] * off for i in (0, 1) for j in (0, 1)]
        e00, e01, e10, e11 = _expm_2x2(*a, 1.0)
        g, c = y_obs[..., 0], y_obs[..., 1]
        central = e10 * g + e11 * c
        gut = e00 * g + e01 * c
        ok = (torch.isfinite(central) & torch.isfinite(gut)).all(dim=-1)
        return central, ok
    E = expm(A[:, :, None] * obs_offset[None, :, :, None, None])  # (B, P, T, n, n)
    traj = _mv(E, y_obs)
    ok = torch.isfinite(traj).all(dim=-1).all(dim=-1)
    return (traj if full_state else traj[..., 1]), ok


def _transform(varset: VariableSet, ix: int, xs):
    """Output transform of one variable over the rows xs (B, D) (reference:
    VariableSet.cpp:97-112)."""
    t = varset.transforms[ix]
    v = xs[:, ix]
    if t == TRANSFORM_LOG:
        return torch.exp(v)
    if t == TRANSFORM_LOG10:
        return torch.pow(10.0, v)
    if t == TRANSFORM_LOGIT:
        return torch.sigmoid(v)
    return v


class _Pharmaco:
    """What the single and the population likelihood share: the schedule
    as tensors, the solve and the Student-t(nu=4) scoring."""

    def _tables(self, device, dtype) -> dict:
        """The schedule as tensors, made once per (device, dtype)."""
        key = (str(device), dtype)
        if key not in self._tensors:
            s = self.schedule

            def f(a, dt=dtype):
                return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

            self._tensors[key] = {
                "interval": f(s.interval),
                "dose_amount": f(s.dose_amount),
                "obs_interval": f(s.obs_interval, torch.long),
                "obs_offset": f(s.obs_offset),
                "obs_values": f(s.obs_values),
                "obs_mask": f(s.obs_mask, torch.bool),
            }
        return self._tensors[key]

    def _solve(self, A, bio, tb):
        """The central compartment (B, P, T) and ok (B, P)."""
        return solve_patient(A, tb["interval"], tb["dose_amount"], tb["obs_interval"],
                             tb["obs_offset"], bio, full_state=False)

    def _trajectory_at(self, A, bio, patient_ix, times, xs):
        """One patient's trajectory (B, T', n) and ok (B,) at arbitrary
        requested times."""
        s = self.schedule
        interval = float(s.interval[patient_ix])
        times = np.asarray(times, dtype=np.float64)
        K = s.dose_amount.shape[1]
        k_obs = np.clip(np.ceil(times / interval).astype(int) - 1, 0, K - 1)
        off = np.maximum(times - k_obs * interval, 0.0)

        def f(a, dt=xs.dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=xs.device)

        traj, ok = solve_patient(
            A[:, patient_ix : patient_ix + 1], f([interval]),
            f(s.dose_amount[patient_ix : patient_ix + 1]), f(k_obs[None], torch.long),
            f(off[None]), bio[:, patient_ix : patient_ix + 1],
        )
        return traj[:, 0], ok[:, 0]

    def _log_prob(self, xs):
        tb = self._tables(xs.device, xs.dtype)
        A, bio, conversion, add_sd, prop_sd = self._params(xs)
        central, ok = self._solve(A, bio, tb)
        x = central * conversion[..., None]  # (B, P, T) in nM
        mask = tb["obs_mask"][None]
        # the unscored entries' observations are NaN: sanitize them before
        # the pdf, so that the branch `where` drops stays NaN-free
        obs = torch.where(mask, tb["obs_values"][None], 0.0)
        sigma = add_sd[:, None, None] + prop_sd[:, None, None] * torch.clamp(x, min=0.0)
        lp = torch.where(mask, log_pdf_tnu4(x, obs, sigma), 0.0).sum(dim=(1, 2))
        return torch.where(ok.all(dim=1) & torch.isfinite(lp), lp, -torch.inf)

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        """Log-likelihood of every row of xs (B, D) on xs's device and
        dtype; returns (B,). At n > 2, EXPM_CHUNK_ROWS rows at a time."""
        if self.cfg.num_compartments == 2 or xs.shape[0] <= EXPM_CHUNK_ROWS:
            return self._log_prob(xs)
        return torch.cat([self._log_prob(c) for c in xs.split(EXPM_CHUNK_ROWS)])

    def _sds(self, xs):
        zeros = torch.zeros_like(xs[:, 0])
        ix = self._ix
        add_sd = _transform(self.varset, ix["additive_sd"], xs) if "additive_sd" in ix else zeros
        prop_sd = (_transform(self.varset, ix["proportional_sd"], xs)
                   if "proportional_sd" in ix else zeros)
        return add_sd, prop_sd


class PharmacoLikelihoodSingle(_Pharmaco):
    """Single-patient general-PK likelihood
    (reference: src/pharmaco/PharmacoLikelihoodSingle.cpp). Named
    variables: absorption, clearance, volume_of_distribution, optional
    excretion, peripheral_*_rate, mean_transit_time, direct_absorption,
    metabolite_conversion_rate, and at least one of
    additive_error_standard_deviation /
    proportional_error_standard_deviation."""

    def __init__(self, varset: VariableSet, trial: PopPKTrial, drug: str,
                 cfg: PharmacoModelConfig):
        if trial.num_patients != 1:
            raise ValueError("PharmacoLikelihoodSingle requires 1 patient")
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")
        self.varset = varset
        self.cfg = cfg
        self.drug = drug
        self.schedule = PharmacoSchedule.from_trial(trial)
        self._ix = _resolve_indices(varset, cfg, population=False)
        self.molweight = DRUG_MOLWEIGHTS[drug]
        self._tensors = {}

    def _params(self, xs):
        """A (B, 1, n, n), bioavailability (B, 1), conversion (B, 1) and the
        two sds (B,) of every row."""
        ix = self._ix

        def tv(name):
            return _transform(self.varset, ix[name], xs)

        vod = tv("volume_of_distribution")
        excretion = tv("excretion") if "excretion" in ix else torch.zeros_like(vod)
        kw = {}
        if self.cfg.use_peripheral:
            kw["peripheral_fwd"] = tv("peripheral_forward_rate")
            kw["peripheral_bwd"] = tv("peripheral_backward_rate")
        if self.cfg.num_transit > 0:
            kw["transit_rate"] = (self.cfg.num_transit + 1.0) / tv("mean_transit_time")
        if self.cfg.use_biphasic:
            kw["direct_absorption"] = tv("direct_absorption")
        if self.cfg.use_metabolite:
            kw["metabolite_conversion"] = tv("metabolite_conversion_rate")
            kw["metabolite_elimination"] = 1.0  # reference fixes this to 1
        A = build_matrix(self.cfg, tv("absorption"), excretion, tv("clearance") / vod, **kw)
        conversion = (1e6 / self.molweight) / vod
        add_sd, prop_sd = self._sds(xs)
        return A[:, None], torch.ones_like(vod)[:, None], conversion[:, None], add_sd, prop_sd

    def simulate(self, xs):
        """Concentrations (B, T) in nM and ok (B,) of every row."""
        A, bio, conversion, _, _ = self._params(xs)
        central, ok = self._solve(A, bio, self._tables(xs.device, xs.dtype))
        return central[:, 0] * conversion, ok[:, 0]

    def observed(self):
        """(times, concentrations) of the patient's observed data
        (reference: interface_pharmaco_single.cpp get_observed_data)."""
        s = self.schedule
        return s.obs_times[0], s.obs_values[0]

    def simulate_trajectory(self, xs, times):
        """Concentrations (B, T') and compartment trajectories (B, T', n) at
        arbitrary requested times, and ok (B,) (reference:
        interface_pharmaco_single.cpp get_simulated_trajectory)."""
        A, bio, conversion, _, _ = self._params(xs)
        traj, ok = self._trajectory_at(A, bio, 0, times, xs)
        return traj[..., 1] * conversion, traj, ok


class PharmacoLikelihoodPopulation(_Pharmaco):
    """Population general-PK likelihood with optional per-patient random
    effects (reference: src/pharmaco/PharmacoLikelihoodPopulation.cpp).

    For each base parameter X in {absorption, excretion, clearance,
    volume_of_distribution, transit_time}: if ``sigma_X`` exists in the
    prior, patient j's value is 10^QuantileNormal(p{j+1}_X; mean_X,
    sigma_X) with the per-patient quantile variables named p1_X, p2_X, …
    (reference: SetupSimulation:259-320, InitializePatientMarginals:
    326-338); otherwise all patients share 10^mean_X. Optional
    per-patient bioavailability variables p{j+1}_bioavailability scale
    the dose directly."""

    def __init__(self, varset: VariableSet, trial: PopPKTrial, drug: str,
                 cfg: PharmacoModelConfig, use_bioavailability: bool = False):
        if drug not in DRUG_MOLWEIGHTS:
            raise ValueError(f"Unknown drug '{drug}'")
        self.varset = varset
        self.cfg = cfg
        self.drug = drug
        self.use_bioavailability = use_bioavailability
        self.num_patients = trial.num_patients
        self.schedule = PharmacoSchedule.from_trial(trial)
        self._ix = _resolve_indices(varset, cfg, population=True)
        self._patient_ix: Dict[str, np.ndarray] = {}
        names = ["absorption", "excretion", "clearance", "volume_of_distribution",
                 "transit_time"]
        for name in names:
            if f"sigma_{name}" in varset.names:
                self._patient_ix[name] = np.array(
                    [varset.index_of(f"p{j + 1}_{name}") for j in range(trial.num_patients)]
                )
        if use_bioavailability:
            self._patient_ix["bioavailability"] = np.array(
                [varset.index_of(f"p{j + 1}_bioavailability") for j in range(trial.num_patients)]
            )
        self.molweight = DRUG_MOLWEIGHTS[drug]
        self._tensors = {}

    def _population_param(self, xs, name, mean_name=None):
        """(B, P): 10^mean or the non-centered per-patient transform
        (reference: SetupSimulation:259-292)."""
        mean = xs[:, self.varset.index_of(mean_name or f"mean_{name}")]
        if name in self._patient_ix:
            sigma = xs[:, self.varset.index_of(f"sigma_{name}")]
            u = xs[:, torch.as_tensor(self._patient_ix[name], device=xs.device)]
            return torch.pow(10.0, mean[:, None] + sigma[:, None] * torch.special.ndtri(u))
        return torch.pow(10.0, mean)[:, None].expand(-1, self.num_patients)

    def _params(self, xs):
        """A (B, P, n, n), bioavailability (B, P), conversion (B, P) and the
        two sds (B,) of every row."""
        P = self.num_patients
        cfg = self.cfg
        B = xs.shape[0]
        zeros = xs.new_zeros(B, P)

        def tv(name):  # a per-row rate (B,) as (B, P)
            return _transform(self.varset, self.varset.index_of(name), xs)[:, None].expand(B, P)

        absorption = self._population_param(xs, "absorption")
        clearance = self._population_param(xs, "clearance")
        vod = self._population_param(xs, "volume_of_distribution")
        excretion = (self._population_param(xs, "excretion")
                     if "mean_excretion" in self.varset.names else zeros)
        if cfg.num_transit > 0:
            if "transit_time" in self._patient_ix:
                mtt = self._population_param(xs, "transit_time", "mean_transit_time")
            else:
                mtt = tv("mean_transit_time")
            tr = (cfg.num_transit + 1.0) / mtt
        else:
            tr = zeros
        A = build_matrix(
            cfg, absorption, excretion, clearance / vod,
            peripheral_fwd=tv("peripheral_forward_rate") if cfg.use_peripheral else zeros,
            peripheral_bwd=tv("peripheral_backward_rate") if cfg.use_peripheral else zeros,
            transit_rate=tr,
            direct_absorption=tv("direct_absorption") if cfg.use_biphasic else zeros,
            metabolite_conversion=(tv("metabolite_conversion_rate") if cfg.use_metabolite
                                   else zeros),
            metabolite_elimination=1.0,
        )
        if self.use_bioavailability:
            pix = torch.as_tensor(self._patient_ix["bioavailability"], device=xs.device)
            bio = xs[:, pix]
        else:
            bio = torch.ones_like(zeros)
        conversion = (1e6 / self.molweight) / vod
        add_sd, prop_sd = self._sds(xs)
        return A, bio, conversion, add_sd, prop_sd

    def simulate_trajectories(self, xs):
        """Concentrations (B, P, T) in nM and ok (B, P) of every row."""
        A, bio, conversion, _, _ = self._params(xs)
        central, ok = self._solve(A, bio, self._tables(xs.device, xs.dtype))
        return central * conversion[..., None], ok

    def observed(self, patient_ix: int):
        """(times, concentrations) for one patient (reference:
        interface_pharmaco_population.cpp get_observed_data)."""
        s = self.schedule
        return s.obs_times[patient_ix], s.obs_values[patient_ix]

    def simulate_patient_trajectory(self, xs, patient_ix: int, times):
        """Concentrations (B, T') and compartment trajectories (B, T', n) of
        one patient at arbitrary requested times, and ok (B,) (reference:
        interface_pharmaco_population.cpp get_simulated_trajectory)."""
        A, bio, conversion, _, _ = self._params(xs)
        traj, ok = self._trajectory_at(A, bio, patient_ix, times, xs)
        return traj[..., 1] * conversion[:, patient_ix, None], traj, ok


def _resolve_indices(varset: VariableSet, cfg: PharmacoModelConfig,
                     population: bool) -> Dict[str, int]:
    ix: Dict[str, int] = {}
    if "additive_error_standard_deviation" in varset.names:
        ix["additive_sd"] = varset.index_of("additive_error_standard_deviation")
    if "proportional_error_standard_deviation" in varset.names:
        ix["proportional_sd"] = varset.index_of("proportional_error_standard_deviation")
    if "additive_sd" not in ix and "proportional_sd" not in ix:
        raise ValueError(
            "Neither additive_error_standard_deviation nor "
            "proportional_error_standard_deviation specified in the prior"
        )
    if not population:
        for name in ("absorption", "clearance", "volume_of_distribution"):
            ix[name] = varset.index_of(name)
        if "excretion" in varset.names:
            ix["excretion"] = varset.index_of("excretion")
        if cfg.use_peripheral:
            ix["peripheral_forward_rate"] = varset.index_of("peripheral_forward_rate")
            ix["peripheral_backward_rate"] = varset.index_of("peripheral_backward_rate")
        if cfg.num_transit > 0:
            ix["mean_transit_time"] = varset.index_of("mean_transit_time")
        if cfg.use_biphasic:
            ix["direct_absorption"] = varset.index_of("direct_absorption")
        if cfg.use_metabolite:
            ix["metabolite_conversion_rate"] = varset.index_of("metabolite_conversion_rate")
    return ix


def _flag(node, name):
    return node.get(name, "false").lower() in ("1", "true")


def _create(varset: VariableSet, attrs, population: bool):
    root = attrs.get("_xml_root")
    if root is None:
        raise ValueError("pharmaco likelihood requires an XML definition")
    node = root.find("pk_model")
    if node is None:
        raise ValueError("likelihood XML must contain a <pk_model> element")
    drug = node.get("drug")
    cfg = PharmacoModelConfig(
        use_peripheral=_flag(node, "peripheral_compartment"),
        num_transit=int(node.get("num_transit_compartments", "0")),
        use_biphasic=_flag(node, "biphasic_absorption"),
        use_metabolite=_flag(node, "metabolite"),
    )
    trial = PopPKTrial.load(node.get("pkdata_file", "pkdata.nc"), node.get("trial"), drug)
    if population:
        return PharmacoLikelihoodPopulation(
            varset, trial, drug, cfg, use_bioavailability=_flag(node, "bioavailability")
        )
    patient = attrs.get("pharmacosingle.patient") or node.get("patient")
    if not patient:
        raise ValueError("Patient ID has not been specified")
    from bcm3_tpu_torch.likelihoods.pk_single import select_patient

    return PharmacoLikelihoodSingle(varset, select_patient(trial, patient), drug, cfg)


def create_pharmaco_single(varset: VariableSet, attrs):
    return _create(varset, attrs, population=False)


def create_pharmaco_population(varset: VariableSet, attrs):
    return _create(varset, attrs, population=True)
