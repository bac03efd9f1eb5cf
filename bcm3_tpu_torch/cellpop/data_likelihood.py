"""Cell-population data likelihoods and their observed-to-simulated cell
matching.

Counterpart of bcm3_tpu/cellpop/data_likelihood.py (reference:
src/cellpop/DataLikelihoodBase.cpp, DataLikelihoodTimePoints.cpp,
DataLikelihoodTimeCourse.cpp, DataLikelihoodTimeCoursePopulationAverage.cpp,
DataLikelihoodDuration.cpp): the error models, the stdev/offset/scale
references, and the four data likelihoods, each over a batch of rows. The
matched types' cost matrices are built on the device; their assignments
(DataLikelihoodTimePoints.cpp:200-289 with
hungarianMinimumWeightPerfectMatching) are solved on the host by the
native solver (bcm3_tpu_torch/native.py). Where the JAX package runs one
host callback per batch row, `batched_hungarian` copies the whole batch to
the host once and solves it in one native call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from bcm3_tpu_torch.cellpop.variability import ValueRef
from bcm3_tpu_torch.likelihoods.poppk import log_pdf_tnu4
from bcm3_tpu_torch.native import lap_match_logp_batch, lap_solve


def hungarian_match_logp(cost_logp: np.ndarray, obs_valid: np.ndarray,
                         sim_valid: np.ndarray) -> float:
    """The total matched logp of one (n_obs, n_sim) log-likelihood matrix:
    0 without a valid observation, -inf when fewer valid simulated cells
    than observed ones exist or when an observed cell can only pair with
    an impossible one (non-finite entries count as -1e100, a total at or
    below -1e90 is -inf)."""
    obs_ix = np.where(obs_valid)[0]
    sim_ix = np.where(sim_valid)[0]
    if len(obs_ix) == 0:
        return 0.0
    if len(sim_ix) < len(obs_ix):
        return -np.inf
    sub = cost_logp[np.ix_(obs_ix, sim_ix)]
    sub = np.where(np.isfinite(sub), sub, -1e100)
    _, neg_total = lap_solve(-sub)
    total = -neg_total
    if not np.isfinite(total) or total <= -1e90:
        return -np.inf
    return float(total)


def host_costs(cost_logp: torch.Tensor) -> np.ndarray:
    """The costs as a float64 numpy array on the host: one copy, staged
    through pinned memory from a card (a pageable copy of this size runs
    at a fraction of the link's rate)."""
    host = torch.empty(cost_logp.shape, dtype=torch.float64,
                       pin_memory=cost_logp.device.type == "cuda")
    return host.copy_(cost_logp.detach()).numpy()


def batched_hungarian(cost_logp: torch.Tensor, obs_valid, sim_valid) -> torch.Tensor:
    """`hungarian_match_logp` of each of B matrices, cost_logp (B, n_obs,
    n_sim), masks (B, n_obs) and (B, n_sim) or shared (n_obs,) and
    (n_sim,): one copy of the costs to the host in float64 (into pinned
    memory from a card), one native call for the batch, the totals (B,) on the cost's device and in its
    dtype (the JAX callback rounds to the cost's dtype too)."""
    cost = host_costs(cost_logp)
    ov = torch.as_tensor(obs_valid).cpu().numpy().astype(bool)
    sv = torch.as_tensor(sim_valid).cpu().numpy().astype(bool)
    totals = lap_match_logp_batch(cost, ov, sv)
    return torch.from_numpy(totals).to(device=cost_logp.device, dtype=cost_logp.dtype)


# ---------------------------------------------------------------------------
# The data likelihoods of `cell_population` (bcm3_tpu/cellpop/data_likelihood.py
# :55-130, :187-434), a batch of rows at a time: simulated values carry a
# leading row axis B, the error references give one value a row.

_LOG_SQRT_2PI = 0.91893853320467274178032973640562

ERROR_NORMAL = "normal"
ERROR_PROPORTIONAL = "proportional_normal"
ERROR_ADDITIVE_PROPORTIONAL = "additive_proportional_normal"
ERROR_T4 = "student_t4"

_ERROR_ALIASES = {
    "normal": ERROR_NORMAL,
    "additive_normal": ERROR_NORMAL,
    "proportional_normal": ERROR_PROPORTIONAL,
    "additive_proportional_normal": ERROR_ADDITIVE_PROPORTIONAL,
    "student_t4": ERROR_T4,
    "t4": ERROR_T4,
}


def _logpdf_normal(y, x, sd):
    d = (y - x) / sd
    return -torch.log(sd) - _LOG_SQRT_2PI - 0.5 * d * d


def evaluate_value(error_model, observed, simulated, sd, prop_sd):
    """reference: DataLikelihoodTimeCourseBase.cpp EvaluateValue."""
    if error_model == ERROR_NORMAL:
        return _logpdf_normal(observed, simulated, sd)
    if error_model == ERROR_PROPORTIONAL:
        return _logpdf_normal(observed, simulated, prop_sd * torch.clamp(simulated, min=0.0))
    if error_model == ERROR_ADDITIVE_PROPORTIONAL:
        return _logpdf_normal(observed, simulated, sd + prop_sd * torch.clamp(simulated, min=0.0))
    return log_pdf_tnu4(observed, simulated, sd)


def _parse_ref_list(s: str):
    return [ValueRef(tok.strip()) for tok in s.split(";") if tok.strip() != ""]


@dataclass
class ErrorSpec:
    """stdev/proportional_stdev/offset/scale references + error model."""

    error_model: str = ERROR_NORMAL
    weight: float = 1.0
    stdev: List = field(default_factory=list)
    proportional_stdev: List = field(default_factory=list)
    offset: List = field(default_factory=list)
    scale: List = field(default_factory=list)

    @classmethod
    def from_xml(cls, node) -> "ErrorSpec":
        em = node.get("error_model", "normal")
        if em not in _ERROR_ALIASES:
            raise ValueError(f"Unknown error model '{em}'")
        return cls(
            error_model=_ERROR_ALIASES[em],
            weight=float(node.get("weight", "1.0")),
            stdev=_parse_ref_list(node.get("stdev", "")),
            proportional_stdev=_parse_ref_list(node.get("proportional_stdev", "")),
            offset=_parse_ref_list(node.get("offset", "")),
            scale=_parse_ref_list(node.get("scale", "")),
        )

    def resolve(self, varset, non_sampled_names):
        for refs in (self.stdev, self.proportional_stdev, self.offset, self.scale):
            for r in refs:
                if not r.resolve(varset, non_sampled_names):
                    raise ValueError(f"Cannot resolve reference '{r.string}'")

    def _get(self, refs, i, default, tv, nsp):
        """One value a row (B,) of tv (B, D)."""
        if not refs:
            return tv.new_full((tv.shape[0],), default)
        ix = 0 if len(refs) == 1 else min(i, len(refs) - 1)
        return refs[ix].value(tv, nsp)

    def get_stdev(self, tv, nsp, i=0):
        return self._get(self.stdev, i, np.nan, tv, nsp)

    def get_proportional_stdev(self, tv, nsp, i=0):
        return self._get(self.proportional_stdev, i, 0.0, tv, nsp)

    def get_offset(self, tv, nsp, i=0):
        return self._get(self.offset, i, 0.0, tv, nsp)

    def get_scale(self, tv, nsp, i=0):
        return self._get(self.scale, i, 1.0, tv, nsp)

    def per_species(self, tv, nsp, S):
        """(sd, prop_sd, offset, scale), each (B, S)."""
        return tuple(
            torch.stack([get(tv, nsp, s) for s in range(S)], dim=-1)
            for get in (self.get_stdev, self.get_proportional_stdev, self.get_offset,
                        self.get_scale)
        )


@dataclass
class SpeciesTarget:
    """One observed species column: a sum of model species
    (reference: DataLikelihoodTimePoints.cpp species '+' parsing)."""

    name: str
    sim_indices: List[int]  # simulated-species indices summed together


def _observed(arr, like):
    return torch.as_tensor(np.asarray(arr), dtype=like.dtype, device=like.device)


@dataclass
class DataLikelihoodTimePoints:
    """Per-timepoint matching of observed cells to simulated cells
    (reference: src/cellpop/DataLikelihoodTimePoints.cpp)."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (T, n_obs_cells, n_species)
    species: List[SpeciesTarget]
    synchronize: str = "none"

    def _cost(self, sim_values, tv, nsp):
        """sim_values (B, T, N, S) -> (cost (B, T, n_obs, N), obs_valid (T,
        n_obs), sim_valid (B, T, N)): one matching a timepoint
        (DataLikelihoodTimePoints.cpp Evaluate:200-289)."""
        S = sim_values.shape[-1]
        obs = _observed(self.observed, sim_values)  # (T, n_obs, S)
        sd, psd, off, scl = self.error.per_species(tv, nsp, S)
        x = sim_values * scl[:, None, None, :] + off[:, None, None, :]  # (B, T, N, S)
        pair = evaluate_value(
            self.error.error_model,
            obs[None, :, :, None, :],  # (1, T, n_obs, 1, S)
            x[:, :, None, :, :],  # (B, T, 1, N, S)
            sd[:, None, None, None, :],
            psd[:, None, None, None, :],
        )  # (B, T, n_obs, N, S)
        pair = torch.where(torch.isnan(obs[None, :, :, None, :]), 0.0, pair)
        cost = torch.where(torch.isnan(x[:, :, None, :, :]), -torch.inf, pair).sum(dim=-1)
        obs_valid = torch.isfinite(obs).any(dim=-1)  # (T, n_obs)
        sim_valid = ~torch.isnan(x[..., 0])  # (B, T, N)
        return cost, obs_valid, sim_valid

    def matched(self, cost, obs_valid, sim_valid):
        """The matched log-probability of each row (B,): the sum over the
        timepoints of their matchings, B x T matchings in one host call."""
        B, T, n_obs, N = cost.shape
        out = batched_hungarian(cost.reshape(B * T, n_obs, N),
                                obs_valid.expand(B, T, n_obs).reshape(B * T, n_obs),
                                sim_valid.reshape(B * T, N))
        return out.view(B, T).sum(dim=1)


@dataclass
class DataLikelihoodTimeCourse:
    """Whole-trajectory matching of observed cells to simulated cells:
    the likelihood matrix sums over all timepoints before one Hungarian
    matching (reference: src/cellpop/DataLikelihoodTimeCourse.cpp)."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (n_obs_cells, T) or (n_obs, T, S)
    species: List[SpeciesTarget]
    synchronize: str = "none"
    missing_simulation_time_stdev: float = 3600.0

    def _cost(self, sim_values, tv, nsp):
        """sim_values (B, T, N, S) -> (cost (B, n_obs, N), obs_valid
        (n_obs,), sim_valid (B, N))."""
        obs = np.asarray(self.observed)
        if obs.ndim == 2:
            obs = obs[:, :, None]
        obs = _observed(obs, sim_values)  # (n_obs, T, S)
        S = sim_values.shape[-1]
        sd, psd, off, scl = self.error.per_species(tv, nsp, S)
        x = sim_values * scl[:, None, None, :] + off[:, None, None, :]  # (B, T, N, S)
        xT = x.transpose(1, 2)  # (B, N, T, S)
        pair = evaluate_value(
            self.error.error_model,
            obs[None, :, None, :, :],  # (1, n_obs, 1, T, S)
            xT[:, None, :, :, :],  # (B, 1, N, T, S)
            sd[:, None, None, None, :],
            psd[:, None, None, None, :],
        )
        # missing observed values are ignored; missing simulated values get
        # a fixed time-offset penalty per missing point
        obs_nan = torch.isnan(obs[None, :, None, :, :])
        sim_nan = torch.isnan(xT[:, None, :, :, :])
        msst = x.new_tensor(self.missing_simulation_time_stdev)
        penalty = _logpdf_normal(msst, 0.0, msst)
        pair = torch.where(obs_nan, 0.0, torch.where(sim_nan, penalty, pair))
        cost = pair.sum(dim=(3, 4))  # (B, n_obs, N)
        obs_valid = torch.isfinite(obs).any(dim=2).any(dim=1)
        sim_valid = (~torch.isnan(xT[..., 0])).any(dim=2)
        return cost, obs_valid, sim_valid

    def matched(self, cost, obs_valid, sim_valid):
        """The matched log-probability of each row (B,), one host call."""
        return batched_hungarian(cost, obs_valid, sim_valid)

    def matching(self, sim_values, tv, nsp):
        """Observed-cell -> simulated-slot assignment (B, n_obs), -1 where
        unmatched (reference: DataLikelihoodTimeCourse.cpp:187-355
        trajectory_matching). Host side: for the posterior-predictive
        accessors, not the sampling path."""
        cost, obs_valid, sim_valid = self._cost(sim_values, tv, nsp)
        cost = host_costs(cost)
        obs_ix = np.where(obs_valid.cpu().numpy())[0]
        sv = sim_valid.cpu().numpy()
        out = -np.ones(cost.shape[:2], dtype=np.int64)
        for b in range(cost.shape[0]):
            sim_ix = np.where(sv[b])[0]
            if len(obs_ix) == 0 or len(sim_ix) < len(obs_ix):
                continue
            sub = cost[b][np.ix_(obs_ix, sim_ix)]
            sub = np.where(np.isfinite(sub), sub, -1e100)
            assignment, _ = lap_solve(-sub)
            for row, col in enumerate(np.asarray(assignment, dtype=np.int64)):
                if 0 <= col < len(sim_ix):
                    out[b, obs_ix[row]] = sim_ix[col]
        return out


@dataclass
class DataLikelihoodPopulationAverage:
    """Population-average time course
    (reference: src/cellpop/DataLikelihoodTimeCoursePopulationAverage.cpp):
    the per-timepoint average over alive cells compared against each
    observed replicate, with a time-offset penalty when the simulation
    has no alive cells at a timepoint."""

    error: ErrorSpec
    timepoints: np.ndarray  # (T,)
    observed: np.ndarray  # (n_replicates, T)
    species: List[SpeciesTarget]
    include_only_mitotic: bool = False
    missing_simulation_time_stdev: float = 3600.0

    def average(self, sim_values, population_size):
        """(B, T, N, 1), (B, T) -> the alive cells' average (B, T), NaN
        where none lives, and whether any does."""
        x_cells = sim_values[..., 0]  # (B, T, N)
        avg = torch.nansum(x_cells, dim=-1) / torch.clamp(population_size, min=1)
        has_cells = (~torch.isnan(x_cells)).any(dim=-1) & (population_size > 0)
        return torch.where(has_cells, avg, torch.nan), has_cells

    def evaluate(self, sim_values, population_size, tv, nsp):
        """sim_values: (B, T, N, 1); population_size: (B, T). Returns (B,)."""
        avg, has_cells = self.average(sim_values, population_size)
        scl = self.error.get_scale(tv, nsp, 0)[:, None]
        off = self.error.get_offset(tv, nsp, 0)[:, None]
        sd = self.error.get_stdev(tv, nsp, 0)[:, None, None]
        psd = self.error.get_proportional_stdev(tv, nsp, 0)[:, None, None]
        avg = avg * scl + off

        obs = _observed(self.observed, sim_values)  # (R, T)
        tp = _observed(self.timepoints, sim_values)
        # nearest valid simulated timepoint offset for the penalty
        # (reference: ...PopulationAverage.cpp Evaluate:52-76)
        first_valid = torch.where(has_cells, tp, torch.inf).amin(dim=-1, keepdim=True)
        last_valid = torch.where(has_cells, tp, -torch.inf).amax(dim=-1, keepdim=True)
        offset = torch.minimum((tp - first_valid).abs(), (tp - last_valid).abs())
        penalty = _logpdf_normal(offset, 0.0, offset.new_tensor(self.missing_simulation_time_stdev))
        point = evaluate_value(self.error.error_model, obs[None], avg[:, None, :], sd, psd)
        contrib = torch.where(torch.isnan(avg)[:, None, :], penalty[:, None, :], point)
        logp = torch.where(torch.isnan(obs)[None], 0.0, contrib).sum(dim=(1, 2))
        return logp * self.error.weight


@dataclass
class DataLikelihoodDuration:
    """Phase-duration matching (reference:
    src/cellpop/DataLikelihoodDuration.cpp). Durations per cell come
    from the detected event times; matching via Hungarian assignment."""

    error: ErrorSpec
    observed: np.ndarray  # (n_obs,)
    period: str  # G1phase | Sphase | G2phase | NEBD_to_AnaphaseOnset
    simulation_time: float = 0.0

    def durations_from_events(self, event_times):
        """event_times: (..., NUM_EVENTS) -> (...) durations
        (reference: Cell.cpp GetDuration:399-413)."""
        from bcm3_tpu_torch.cellpop.simulate import (
            EV_ANAPHASE_ONSET,
            EV_NEBD,
            EV_REPLICATION_FINISH,
            EV_REPLICATION_START,
        )

        if self.period == "G1phase":
            return event_times[..., EV_REPLICATION_START]
        if self.period == "Sphase":
            return event_times[..., EV_REPLICATION_FINISH] - event_times[..., EV_REPLICATION_START]
        if self.period == "G2phase":
            return event_times[..., EV_NEBD] - event_times[..., EV_REPLICATION_FINISH]
        if self.period == "NEBD_to_AnaphaseOnset":
            return event_times[..., EV_ANAPHASE_ONSET] - event_times[..., EV_NEBD]
        raise ValueError(f"Unknown duration period '{self.period}'")

    def _cost(self, event_times, active, tv, nsp):
        """(cost (B, n_obs, N), obs_valid (n_obs,), sim_valid (B, N))
        (reference: DataLikelihoodDuration.cpp:64-133)."""
        sim = torch.where(active, self.durations_from_events(event_times), torch.nan)  # (B, N)
        sd = self.error.get_stdev(tv, nsp, 0)
        obs = _observed(self.observed, sim)
        cost = _logpdf_normal(obs[None, :, None], sim[:, None, :], sd[:, None, None])
        cost = torch.where(torch.isnan(cost), -torch.inf, cost)
        return cost, torch.isfinite(obs), ~torch.isnan(sim)

    def matched(self, cost, obs_valid, sim_valid):
        """The matched log-probability of each row (B,), one host call."""
        return batched_hungarian(cost, obs_valid, sim_valid)
