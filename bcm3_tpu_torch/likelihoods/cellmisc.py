"""Cell-biology likelihoods: cell-cycle marker, mitosis-time estimation and
the Incucyte drug-response population model, on torch tensors.

Counterpart of bcm3_tpu/likelihoods/cellmisc.py:
- reference: src/likelihoods/LikelihoodCellCycleMarker.cpp: a piecewise
  linear marker signal (baseline, S-phase ramp, plateau ramp, decay after
  mitosis) fit to one TSV track with t(nu=4) errors;
- reference: src/likelihoods/LikelihoodMitosisTimeEstimation.cpp: boxcar
  mitosis trajectories from Sobol quantiles scaled by the sampled sds,
  matched to the observed ones by the host Hungarian matching
  (cellpop/data_likelihood.py `batched_hungarian`);
- reference: src/likelihoods/LikelihoodIncucytePopulation.cpp: a 3-state
  delay ODE (growing cells, apoptotic cells, debris) per well with drug
  ramps, contact inhibition and t(nu=3) residuals of confluence and the
  apoptosis marker, integrated by the batched DDE solvers of
  ode/delay.py. The wells of all rows integrate as one batch of lanes.

Each likelihood's one evaluation entry is ``log_prob_batched(xs (B, D))
-> (B,)`` on the rows' device and dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from bcm3_tpu_torch.cellpop.data_likelihood import batched_hungarian
from bcm3_tpu_torch.likelihoods.poppk import log_pdf_tnu4
from bcm3_tpu_torch.model.variables import VariableSet
from bcm3_tpu_torch.ode.delay import (
    solve_dde_adaptive,
    solve_dde_budget,
    solve_dde_grid,
    solve_dde_ring,
)

# log(Gamma(2)/(Gamma(1.5) sqrt(3 pi))) = log(2/(sqrt(3) pi))
_LOG_TNU3_NORM = float(np.log(2.0 / (np.sqrt(3.0) * np.pi)))
_LOG_SQRT_2PI = 0.91893853320467274178032973640562


def log_pdf_tnu3(x, mu, sigma):
    """Student-t nu=3 log-density
    (reference: src/utils/ProbabilityDistributions.cpp LogPdfTnu3)."""
    xn = (x - mu) / sigma
    return _LOG_TNU3_NORM - 2.0 * torch.log1p(xn * xn / 3.0) - torch.log(sigma)


def _data(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# cell_cycle_marker


class CellCycleMarkerLikelihood:
    """reference: LikelihoodCellCycleMarker.cpp:44-83. 10 variables:
    [S_entry_time, S_duration, plateau_duration, base_signal,
    S_signal_increase, plateau_signal_increase, mitosis_signal_fraction,
    mitosis_signal_decrease, additive_noise, proportional_noise]."""

    def __init__(self, varset: VariableSet, data: np.ndarray):
        if varset.num_variables != 10:
            raise ValueError("Variable set should contain exactly 10 variables")
        self.data = np.asarray(data, dtype=np.float64)

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        i = torch.arange(len(self.data), dtype=xs.dtype, device=xs.device)
        s_entry, s_dur, plat_dur, base, s_inc, plat_inc, mit_frac, mit_dec, add_noise, \
            prop_noise = (xs[:, k, None] for k in range(10))
        plateau_time = s_entry + s_dur
        mitosis_time = plateau_time + plat_dur

        x = base.expand(-1, len(self.data))
        in_s = (i > s_entry) & (i <= plateau_time)
        in_plateau = (i > plateau_time) & (i <= mitosis_time)
        post = i > mitosis_time
        x = torch.where(in_s, base + s_inc * (i - s_entry), x)
        x = torch.where(in_plateau, base + s_dur * s_inc + (i - plateau_time) * plat_inc, x)
        x = torch.where(
            post,
            base + (s_dur * s_inc + plat_dur * plat_inc) * mit_frac
            - mit_dec * (i - mitosis_time),
            x,
        )
        y = _data(self.data, xs)
        sigma = add_noise + prop_noise * x.clamp(min=0.0)
        pointwise = log_pdf_tnu4(y, x, sigma)
        # NaN data entries are skipped (LogPdfTnu4 skip_na=true)
        return torch.where(torch.isnan(y), 0.0, pointwise).sum(dim=-1)


def create_cell_cycle_marker(varset: VariableSet, attrs):
    import csv

    data_file = attrs.get("data_file")
    track_ix = int(attrs.get("ccm.track_ix", attrs.get("track_ix", "0")))
    with open(data_file) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    # reference CSVParser: first row = header, first column = row label
    body = rows[1:] if len(rows) > 1 else rows
    vals = [
        [float(v) if v not in ("", "na", "NA", "nan") else np.nan for v in r[1:]]
        for r in body
    ]
    return CellCycleMarkerLikelihood(varset, np.asarray(vals[track_ix]))


# ---------------------------------------------------------------------------
# mitosis_time_estimation


class MitosisTimeEstimationLikelihood:
    """reference: LikelihoodMitosisTimeEstimation.cpp. Boxcar mitosis
    trajectories with Sobol-quantile durations and starts scaled by the
    sampled sds, Gaussian trajectory noise, Hungarian-matched to the
    observed ones."""

    def __init__(self, varset: VariableSet, timepoints, observed):
        self.varset = varset
        self.timepoints = np.asarray(timepoints, dtype=np.float64)
        self.observed = np.asarray(observed, dtype=np.float64)  # (T, ncell)
        ncell = self.observed.shape[1]
        from scipy.stats import norm, qmc

        eng = qmc.Sobol(d=2, scramble=False)
        n_pow2 = 1 << max(0, int(np.ceil(np.log2(max(ncell, 1)))))
        u = np.clip(eng.random(n_pow2)[:ncell], 1e-12, 1 - 1e-12)
        # reference: 2^QuantileNormal(u; 0, 0.5) (cpp:52-57)
        self.sobol_values = np.power(2.0, norm.ppf(u) * 0.5)
        self._ix = {
            name: varset.index_of(name)
            for name in ("mitosis_times_stdev", "entry_time_stdev", "trajectory_noise_stdev")
        }

    def cost(self, xs: torch.Tensor) -> torch.Tensor:
        """The (B, n_obs, n_sim) matched-pair log-likelihoods, on the rows'
        device: each observed trajectory against each simulated boxcar."""
        mt_sd = torch.pow(10.0, xs[:, self._ix["mitosis_times_stdev"]])
        et_sd = torch.pow(10.0, xs[:, self._ix["entry_time_stdev"]])
        noise_sd = torch.pow(10.0, xs[:, self._ix["trajectory_noise_stdev"]])

        sob = _data(self.sobol_values, xs)
        sim_times = sob[:, 0] * mt_sd[:, None]  # (B, ncell)
        start_times = sob[:, 1] * et_sd[:, None]
        tp = _data(self.timepoints, xs)  # (T,)
        sim = ((tp >= start_times[..., None])
               & (tp < (start_times + sim_times)[..., None])).to(xs.dtype)  # (B, ncell, T)

        obs = _data(self.observed.T, xs)  # (ncell, T)
        T = tp.shape[0]
        inv_two = (1.0 / (2.0 * noise_sd * noise_sd))[:, None, None]
        C = (-torch.log(noise_sd) - _LOG_SQRT_2PI)[:, None, None]
        # the squared distances summed over time one timepoint at a time:
        # (B, n_obs, n_sim) live, never (B, n_obs, n_sim, T)
        ss = torch.zeros((xs.shape[0], obs.shape[0], sim.shape[1]), dtype=xs.dtype,
                         device=xs.device)
        for k in range(T):
            d = obs[None, :, None, k] - sim[:, None, :, k]
            ss = ss + d * d
        return T * C - ss * inv_two

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        cost = self.cost(xs)
        return batched_hungarian(cost, np.ones(cost.shape[1], dtype=bool),
                                 np.ones(cost.shape[2], dtype=bool))


def create_mitosis_time_estimation(varset: VariableSet, attrs):
    import h5py

    data_file = attrs.get("data_file", "trajectories.nc")
    with h5py.File(data_file, "r") as f:
        g = f["simulation"]
        timepoints = np.asarray(g["time"])
        observed = np.asarray(g["trajectories"])
    return MitosisTimeEstimationLikelihood(varset, timepoints, observed)


# ---------------------------------------------------------------------------
# incucyte_population


@dataclass
class IncucyteExperiment:
    timepoints: np.ndarray  # (T,)
    concentrations: np.ndarray  # (C,) log10
    drug_confluence: np.ndarray  # (T, C, R)
    drug_apoptosis: np.ndarray  # (T, C, R)
    neg_confluence: np.ndarray  # (T, R)
    neg_apoptosis: np.ndarray  # (T, R)
    pos_confluence: np.ndarray  # (T, R)
    pos_apoptosis: np.ndarray  # (T, R)
    ctb: np.ndarray  # (C,)
    treatment_time: float
    seeding_density: float
    experiment_ix: int


SOLVERS = ("ring", "fixed", "budget", "adaptive")


def grid_like(stop: float, num: int, like: torch.Tensor) -> torch.Tensor:
    """`jnp.linspace(0, stop, num)` in like's dtype: stop * (i / (num - 1))
    for i < num - 1, then stop exactly (torch.linspace computes its second
    half from the end, which rounds otherwise)."""
    step = torch.arange(num - 1, dtype=like.dtype, device=like.device) / (num - 1)
    return torch.cat([stop * step, torch.full((1,), stop, dtype=like.dtype, device=like.device)])


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`jnp.interp(x, xp, fp)` over fp's last axis, in its arithmetic: the
    interval from a right-sided search, a zero-width interval's left value,
    and fp's end values outside xp. x (K,) reads every row of fp (...,
    len(xp)) at the same points, giving (..., K); x (..., K) with more
    axes reads each row at its own points (leading axes broadcast)."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    if x.dim() <= 1:
        lo, hi = fp[..., i - 1], fp[..., i]
    else:
        rows = torch.broadcast_shapes(fp.shape[:-1], x.shape[:-1])
        fr, ir = fp.expand(*rows, fp.shape[-1]), i.expand(*rows, i.shape[-1])
        lo, hi = fr.gather(-1, ir - 1), fr.gather(-1, ir)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(str(xp.dtype).removeprefix("torch.")).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, lo, lo + (delta / torch.where(dx0, 1.0, dx)) * (hi - lo))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


class IncucytePopulationLikelihood:
    """reference: src/likelihoods/LikelihoodIncucytePopulation.cpp.
    Variables by name: log10_cell_size, apoptotic_cell_size,
    pao_apoptotic_cell_size, debris_size, apoptosis_marker_size,
    pao_apoptosis_marker_size, debris_apoptosis_marker_size,
    proliferation_rate, apoptosis_rate, apoptosis_duration,
    apoptosis_remove_rate, drug_delay, drug_effect_time, pao_delay,
    pao_effect_time, pao_apoptosis_rate, contact_inhibition_start,
    contact_inhibition_max_confluence, contact_inhibition_apoptosis_rate,
    cell_preadherence_size, cell_adherence_time,
    starting_dead_cell_fraction, seeding_density_deviation_<i>,
    drug_proliferation_rate_<ci>, drug_apoptosis_rate_<ci>,
    sigma_confluence, sigma_apoptosis_marker, sigma_ctb.

    `solver` is one of `SOLVERS`: `ring` (the default: RK4 with a sliding
    history of `ring_size or max(16, grid_points // 4)` rows; delays beyond
    it clamp), `fixed` (RK4 with the whole history), `budget` (BS3(2) in
    max(2 * grid_points, 512) trips) or `adaptive` (BS3(2),
    `trips_per_interval` substeps a grid interval); the adaptive ones at
    the reference's rtol 1e-6 / atol 1e-2
    (LikelihoodIncucytePopulation.cpp:131)."""

    def __init__(
        self,
        varset: VariableSet,
        experiments: List[IncucyteExperiment],
        use_pao_control: bool = True,
        grid_points: int = 256,
        solver: str = "ring",
        trips_per_interval: int = 8,
        ring_size: int | None = None,
    ):
        self.varset = varset
        self.experiments = experiments
        self.use_pao_control = use_pao_control
        self.grid_points = grid_points
        self.solver = solver
        self.trips_per_interval = trips_per_interval
        self.ring_size = ring_size
        self._ix = {name: i for i, name in enumerate(varset.names)}

    def _v(self, xs, name):
        return xs[:, self._ix[name]]

    def _well_lanes(self, xs, e: IncucyteExperiment):
        """The per-well parameters of every row, (B, W) with W = 2 + C
        wells [negative, positive (pao), drug_0..drug_{C-1}]
        (reference: EvaluateLogProbability, cpp:205-225)."""
        v = lambda name: self._v(xs, name)
        C = len(e.concentrations)
        prolif = v("proliferation_rate")
        apo = v("apoptosis_rate") * prolif
        cell_size = torch.pow(10.0, v("log10_cell_size")) * 9.174312e-6

        # sequential subtraction from the highest concentration down: the
        # rates of concentration ci accumulate the deltas of all cj >= ci
        rel_prolif = torch.ones_like(prolif)
        cum_apo = apo
        drug = {}
        for ci in range(C - 1, -1, -1):
            rel_prolif = (rel_prolif - v(f"drug_proliferation_rate_{ci + 1}")).clamp(min=0.0)
            cum_apo = cum_apo + v(f"drug_apoptosis_rate_{ci + 1}")
            drug[ci] = (rel_prolif * prolif, cum_apo)
        # the negative control's drug rates are NaN: "no drug", the ramp
        # then keeps the base rates
        nan = torch.full_like(prolif, float("nan"))
        w_prolif = torch.stack([nan, torch.zeros_like(prolif)]
                               + [drug[ci][0] for ci in range(C)], dim=1)
        w_apo = torch.stack([nan, v("pao_apoptosis_rate")] + [drug[ci][1] for ci in range(C)],
                            dim=1)

        def per_well(drug_value, pao_value):
            return torch.stack([drug_value, pao_value] + [drug_value] * C, dim=1)

        delay_t = per_well(v("drug_delay"), v("pao_delay"))
        apoptotic_size = per_well(v("apoptotic_cell_size") * cell_size,
                                  v("pao_apoptotic_cell_size") * cell_size)
        has_drug = torch.ones(C + 2, dtype=torch.bool, device=xs.device)
        has_drug[0] = False
        return dict(
            wp=w_prolif, wa=w_apo, st=e.treatment_time + delay_t,
            et=per_well(v("drug_effect_time"), v("pao_effect_time")),
            asize=apoptotic_size, hd=has_drug.expand(xs.shape[0], C + 2),
            prolif=prolif, apo=apo, cell_size=cell_size,
        )

    def _solve(self, rhs, y0, grid, delay):
        if self.solver == "fixed":
            return solve_dde_grid(rhs, y0, grid, delay)
        if self.solver == "ring":
            return solve_dde_ring(rhs, y0, grid, delay,
                                  ring_size=self.ring_size or max(16, self.grid_points // 4))
        if self.solver == "budget":
            return solve_dde_budget(rhs, y0, grid, delay, rtol=1e-6, atol=1e-2,
                                    total_trips=max(2 * self.grid_points, 512))
        if self.solver == "adaptive":
            return solve_dde_adaptive(rhs, y0, grid, delay, rtol=1e-6, atol=1e-2,
                                      trips_per_interval=self.trips_per_interval)
        raise ValueError(f"unknown solver '{self.solver}'; one of {SOLVERS}")

    def well_problem(self, xs, e: IncucyteExperiment):
        """The delay ODE of every well of every row as B * W lanes: (rhs,
        y0 (B * W, 3), grid (G,), delay (B * W,)), the solver's inputs."""
        B = xs.shape[0]
        v = lambda name: self._v(xs, name)
        w = self._well_lanes(xs, e)
        W = w["wp"].shape[1]

        def lanes(a):  # (B,) or (B, W) -> (B * W,)
            return (a[:, None].expand(B, W) if a.dim() == 1 else a).reshape(B * W)

        prolif, apo = lanes(w["prolif"]), lanes(w["apo"])
        remove = lanes(v("apoptosis_remove_rate"))
        cs, asize = lanes(w["cell_size"]), lanes(w["asize"])
        ds = lanes(v("debris_size") * w["cell_size"])
        ci_start = lanes(v("contact_inhibition_start"))
        ci_width = (lanes(v("contact_inhibition_max_confluence")) - ci_start).clamp(min=1e-12)
        st = lanes(w["st"])
        # a well without drug ramps over an infinite time: its fraction is 0
        et = torch.where(lanes(w["hd"]), lanes(w["et"]).clamp(min=1e-12), float("inf"))
        wp, wa = lanes(w["wp"]), lanes(w["wa"])
        wp = torch.where(torch.isnan(wp), prolif, wp)
        wa = torch.where(torch.isnan(wa), apo, wa)
        # (proliferation, apoptosis) before the drug and the drug's change
        base = torch.stack([prolif, apo], dim=1)
        change = torch.stack([wp, wa], dim=1) - base
        # the contact inhibition's argument, (confluence - start) / width,
        # as one weighted sum of the state
        ci_weights = torch.stack([cs, asize, ds], dim=1) * (0.01 / ci_width)[:, None]
        ci_offset = ci_start / ci_width

        def rhs(t, y, yd, args):
            # drug ramp (reference: CalculateDrugEffect:414-425); before
            # the ramp's start its fraction clamps to 0
            frac = ((t - st) / et).clamp(0.0, 1.0)
            rates = torch.addcmul(base, frac[:, None], change)
            # contact inhibition (reference: :426-439); below its start
            # the factor clamps to 0
            ci = ((y * ci_weights).sum(dim=-1) - ci_offset).clamp(0.0, 1.0)
            p_eff, a_eff = rates[:, 0] * (1.0 - ci), rates[:, 1]
            removed = remove * yd[:, 1]
            dead = a_eff * y[:, 0]
            return torch.stack([p_eff * y[:, 0] - dead, dead - removed, removed], dim=-1)

        seed_dev = v(f"seeding_density_deviation_{e.experiment_ix + 1}")
        dead_frac = v("starting_dead_cell_fraction")
        n0 = e.seeding_density * torch.pow(10.0, seed_dev)
        y0 = torch.stack([n0 * (1.0 - dead_frac), dead_frac * n0, torch.zeros_like(n0)], dim=1)
        y0 = y0[:, None].expand(B, W, 3).reshape(B * W, 3)
        grid = grid_like(float(e.timepoints[-1]), self.grid_points, xs)
        return rhs, y0, grid, lanes(v("apoptosis_duration"))

    def _simulate_wells(self, xs, e: IncucyteExperiment):
        """Integrate every well of every row as one batch of B * W lanes.
        Returns ys (B, W, 3, T) at the timepoints and ok (B,)."""
        rhs, y0, grid, delay = self.well_problem(xs, e)
        res = self._solve(rhs, y0, grid, delay)
        ys = interp(_data(e.timepoints, xs), grid, res.ys.transpose(1, 2))  # (B * W, 3, T)
        B = xs.shape[0]
        return ys.reshape(B, -1, 3, ys.shape[-1]), res.ok.reshape(B, -1).all(dim=1)

    def simulate_experiment(self, xs: torch.Tensor, e: IncucyteExperiment):
        """Every derived observable of one experiment's wells for each row
        (reference: LikelihoodIncucytePopulation.h:28-35,
        interface_incucyte.cpp:55-121): wells [negative, positive (pao),
        drug_0..drug_{C-1}], each matrix (B, W, T), `ctb` (B, C), `ok`
        (B,)."""
        v = lambda name: self._v(xs, name)[:, None, None]
        cell_size = torch.pow(10.0, v("log10_cell_size")) * 9.174312e-6
        marker_size = v("apoptosis_marker_size") * cell_size
        pao_marker_size = v("pao_apoptosis_marker_size") * cell_size
        debris_marker_size = v("debris_apoptosis_marker_size") * marker_size
        debris_size = v("debris_size") * cell_size
        pre_size = v("cell_preadherence_size")
        adh_time = v("cell_adherence_time")

        ys, ok = self._simulate_wells(xs, e)
        asize = self._well_lanes(xs, e)["asize"]
        tp = _data(e.timepoints, xs)
        size_factor = torch.where(
            tp < adh_time, pre_size + (1.0 - pre_size) * tp / adh_time.clamp(min=1e-12), 1.0
        )  # (B, 1, T)
        confluence = (ys[:, :, 0] * cell_size * size_factor + ys[:, :, 1] * asize[..., None]
                      + ys[:, :, 2] * debris_size)
        is_pao = torch.zeros(ys.shape[1], 1, dtype=torch.bool, device=xs.device)
        is_pao[1] = True
        msize = torch.where(is_pao, pao_marker_size, marker_size)  # (B, W, 1)
        marker = torch.where(tp < e.treatment_time, 0.0,
                             ys[:, :, 1] * msize + ys[:, :, 2] * debris_marker_size)
        # CTB: the final cell count relative to the negative control's
        neg_final = ys[:, 0, 0, -1:]
        ctb_sim = torch.where(neg_final > 0.0, ys[:, 2:, 0, -1] / neg_final, 0.0)
        return {
            "cell_count": ys[:, :, 0],
            "apoptotic_cell_count": ys[:, :, 1],
            "debris": ys[:, :, 2],
            "confluence": confluence,
            "apoptosis_marker": marker,
            "ctb": ctb_sim,
            "ok": ok,
        }

    def score_experiment(self, xs, e: IncucyteExperiment, sim, total):
        """`total` plus the t(nu=3) residuals of one experiment's observed
        confluence and apoptosis marker (each scored well weighted 0.25 / T,
        in the reference's order) and of its CTB; NaN observations are
        skipped."""
        sigma_confl = self._v(xs, "sigma_confluence")[:, None, None, None]
        sigma_apo = self._v(xs, "sigma_apoptosis_marker")[:, None, None, None]
        C = len(e.concentrations)
        factor = 0.25 / len(e.timepoints)
        # the scored wells in the reference's order, observed (W', T, R)
        wells = [0] + ([1] if self.use_pao_control else []) + [2 + ci for ci in range(C)]
        obs_c = np.stack([e.neg_confluence, e.pos_confluence]
                         + [e.drug_confluence[:, ci, :] for ci in range(C)])[wells]
        obs_m = np.stack([e.neg_apoptosis, e.pos_apoptosis]
                         + [e.drug_apoptosis[:, ci, :] for ci in range(C)])[wells]

        def well_sums(sim_x, obs, sigma):
            obs = _data(obs, xs)
            lp = log_pdf_tnu3(obs, sim_x[:, wells, :, None], sigma)
            return torch.where(torch.isnan(obs), 0.0, lp).sum(dim=(2, 3))  # (B, W')

        lc = well_sums(sim["confluence"], obs_c, sigma_confl)
        lm = well_sums(sim["apoptosis_marker"], obs_m, sigma_apo)
        for k in range(len(wells)):
            total = total + factor * (lc[:, k] + lm[:, k])
        obs_ctb = _data(e.ctb, xs)
        lp_ctb = log_pdf_tnu3(obs_ctb, sim["ctb"], self._v(xs, "sigma_ctb")[:, None])
        return total + torch.where(torch.isnan(obs_ctb), 0.0, lp_ctb).sum(dim=1)

    def log_prob_batched(self, xs: torch.Tensor) -> torch.Tensor:
        total = torch.zeros(xs.shape[0], dtype=xs.dtype, device=xs.device)
        all_ok = torch.ones(xs.shape[0], dtype=torch.bool, device=xs.device)
        for e in self.experiments:
            sim = self.simulate_experiment(xs, e)
            all_ok = all_ok & sim["ok"]
            total = self.score_experiment(xs, e, sim, total)
        return torch.where(all_ok & torch.isfinite(total), total, float("-inf"))


def load_incucyte_experiments(data_file: str, drug: str, cell_line: str
                              ) -> List[IncucyteExperiment]:
    import h5py

    out = []
    with h5py.File(data_file, "r") as f:
        base = f[drug][cell_line]
        names = sorted(k for k in base.keys() if k.startswith("experiment"))
        for ei, name in enumerate(names):
            g = base[name]
            out.append(
                IncucyteExperiment(
                    timepoints=np.asarray(g["time"], dtype=np.float64),
                    concentrations=np.log10(np.asarray(g["drug_concentrations"],
                                                       dtype=np.float64)),
                    drug_confluence=np.asarray(g["drug_confluence"]),
                    drug_apoptosis=np.asarray(g["drug_apoptosis_marker"]),
                    neg_confluence=np.asarray(g["negative_control_confluence"]),
                    neg_apoptosis=np.asarray(g["negative_control_apoptosis_marker"]),
                    pos_confluence=np.asarray(g["positive_control_confluence"]),
                    pos_apoptosis=np.asarray(g["positive_control_apoptosis_marker"]),
                    ctb=np.asarray(g["cell_titer_blue_norm"]),
                    treatment_time=float(g.attrs["treatment_time"]),
                    seeding_density=float(g.attrs["seeding_density"]),
                    experiment_ix=ei,
                )
            )
    return out


def create_incucyte_population(varset: VariableSet, attrs):
    root = attrs.get("_xml_root")
    drug = root.get("drug") if root is not None else attrs.get("drug")
    cell_line = root.get("cell_line") if root is not None else attrs.get("cell_line")
    data_file = attrs.get("data_file", "drug_response_data.nc")
    if root is not None and root.get("data_file"):
        data_file = root.get("data_file")
    experiments = load_incucyte_experiments(data_file, drug, cell_line)
    use_pao = attrs.get("use_pao_control", "true")
    if root is not None and root.get("use_pao_control"):
        use_pao = root.get("use_pao_control")
    return IncucytePopulationLikelihood(
        varset, experiments, use_pao_control=str(use_pao).lower() in ("1", "true")
    )
