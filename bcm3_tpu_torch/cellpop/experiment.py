"""Cellpop experiment: SBML model + data + variability -> batched log-probability.

Counterpart of bcm3_tpu/cellpop/experiment.py (reference:
src/cellpop/Experiment.cpp). One experiment owns an SBML cell model,
treatment trajectories, cell-variability descriptions and data
likelihoods; `log_prob_batched` simulates the populations of a batch of
rows as one device computation (cellpop/simulate.py, every cell slot of
every row a lane) and scores them: the population-average data on the
device, the matched types' costs on the device and their matchings on the
host, B rows in one native call a data likelihood
(`finish_log_prob_host_batch` in the JAX package).

XML schema preserved (Experiment.cpp Load:403-620): attributes name,
model_file, data_file, solver_type/tolerances, num_cells, max_cells,
divide_cells, entry_time, synchronization_time_offset,
trailing_simulation_time, simulate_past_chromatid_separation_time,
solver_max_steps, solver_trips; child elements set_parameter,
set_species, experiment_specific_parameter, cell_variability, data,
treatment_trajectory; prior-variable conventions species_<name> (initial
value from a sampled parameter) and ratio_<name>/total_<name>
(active/inactive split, Experiment.cpp:429-485).

The data file (`data_file`, HDF5) is opened with h5py when one is named.
`data` may instead give the experiment's group as a mapping of name ->
numpy array, for a machine without h5py.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from bcm3_tpu_torch.cellpop import data_likelihood as dl_mod
from bcm3_tpu_torch.cellpop.simulate import (
    EV_ANAPHASE_ONSET,
    EV_NEBD,
    EV_PCNA_GFP_INCREASE,
    EV_REPLICATION_START,
    PopulationConfig,
    simulate_population,
)
from bcm3_tpu_torch.cellpop.treatment import create_treatment_trajectory
from bcm3_tpu_torch.cellpop.variability import (
    ValueRef,
    VariabilityDescription,
    sobol_unit_normals,
)
from bcm3_tpu_torch.likelihoods.cellmisc import interp
from bcm3_tpu_torch.model.variables import VariableSet
from bcm3_tpu_torch.sbml import SBMLModel

_SYNC_EVENT = {
    "none": -1,
    "": -1,
    "DNA_replication_start": EV_REPLICATION_START,
    "PCNA_gfp_increase": EV_PCNA_GFP_INCREASE,
    "mitosis": EV_NEBD,
    "nuclear_envelope_breakdown": EV_NEBD,
    "anaphase": EV_ANAPHASE_ONSET,
}

_MATCHED = (dl_mod.DataLikelihoodTimeCourse, dl_mod.DataLikelihoodTimePoints,
            dl_mod.DataLikelihoodDuration)


def _parse_species_target(experiment, name: str) -> dl_mod.SpeciesTarget:
    """'a+b' sums; names are ODE or constant species
    (reference: DataLikelihoodTimePoints.cpp:118-175)."""
    parts = [p.strip() for p in name.split("+")]
    idx = []
    model = experiment.model
    for p in parts:
        if p in model.ode_species:
            idx.append(model.ode_species.index(p))
        elif p in model.constant_species:
            idx.append(model.num_ode_species + model.constant_species.index(p))
        else:
            raise ValueError(f"Could not find species '{p}' as dynamic or constant species")
    return dl_mod.SpeciesTarget(name=name, sim_indices=idx)


class Experiment:
    """`sparse_stiff` chooses the stiff path's stage solver: True (the
    default) takes the SparseStageSolver where the model has at least 3
    species and its fill is at most 0.6 n^2, as the JAX package does unless
    BCM3_SPARSE_STIFF=0; False always takes the dense LU."""

    def __init__(
        self,
        node: ET.Element,
        varset: VariableSet,
        base_dir: str = ".",
        non_sampled_names: Optional[List[str]] = None,
        sparse_stiff: bool = True,
        data: Optional[Mapping[str, np.ndarray]] = None,
    ):
        self.name = node.get("name")
        self.varset = varset
        self.non_sampled_names = list(non_sampled_names or [])
        model_file = node.get("model_file")
        if not os.path.isabs(model_file):
            model_file = os.path.join(base_dir, model_file)
        self.model = SBMLModel.from_file(model_file)

        self.initial_cells = int(node.get("num_cells", "1"))
        self.max_cells = int(node.get("max_cells", "20"))
        self.divide_cells = node.get("divide_cells", "true").lower() in ("1", "true")
        self.trailing_time = float(node.get("trailing_simulation_time", "0.0"))
        self.past_sep_time = float(node.get("simulate_past_chromatid_separation_time", "0.0"))
        self.solver_type = node.get("solver_type", "CVODE")
        self.rtol = float(node.get("solver_relative_tolerance", str(4 * np.finfo(np.float32).eps)))
        self.atol = float(node.get("solver_absolute_tolerance", str(4 * np.finfo(np.float32).eps)))
        self.max_solver_steps = int(node.get("solver_max_steps", "10000"))
        # whole-trajectory step budget: 0 = the adaptive solvers; > 0 = the
        # budget solvers with this many steps
        self.solver_trips = int(node.get("solver_trips", "0"))

        # entry time: sampled variable, non-sampled parameter or fixed
        self.entry_time_ref = ValueRef(node.get("entry_time", "0"))
        if not self.entry_time_ref.resolve(varset, self.non_sampled_names):
            raise ValueError(f"Cannot resolve entry_time '{self.entry_time_ref.string}'")
        sync_offset = node.get("synchronization_time_offset", "")
        self.sync_offset_ref = None
        if sync_offset:
            self.sync_offset_ref = ValueRef(sync_offset)
            if not self.sync_offset_ref.resolve(varset, self.non_sampled_names):
                raise ValueError(f"Cannot resolve synchronization_time_offset '{sync_offset}'")

        # fixed parameters from <set_parameter>
        self.fixed_params: Dict[str, float] = {}
        for sp in node.findall("set_parameter"):
            self.fixed_params[sp.get("parameter_name")] = float(sp.get("value"))

        # <set_species>: override an initial value (Experiment.cpp:497-509)
        self.set_species: Dict[int, float] = {}
        for ss in node.findall("set_species"):
            sname = ss.get("species_name")
            if sname in self.model.ode_species:
                self.set_species[self.model.ode_species.index(sname)] = float(ss.get("value"))

        # experiment-specific parameter replacement (Experiment.cpp:515-528)
        self.param_replacements: List[tuple] = []
        for ep in node.findall("experiment_specific_parameter"):
            self.param_replacements.append(
                (varset.index_of(ep.get("parameter_name")),
                 varset.index_of(ep.get("replacement_parameter_name")))
            )

        # species_<name> / ratio_<name>+total_<name> prior conventions
        self.species_init_map: List[tuple] = []  # (ode_ix, var_ix)
        self.ratio_maps: List[tuple] = []  # (active_ix, inactive_ix, ratio_var, total_var or None)
        for i, vname in enumerate(varset.names):
            if vname.startswith("species_"):
                sp = vname[len("species_"):]
                if sp in self.model.ode_species:
                    self.species_init_map.append((self.model.ode_species.index(sp), i))
            elif vname.startswith("ratio_"):
                base = vname[len("ratio_"):]
                total_ix = None
                for j, v2 in enumerate(varset.names):
                    if v2 == f"total_{base}":
                        total_ix = j
                act = f"active_{base}"
                inact = f"inactive_{base}"
                if act not in self.model.ode_species or inact not in self.model.ode_species:
                    raise ValueError(
                        f"ratio variable '{vname}' requires species "
                        f"'active_{base}' and 'inactive_{base}' in the model"
                    )
                self.ratio_maps.append((self.model.ode_species.index(act),
                                        self.model.ode_species.index(inact), i, total_ix))

        # variabilities
        self.variabilities = [
            VariabilityDescription.from_xml(cv) for cv in node.findall("cell_variability")
        ]
        for v in self.variabilities:
            v.resolve(varset, self.non_sampled_names)
        total_dims = sum(v.num_dimensions for v in self.variabilities)
        self.sobol_normals = sobol_unit_normals(total_dims, self.initial_cells)

        # data + data likelihoods + treatment trajectories
        self.data_likelihoods: List = []
        self.treatments: List[tuple] = []  # (constant_species_ix, trajectory)
        data_file = node.get("data_file", "")
        group = data
        self._h5 = None
        if group is None and data_file:
            import h5py

            path = data_file if os.path.isabs(data_file) else os.path.join(base_dir, data_file)
            self._h5 = h5py.File(path, "r")
            group = self._h5[self.name]

        for tnode in node.findall("treatment_trajectory"):
            sname = tnode.get("species_name")
            if sname not in self.model.constant_species:
                raise ValueError(f"Treatment species '{sname}' must be a constant species")
            cix = self.model.constant_species.index(sname)
            self.treatments.append((cix, create_treatment_trajectory(tnode, group)))

        for dnode in node.findall("data"):
            self.data_likelihoods.append(self._load_data_likelihood(dnode, group))

        # simulation horizon & grid
        max_tp = 0.0
        for dl in self.data_likelihoods:
            tp = getattr(dl, "timepoints", None)
            if tp is not None and len(tp):
                max_tp = max(max_tp, float(np.max(tp)))
            max_tp = max(max_tp, float(getattr(dl, "simulation_time", 0.0)))
        self.end_time = max_tp + self.trailing_time
        if self.end_time <= 0:
            self.end_time = 2000.0  # reference fallback without data

        # parameter plumbing for the RHS
        self.param_names = list(varset.names)
        self._rhs_jac = self.model.make_rhs_jacobian(
            self.param_names, self.non_sampled_names, self.fixed_params
        )

        # static-sparsity stage solver for the stiff path (the reference's
        # sparse-LU analogue, src/utils/EigenPartialPivLUSomewhatSparse.h;
        # dense when the pattern is near full)
        self.sparse_solver = None
        if self.solver_type != "DP5" and sparse_stiff and self.model.num_ode_species >= 3:
            from bcm3_tpu_torch.ode.sparse_lu import SparseStageSolver

            cand = SparseStageSolver(self.model.jacobian_sparsity())
            n = self.model.num_ode_species
            if cand.fill_nnz <= 0.6 * n * n:
                self.sparse_solver = cand

        rounds = 0
        cap = self.initial_cells
        while cap < self.max_cells and self.divide_cells:
            cap *= 2
            rounds += 1
        self.pop_config = PopulationConfig.from_model(
            self.model,
            capacity=self.max_cells,
            initial_cells=self.initial_cells,
            max_generations=min(rounds, 6),
            divide_cells=self.divide_cells,
            solver="DP5" if self.solver_type == "DP5" else "CVODE",
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_solver_steps,
            solver_trips=self.solver_trips or None,
            simulate_past_chromatid_separation_time=self.past_sep_time,
            max_sobol_index=len(self.sobol_normals) if total_dims else 0,
            sparse=self.sparse_solver,
        )

        # grid: dense enough for event interpolation + data reads
        G = max(128, 4 * len(self._all_timepoints()) + 8)
        self.grid = np.linspace(0.0, self.end_time * 1.0001 + 1e-6, G)

        self.non_sampled_values = np.zeros(len(self.non_sampled_names))
        # instrumentation, off by default: a list gets one
        # simulate.RoundRecord a round of each simulation; on_stage(name)
        # is called after each stage of an evaluation
        self.rounds: Optional[list] = None
        self.on_stage: Optional[Callable[[str], None]] = None
        self._consts: Dict = {}

    def _all_timepoints(self):
        out = []
        for dl in self.data_likelihoods:
            tp = getattr(dl, "timepoints", None)
            if tp is not None:
                out.extend(np.asarray(tp).ravel().tolist())
        return out

    def close(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def _stage(self, name):
        if self.on_stage is not None:
            self.on_stage(name)

    def _const(self, name, arr, like: torch.Tensor) -> torch.Tensor:
        """A host array as a tensor in like's dtype and device, made once."""
        key = (name, like.dtype, str(like.device))
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                                                device=like.device)
        return self._consts[key]

    # ------------------------------------------------------------------

    def _load_data_likelihood(self, node, group):
        dtype = node.get("type", "time_course")
        err = dl_mod.ErrorSpec.from_xml(node)
        err.resolve(self.varset, self.non_sampled_names)
        data_name = node.get("data_name")
        sync = node.get("synchronize", "none")
        if sync not in _SYNC_EVENT:
            raise ValueError(f"Unknown synchronization '{sync}'")

        if dtype == "duration":
            observed = np.asarray(group[data_name], dtype=np.float64)
            return dl_mod.DataLikelihoodDuration(
                error=err,
                observed=observed,
                period=node.get("period"),
                simulation_time=float(node.get("simulation_time", "0")),
            )

        species_names = [s.strip() for s in node.get("species_name").split(";") if s.strip()]
        species = [_parse_species_target(self, s) for s in species_names]
        raw = np.asarray(group[data_name], dtype=np.float64)
        # the time dimension name holds the timepoints
        time_dim = None
        ds = group[data_name]
        if "DIMENSION_LIST" in getattr(ds, "attrs", {}):
            try:
                time_dim = np.asarray(ds.dims[0][0], dtype=np.float64)
            except Exception:
                time_dim = None
        if time_dim is None:
            tname = node.get("time_dimension", "time")
            time_dim = np.asarray(group[tname], dtype=np.float64)

        if dtype == "time_points":
            obs = raw if raw.ndim == 3 else raw[:, :, None]
            return dl_mod.DataLikelihoodTimePoints(
                error=err, timepoints=time_dim, observed=obs, species=species,
                synchronize=sync,
            )
        if dtype == "time_course_population_average":
            obs = raw if raw.ndim == 2 else raw[None, :]
            return dl_mod.DataLikelihoodPopulationAverage(
                error=err,
                timepoints=time_dim,
                observed=obs,
                species=species,
                include_only_mitotic=node.get(
                    "include_only_cells_that_went_through_mitosis", "false"
                ).lower() in ("1", "true"),
            )
        if dtype == "time_course":
            # observed layout (n_cells, T) or (n_cells, T, S)
            return dl_mod.DataLikelihoodTimeCourse(
                error=err, timepoints=time_dim, observed=raw, species=species,
                synchronize=sync,
            )
        raise ValueError(f"Unknown data likelihood type '{dtype}'")

    # ------------------------------------------------------------------
    # Evaluation, a batch of rows: tv (B, D) transformed values

    def _nsp(self, tv):
        return self._const("nsp", self.non_sampled_values, tv)

    def _rhs(self, t_cell, y, args):
        params, const_y, creation = args
        if self.treatments:
            cols = list(const_y.unbind(dim=-1))
            for cix, traj in self.treatments:
                cols[cix] = traj.concentration(t_cell, creation)
            const_y = torch.stack(cols, dim=-1)
        return self._rhs_jac(t_cell, y, const_y, params, self._nsp(y), derivatives=False)

    def _jac(self, t_cell, y, args):
        """(rhs, d rhs/dt, d rhs/dy) from the model's compiled tangents; an
        experiment with treatments, whose time enters through them, takes
        its derivatives by `torch.func` instead (`jac` None)."""
        params, const_y, _ = args
        return self._rhs_jac(t_cell, y, const_y, params, self._nsp(y))

    def _initial_state(self, tv):
        """(B, n) initial ODE states incl. species_/ratio_ prior
        conventions and set_species overrides."""
        B = tv.shape[0]
        base = self._const("y0", self.model.initial_ode_values(), tv)
        cols = list(base.expand(B, base.shape[0]).unbind(dim=-1))
        for six, val in self.set_species.items():
            cols[six] = tv.new_full((B,), val)
        for six, vix in self.species_init_map:
            cols[six] = tv[:, vix]
        init_base = self.model.initial_ode_values()
        for act, inact, ratio_ix, total_ix in self.ratio_maps:
            if total_ix is not None:
                cols[act] = tv[:, ratio_ix] * tv[:, total_ix]
                cols[inact] = (1.0 - tv[:, ratio_ix]) * tv[:, total_ix]
            else:
                total = float(init_base[act] + init_base[inact])
                cols[act] = tv[:, ratio_ix] * total
                cols[inact] = (1.0 - tv[:, ratio_ix]) * total
        return torch.stack(cols, dim=-1)

    def _vectors(self, vd, dim0, tv, nsp, rows=None):
        """vd's scaled variability vectors (B, K, D) for the Sobol rows
        `rows` ((B, K) indices, default all M)."""
        un = self._const("sobol", self.sobol_normals, tv)[:, dim0 : dim0 + vd.num_dimensions]
        u = un[None].expand(tv.shape[0], *un.shape) if rows is None else un[rows]
        return vd.pseudorandom_vector(u, tv, nsp)

    def _cell_params(self, tv, nsp, initial: bool):
        """Variability-applied parameter tables (B, M, V), M the Sobol
        table's length (gathered by slot in the simulator)."""
        M = max(len(self.sobol_normals), 1)
        out = tv[:, None, :].expand(tv.shape[0], M, tv.shape[1])
        if not self.variabilities:
            return out
        cols = list(out.unbind(dim=-1))
        dim0 = 0
        for vd in self.variabilities:
            vecs = self._vectors(vd, dim0, tv, nsp)
            for d, var in enumerate(vd.variables):
                if not var.parameter_name:
                    continue
                if var.only_initial_cells and not initial:
                    continue
                if var.parameter_name in self.varset.names:
                    pix = self.varset.index_of(var.parameter_name)
                    v = -vecs[..., d] if var.negate else vecs[..., d]
                    cols[pix] = var.apply(cols[pix], v)
            dim0 += vd.num_dimensions
        return torch.stack(cols, dim=-1)

    def _initial_conditions_with_variability(self, y0, tv, nsp, initial: bool):
        """(B, M, n) per-Sobol-row initial conditions."""
        M = max(len(self.sobol_normals), 1)
        out = y0[:, None, :].expand(y0.shape[0], M, y0.shape[1])
        if not self.variabilities:
            return out
        cols = list(out.unbind(dim=-1))
        dim0 = 0
        for vd in self.variabilities:
            vecs = self._vectors(vd, dim0, tv, nsp)
            for d, var in enumerate(vd.variables):
                if not var.species_name:
                    continue
                if var.only_initial_cells and not initial:
                    continue
                if var.species_name in self.model.ode_species:
                    six = self.model.ode_species.index(var.species_name)
                    v = -vecs[..., d] if var.negate else vecs[..., d]
                    cols[six] = var.apply(cols[six], v)
            dim0 += vd.num_dimensions
        return torch.stack(cols, dim=-1)

    def _entry_times(self, tv, nsp):
        """(B, N) creation times of the slots incl. entry-time variability
        of the initial cells."""
        B, N, C0 = tv.shape[0], self.max_cells, self.initial_cells
        entry = self.entry_time_ref.value(tv, nsp)
        times = tv.new_zeros((B, N)) + entry[:, None]
        if not self.variabilities:
            return times
        dim0 = 0
        for vd in self.variabilities:
            for d, var in enumerate(vd.variables):
                if var.entry_time:
                    rows = torch.arange(C0, device=tv.device).expand(B, C0)
                    v = self._vectors(vd, dim0, tv, nsp, rows)[..., d]
                    if var.negate:
                        v = -v
                    times = torch.cat([var.apply(times[:, :C0], v), times[:, C0:]], dim=1)
            dim0 += vd.num_dimensions
        return times

    def _make_child_ic_fn(self, tv, nsp):
        """(y (B, N, n), sobol_ix (B, N)) -> y with daughter-cell
        initial-condition variability applied (reference: Cell.cpp
        Initialize:150-177 with is_initial_cell=false)."""
        specs = []
        dim0 = 0
        for vd in self.variabilities:
            for d, var in enumerate(vd.variables):
                if (var.species_name and not var.only_initial_cells
                        and var.species_name in self.model.ode_species):
                    specs.append((vd, dim0, d, self.model.ode_species.index(var.species_name)))
            dim0 += vd.num_dimensions
        if not specs:
            return None

        def child_ic(y, sobol_ix):
            cols = list(y.unbind(dim=-1))
            for vd, d0, d, six in specs:
                v = self._vectors(vd, d0, tv, nsp, sobol_ix.long())[..., d]
                var = vd.variables[d]
                if var.negate:
                    v = -v
                cols[six] = var.apply(cols[six], v)
            return torch.stack(cols, dim=-1)

        return child_ic

    def simulate(self, tv, nsp=None):
        """The population simulations of the rows of tv (B, D)."""
        if nsp is None:
            nsp = self._nsp(tv)
        if self.param_replacements:
            tv = tv.clone()
            for pix, rix in self.param_replacements:
                tv[:, pix] = tv[:, rix]
        B, N = tv.shape[0], self.max_cells
        y0 = self._initial_state(tv)
        cell_params_tab = self._cell_params(tv, nsp, initial=True)
        child_params_tab = self._cell_params(tv, nsp, initial=False)
        y0_tab = self._initial_conditions_with_variability(y0, tv, nsp, initial=True)
        # initial cells gather Sobol rows 0..C0-1 (slot == Sobol index for
        # initial cells, CellPopulation.cpp:79); daughters gather their own
        # Sobol rows inside the simulator
        slot_rows = torch.clamp(torch.arange(N, device=tv.device), 0, y0_tab.shape[1] - 1)
        init_y = y0_tab[:, slot_rows]
        consts = self._const("const_y", self.model.initial_constant_values(), tv)
        const_y = consts.expand(B, N, consts.shape[0])
        creation = self._entry_times(tv, nsp)
        self._stage("setup")
        return simulate_population(
            self.pop_config,
            self._rhs,
            init_y,
            const_y,
            cell_params_tab,
            child_params_tab,
            creation,
            self._const("grid", self.grid, tv),
            target_time=self.end_time,
            child_ic_fn=self._make_child_ic_fn(tv, nsp),
            rounds=self.rounds,
            on_stage=self.on_stage,
            jac=None if self.treatments else self._jac,
        )

    def _read_species(self, result, target: dl_mod.SpeciesTarget, times, sync_ev):
        """(B, T, N) values of one species target at experiment times
        times (B, T)."""
        n_ode = self.model.num_ode_species
        grid = self._const("grid", self.grid, times)
        treat_by_cix = {cix: traj for cix, traj in self.treatments}
        B, N = result.active.shape
        G = grid.shape[0]
        species_traj = None
        for ix in target.sim_indices:
            if ix < n_ode:
                col = result.traj[..., ix]  # (B, N, G)
            elif (ix - n_ode) in treat_by_cix:
                # treatment species: the trajectory on each cell's grid
                # (reference: Experiment.cpp:337-343 reads GetConcentration
                # at the output time)
                col = treat_by_cix[ix - n_ode].concentration(grid, result.creation[..., None])
            else:
                const_val = float(self.model.initial_constant_values()[ix - n_ode])
                col = times.new_full((B, N, G), const_val)
            species_traj = col if species_traj is None else species_traj + col

        if sync_ev < 0:
            cell_t = times[:, None, :] - result.creation[..., None]  # (B, N, T)
        else:
            ev_t = result.event_times[..., sync_ev]
            ref = torch.where(torch.isnan(ev_t), result.end_cell_time, ev_t)
            cell_t = times[:, None, :] + ref[..., None]
        val = interp(cell_t, grid, species_traj)
        ok = (cell_t >= 0.0) & (cell_t <= result.end_cell_time[..., None])
        vals = torch.where(ok & result.active[..., None], val, torch.nan)
        return vals.transpose(1, 2)

    def _population_size(self, result, times):
        """(B, T) alive-cell counts at times (B, T) (reference:
        CellPopulation.cpp CountCellsAtTime:92-110)."""
        cell_t = times[:, :, None] - result.creation[:, None, :]
        alive = (result.active[:, None, :] & (cell_t >= 0.0)
                 & (cell_t <= result.end_cell_time[:, None, :]))
        return alive.sum(dim=-1)

    def _time_offset(self, tv, nsp):
        if self.sync_offset_ref is None:
            return tv.new_zeros(tv.shape[0])
        return self.sync_offset_ref.value(tv, nsp)

    def _data_sim_values(self, result, dl, tv, nsp):
        """(times (B, T), sim (B, T, N, S)) simulated values at one data
        likelihood's timepoints (Experiment.cpp:296-312)."""
        times = self._const(("timepoints", id(dl)), dl.timepoints, tv)[None, :] \
            + self._time_offset(tv, nsp)[:, None]
        sync_ev = _SYNC_EVENT[dl.synchronize] if hasattr(dl, "synchronize") else -1
        sim = torch.stack(
            [self._read_species(result, target, times, sync_ev) for target in dl.species],
            dim=-1,
        )
        return times, sim

    def log_prob_parts(self, tv, nsp=None):
        """The device half of an evaluation: (partial logp (B,), ok (B,),
        costs), costs one (cost, obs_valid, sim_valid) triple a matched
        data likelihood in `matched_dls` order (the time-points triple
        stacked (B, T, ...), one matching a timepoint)."""
        if nsp is None:
            nsp = self._nsp(tv)
        result = self.simulate(tv, nsp)
        logp = tv.new_zeros(tv.shape[0])
        costs = []
        for dl in self.data_likelihoods:
            if isinstance(dl, dl_mod.DataLikelihoodDuration):
                costs.append(dl._cost(result.event_times, result.active, tv, nsp))
                continue
            times, sim = self._data_sim_values(result, dl, tv, nsp)
            if isinstance(dl, _MATCHED):
                costs.append(dl._cost(sim, tv, nsp))
                continue
            pop = self._population_size(result, times)
            logp = logp + dl.evaluate(sim, pop, tv, nsp)
        self._stage("readout")
        return logp, result.ok, tuple(costs)

    @property
    def matched_dls(self):
        """The Hungarian-matched data likelihoods, in the order
        :meth:`log_prob_parts` emits their cost matrices."""
        return [dl for dl in self.data_likelihoods if isinstance(dl, _MATCHED)]

    def finish_log_prob_host_batch(self, partial_logp, ok, costs):
        """The host half: each matched data likelihood's B (time points: B
        x T) matchings in one native call, weighted and added (weight 0 x
        -inf = NaN -> -inf, as in the JAX package's float arithmetic);
        -inf where a simulation failed. (B,) on the partial's device."""
        total = partial_logp
        for dl, (cost, ov, sv) in zip(self.matched_dls, costs):
            total = total + dl.error.weight * dl.matched(cost, ov, sv)
        return torch.where(~ok | torch.isnan(total), -torch.inf, total)

    def log_prob_batched(self, tv, nsp=None):
        """Experiment log-probability of each row of TRANSFORMED values tv
        (B, D)."""
        out = self.finish_log_prob_host_batch(*self.log_prob_parts(tv, nsp))
        self._stage("scoring")
        return out

    # ------------------------------------------------------------------
    # Posterior-predictive accessors (the Python side of the R bridge;
    # reference: src/bcmrbridge/interface_cellpop.cpp:45-418), one row tv (D,)

    @property
    def num_species(self) -> int:
        """reference: Experiment.h:60 GetNumSpecies (ODE + constant)."""
        return self.model.num_simulated_species

    @property
    def species_names(self):
        """Ordered ODE species then constant species — the indexing
        _read_species and the species targets use."""
        m = self.model
        return [m.species_full_name(s) for s in m.ode_species] + [
            m.species_full_name(s) for s in m.constant_species
        ]

    def output_timepoints(self, n_timepoints: int = 500):
        """Evenly spaced global-time output grid (reference:
        Experiment.cpp:19,322-324)."""
        return np.linspace(0.0, self.end_time, n_timepoints)

    def simulated_trajectories(self, tv, nsp=None, n_timepoints: int = 500):
        """(timepoints (T,), values (n_cells, T, n_species), parents
        (n_cells,)) for all active cells of one row tv (D,) — the analogue
        of bcm3_rbridge_cellpop_get_simulated_trajectories
        (interface_cellpop.cpp:96-148). Parents index into the returned
        cell axis; -1 marks initial cells."""
        tv = tv[None]
        result = self.simulate(tv, nsp)
        times = torch.as_tensor(self.output_timepoints(n_timepoints), dtype=tv.dtype,
                                device=tv.device)[None]
        vals = torch.stack(
            [self._read_species(result, dl_mod.SpeciesTarget(name=name, sim_indices=[ix]),
                                times, -1)
             for ix, name in enumerate(self.species_names)],
            dim=-1,
        )[0]  # (T, N, S)
        active = result.active[0].cpu().numpy()
        cell_ix = np.where(active)[0]
        remap = -np.ones(active.shape[0], dtype=np.int64)
        remap[cell_ix] = np.arange(len(cell_ix))
        parents = result.parent[0].cpu().numpy()[cell_ix]
        parents = np.where(parents >= 0, remap[np.clip(parents, 0, None)], -1)
        values = vals.cpu().numpy().transpose(1, 0, 2)[cell_ix]
        return times[0].cpu().numpy(), values, parents

    def simulated_data(self, tv, data_ix: int, nsp=None):
        """(times, simulated values) for one data likelihood of one row tv
        (D,) — the analogue of bcm3_rbridge_cellpop_get_simulated_data
        (interface_cellpop.cpp:291-416). Layouts: duration -> (N,);
        population average -> (T,); otherwise per-cell (N, T, S)."""
        tv = tv[None]
        if nsp is None:
            nsp = self._nsp(tv)
        result = self.simulate(tv, nsp)
        dl = self.data_likelihoods[data_ix]
        if isinstance(dl, dl_mod.DataLikelihoodDuration):
            sim = dl.durations_from_events(result.event_times)
            sim = torch.where(result.active, sim, torch.nan)
            return np.zeros(1), sim[0].cpu().numpy()
        times, sim = self._data_sim_values(result, dl, tv, nsp)
        if isinstance(dl, dl_mod.DataLikelihoodPopulationAverage):
            avg, _ = dl.average(sim, self._population_size(result, times))
            return times[0].cpu().numpy(), avg[0].cpu().numpy()
        return times[0].cpu().numpy(), sim[0].cpu().numpy().transpose(1, 0, 2)

    def matched_simulation(self, tv, data_ix: int, nsp=None, n_timepoints: int = 500):
        """(timepoints, values (n_obs, T, n_species)) — each observed cell's
        matched simulated cell's full species trajectories, one row tv (D,)
        (reference: interface_cellpop.cpp get_matched_simulation:418-480
        via DataLikelihoodTimeCourse::GetTrajectoryMatching)."""
        dl = self.data_likelihoods[data_ix]
        if not isinstance(dl, dl_mod.DataLikelihoodTimeCourse):
            raise TypeError("matched_simulation requires a time_course data likelihood")
        if nsp is None:
            nsp = self._nsp(tv[None])
        result = self.simulate(tv[None], nsp)
        _, sim = self._data_sim_values(result, dl, tv[None], nsp)
        match = dl.matching(sim, tv[None], nsp)[0]  # (n_obs,) sim-slot or -1
        times, values, _ = self.simulated_trajectories(tv, nsp, n_timepoints)
        active = result.active[0].cpu().numpy()
        remap = -np.ones(active.shape[0], dtype=np.int64)
        remap[np.where(active)[0]] = np.arange(int(active.sum()))
        out = np.full((len(match), len(times), self.num_species), np.nan)
        for oi, slot in enumerate(match):
            if slot >= 0 and remap[slot] >= 0:
                out[oi] = values[remap[slot]]
        return times, out
