"""Batched heterogeneous cell-population simulator, rows and slots as lanes.

Counterpart of bcm3_tpu/cellpop/simulate.py (reference:
src/cellpop/Experiment.cpp:635-846, Cell.cpp, CellPopulation.cpp). The
population of each row lives in a fixed-capacity slot array; a batch of B
rows holds B x N slots, and every slot that a round has to integrate is
one lane of one solve (dp5 or RODAS3, adaptive or budgeted). Rounds:
`max_generations` + 1; in each, the new cells integrate over the shared
cell-time grid, events are detected as first grid crossings with linear
interpolation (Cell.cpp integration_step_cb:463-538), and the dividing
cells' children take slots in slot order, two a division, with Sobol
index initial_cells + parent_index * 2 + child_ix (CellPopulation.cpp
:31-90).

Where the JAX package integrates every slot of a row in a round and keeps
the new ones' results (`upd`), skipping a round without new cells by
`lax.cond`, the port reads the new lanes' positions from the card once a
round (at most max_generations + 1 reads) and solves those lanes alone,
none when there are none. A lane's solve does not depend on the others'
(each lane's loop is its own), so the results are the same.

Thresholds (reference: Cell.cpp:467-538): replicating_DNA > 1e-4,
replicated_DNA > 1.95, PCNA_gfp > 0.5, nuclear_envelope < 0.5,
chromatid_separation > 1e-3 (extends simulation by
simulate_past_chromatid_separation_time), cytokinesis > 1 (divide),
apoptosis > 1 (die). On division the daughters inherit the parent's state
with cytokinesis=0, nuclear_envelope=1, G1S_break=1, G2_break=1,
spindle_components=0, assembled_spindle=0, chromatid_separation=0
(Cell.cpp SetInitialConditionsFromOtherCell:120-148).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from bcm3_tpu_torch.likelihoods.cellmisc import interp
from bcm3_tpu_torch.ode.dp5 import solve_at_times, solve_at_times_budget
from bcm3_tpu_torch.ode.rosenbrock import solve_at_times_stiff, solve_at_times_stiff_budget

# event slots in the event-times array
EV_REPLICATION_START = 0
EV_REPLICATION_FINISH = 1
EV_PCNA_GFP_INCREASE = 2
EV_NEBD = 3
EV_ANAPHASE_ONSET = 4
NUM_EVENTS = 5

_THRESHOLDS = {
    # event index -> (species key, threshold, crossing upward?)
    EV_REPLICATION_START: ("replicating_DNA", 1e-4, True),
    EV_REPLICATION_FINISH: ("replicated_DNA", 1.95, True),
    EV_PCNA_GFP_INCREASE: ("PCNA_gfp", 0.5, True),
    EV_NEBD: ("nuclear_envelope", 0.5, False),
    EV_ANAPHASE_ONSET: ("chromatid_separation", 1e-3, True),
}

# species reset on daughter cells (reference: Cell.cpp:126-133)
_DIVISION_RESETS = {
    "cytokinesis": 0.0,
    "nuclear_envelope": 1.0,
    "G1S_break": 1.0,
    "G2_break": 1.0,
    "spindle_components": 0.0,
    "assembled_spindle": 0.0,
    "chromatid_separation": 0.0,
}


@dataclass(frozen=True)
class PopulationConfig:
    """Static structure of a population simulation."""

    capacity: int  # max_number_of_cells
    initial_cells: int
    max_generations: int  # number of division rounds simulated
    divide_cells: bool = True
    event_species: Dict[str, int] = field(default_factory=dict)
    # ODE-species index of each named event species, -1 if absent
    division_reset_idx: tuple = ()  # ((species_ix, value), ...)
    solver: str = "DP5"  # "DP5" | "CVODE" (-> Rosenbrock)
    rtol: float = 1e-6
    atol: float = 1e-6
    max_steps: int = 10000
    # whole-trajectory step budget: the budget solvers (one static loop of
    # steps, no host read) in place of the adaptive per-segment ones
    solver_trips: Optional[int] = None
    simulate_past_chromatid_separation_time: float = 0.0
    max_sobol_index: int = 0  # 0 = no variability iterator
    # SparseStageSolver for the model's static Jacobian pattern
    # (ode/sparse_lu.py) in place of the dense stage LU; None = dense
    sparse: object = None

    @classmethod
    def from_model(cls, model, **kwargs) -> "PopulationConfig":
        """Resolve event/reset species indices from an SBMLModel."""
        ev = {}
        for _, (name, _thr, _up) in _THRESHOLDS.items():
            ev[name] = model.ode_species.index(name) if name in model.ode_species else -1
        for name in ("cytokinesis", "apoptosis"):
            ev[name] = model.ode_species.index(name) if name in model.ode_species else -1
        resets = [
            (model.ode_species.index(name), value)
            for name, value in _DIVISION_RESETS.items()
            if name in model.ode_species
        ]
        return cls(event_species=ev, division_reset_idx=tuple(resets), **kwargs)


class PopulationResult(NamedTuple):
    traj: torch.Tensor  # (B, N, G, n) trajectories on the cell-time grid
    creation: torch.Tensor  # (B, N) global creation times
    end_cell_time: torch.Tensor  # (B, N) valid cell-time horizon per slot
    event_times: torch.Tensor  # (B, N, NUM_EVENTS) cell-time; NaN = never
    divided: torch.Tensor  # (B, N) bool
    died: torch.Tensor  # (B, N) bool
    division_time: torch.Tensor  # (B, N) cell time of division (NaN = none)
    active: torch.Tensor  # (B, N) bool — slot holds a real cell
    parent: torch.Tensor  # (B, N) int32, -1 for initial cells
    sobol_index: torch.Tensor  # (B, N) int32
    is_initial: torch.Tensor  # (B, N) bool
    ok: torch.Tensor  # (B,) bool — all active-cell integrations succeeded


@dataclass
class RoundRecord:
    """One round of a simulation: how many lanes it solved (0 = skipped),
    which (their flat row x slot positions) and their steps (tensors on
    the device, read only by whoever asks)."""

    lanes: int
    index: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None


def _first_crossing_time(grid, vals, threshold, upward):
    """Time of the first crossing of `threshold` along vals' last axis (the
    grid), linearly interpolated; NaN if never crossed (the batched
    analogue of ODESolver::get_threshold_crossing_time)."""
    above = vals > threshold if upward else vals < threshold
    # first index where the condition holds (excluding t=0 state)
    idx = torch.argmax(above.to(torch.uint8), dim=-1)
    crossed = above.any(dim=-1)
    i = torch.clamp(idx, 1, grid.shape[0] - 1)
    v0 = vals.gather(-1, (i - 1)[..., None])[..., 0]
    v1 = vals.gather(-1, i[..., None])[..., 0]
    frac = torch.where(v1 != v0, (threshold - v0) / (v1 - v0), 0.0)
    frac = torch.clamp(frac, 0.0, 1.0)
    t_cross = grid[i - 1] + frac * (grid[i] - grid[i - 1])
    # crossing at the very first sample: report the grid start
    t_cross = torch.where(above[..., 0], grid[0], t_cross)
    return torch.where(crossed, t_cross, torch.nan)


def interp_grid(grid, traj_row, t):
    """Linear interpolation of trajectories (..., G) at cell times t (..., K)."""
    return interp(t, grid, traj_row)


def _solve(cfg: PopulationConfig, rhs, jac, y0, grid, args):
    """(ys (L, G, n), ok (L,), steps (L,)) of the lanes' solve."""
    kw = dict(args=args, rtol=cfg.rtol, atol=cfg.atol)
    stiff = dict(sparse=cfg.sparse, jac=jac)
    if cfg.solver_trips:
        if cfg.solver == "DP5":
            res = solve_at_times_budget(rhs, y0, grid, total_trips=cfg.solver_trips, **kw)
        else:
            res = solve_at_times_stiff_budget(rhs, y0, grid, total_trips=cfg.solver_trips,
                                              **stiff, **kw)
    elif cfg.solver == "DP5":
        res = solve_at_times(rhs, y0, grid, max_steps_per_segment=cfg.max_steps, **kw)
    else:
        res = solve_at_times_stiff(rhs, y0, grid, max_steps_per_segment=cfg.max_steps,
                                   **stiff, **kw)
    return res.ys, res.ok, res.n_steps


def _scatter_slots(dest, slot0, slot1, v0, v1):
    """dest (B, N, ...) with v0 and v1 (B, N, ...) written at each lane's
    slots (B, N); slot N (a lane with no child) is a column past the end,
    dropped, as the JAX package drops its out-of-range scatter."""
    B, N = dest.shape[:2]
    buf = torch.cat([dest, dest.new_zeros((B, 1) + dest.shape[2:])], dim=1)
    for slot, v in ((slot0, v0), (slot1, v1)):
        index = slot.view(B, N, *([1] * (dest.dim() - 2))).expand(v.shape)
        buf.scatter_(1, index, v)
    return buf[:, :N]


def simulate_population(
    cfg: PopulationConfig,
    rhs: Callable,  # f(t_cell (L,), y (L, n), (cell_params, const_y, creation)) -> (L, n)
    initial_y: torch.Tensor,  # (B, N, n) initial states for INITIAL cells
    const_y: torch.Tensor,  # (B, N, nc)
    cell_params: torch.Tensor,  # (B, M, V) Sobol table: initial-cell params
    child_params: torch.Tensor,  # (B, M, V) Sobol table: daughter-cell params
    creation0: torch.Tensor,  # (B, N) creation times (used for initial slots)
    grid: torch.Tensor,  # (G,) shared cell-time grid starting at 0
    target_time=None,  # global simulation end; default grid span
    child_ic_fn: Optional[Callable] = None,  # (y (B, N, n), sobol_ix (B, N)) -> y
    rounds: Optional[List[RoundRecord]] = None,
    on_stage: Optional[Callable[[str], None]] = None,
    jac: Optional[Callable] = None,
) -> PopulationResult:
    """Run the fixed-capacity population simulation of B rows.

    ``cell_params``/``child_params`` are each row's Sobol-indexed tables
    (row i = the variability-applied parameter vector for Sobol index i);
    each slot gathers its row by its Sobol index (CellPopulation.cpp
    :55-83). ``child_ic_fn`` applies daughter-cell initial-condition
    variability to the inherited division state (Cell.cpp Initialize
    :150-177 with is_initial_cell=false). `rounds`, given a list, gets one
    RoundRecord a round; `on_stage(name)` is called after each stage
    ("solve", "events", "allocation") of each round. `jac(t, y, args) ->
    (f, df/dt, df/dy)` gives the stiff solvers rhs's derivatives
    (ode/rosenbrock.py); without it they take them by `torch.func`."""
    B, N, n = initial_y.shape
    G = grid.shape[0]
    dtype, dev = initial_y.dtype, initial_y.device
    C0 = cfg.initial_cells
    M = cell_params.shape[1]
    stage = on_stage or (lambda name: None)

    ev = cfg.event_species

    def detect_events(tr):
        """Per-cell event extraction from (B, N, G, n) trajectories."""
        times = torch.full((B, N, NUM_EVENTS), torch.nan, dtype=dtype, device=dev)
        for ev_ix, (name, thr, up) in _THRESHOLDS.items():
            six = ev.get(name, -1)
            if six >= 0:
                times[..., ev_ix] = _first_crossing_time(grid, tr[..., six], thr, up)
        nan = torch.full((B, N), torch.nan, dtype=dtype, device=dev)
        div_t = (
            _first_crossing_time(grid, tr[..., ev["cytokinesis"]], 1.0, True)
            if ev.get("cytokinesis", -1) >= 0 and cfg.divide_cells else nan
        )
        death_t = (
            _first_crossing_time(grid, tr[..., ev["apoptosis"]], 1.0, True)
            if ev.get("apoptosis", -1) >= 0 else nan
        )
        return times, div_t, death_t

    span = grid[-1]
    if target_time is None:
        target_time = span

    slots = torch.arange(N, device=dev)
    traj = torch.full((B, N, G, n), torch.nan, dtype=dtype, device=dev)
    creation = creation0.to(dtype).clone()
    end_cell_time = torch.zeros((B, N), dtype=dtype, device=dev)
    event_times = torch.full((B, N, NUM_EVENTS), torch.nan, dtype=dtype, device=dev)
    divided = torch.zeros((B, N), dtype=torch.bool, device=dev)
    died = torch.zeros((B, N), dtype=torch.bool, device=dev)
    division_time = torch.full((B, N), torch.nan, dtype=dtype, device=dev)
    active = (slots < C0).expand(B, N)
    parent = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    sobol_index = torch.where(slots < C0, slots, 0).to(torch.int32).expand(B, N)
    is_initial = active
    y_start = initial_y
    newly_active = active
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    n_active = torch.full((B,), C0, dtype=torch.int32, device=dev)

    for rnd in range(cfg.max_generations + 1):
        rows = torch.clamp(sobol_index, 0, M - 1).long()
        params_round = torch.where(
            is_initial[..., None],
            cell_params.gather(1, rows[..., None].expand(B, N, cell_params.shape[2])),
            child_params.gather(1, rows[..., None].expand(B, N, child_params.shape[2])),
        )
        # the new lanes of the round: one read from the card
        lanes = newly_active.reshape(-1).nonzero().squeeze(1)
        record = RoundRecord(lanes=int(lanes.numel()), index=lanes)
        upd_ok = torch.ones(B * N, dtype=torch.bool, device=dev)
        if lanes.numel():
            args = (params_round.reshape(B * N, params_round.shape[-1])[lanes],
                    const_y.reshape(B * N, const_y.shape[-1])[lanes],
                    creation.reshape(-1)[lanes])
            ys, solve_ok, steps = _solve(cfg, rhs, jac, y_start.reshape(B * N, n)[lanes], grid,
                                         args)
            traj = traj.reshape(B * N, G, n).index_copy(0, lanes, ys).view(B, N, G, n)
            upd_ok = upd_ok.index_copy(0, lanes, solve_ok)
            record.steps = steps
        if rounds is not None:
            rounds.append(record)
        stage("solve")
        ev_times, div_t, death_t = detect_events(traj)

        # effective end of each cell's own simulation window: the global
        # target time in cell time (reference: Cell::Simulate
        # simulation_end_time = end_time - creation, Cell.cpp:199-203)
        horizon = torch.minimum(torch.clamp(target_time - creation, min=0.0), span)
        end_t = torch.minimum(
            torch.where(torch.isnan(div_t), torch.inf, div_t),
            torch.where(torch.isnan(death_t), torch.inf, death_t),
        )
        anaphase = ev_times[..., EV_ANAPHASE_ONSET]
        extended = torch.where(
            torch.isnan(anaphase),
            horizon,
            torch.maximum(horizon, anaphase + cfg.simulate_past_chromatid_separation_time),
        )
        end_t = torch.minimum(end_t, torch.minimum(extended, span))

        upd = newly_active
        event_times = torch.where(upd[..., None], ev_times, event_times)
        end_cell_time = torch.where(upd, end_t, end_cell_time)
        # division only happens inside the simulation window (reference:
        # Experiment.cpp SimulateCell:734 'divide && achieved < target')
        this_divided = upd & ~torch.isnan(div_t) & (div_t < horizon)
        this_died = (
            upd
            & ~torch.isnan(death_t)
            & (death_t < horizon)
            & (torch.where(torch.isnan(div_t), torch.inf, div_t) > death_t)
        )
        this_divided = this_divided & ~this_died
        divided = torch.where(upd, this_divided, divided)
        died = torch.where(upd, this_died, died)
        division_time = torch.where(upd, torch.where(this_divided, div_t, torch.nan),
                                    division_time)
        ok = ok & upd_ok.view(B, N).all(dim=1)
        stage("events")

        if rnd == cfg.max_generations or not cfg.divide_cells:
            break

        # ---- allocate children (slot-order first fit) ----
        child_sobol0 = C0 + sobol_index * 2 + 0
        child_sobol1 = C0 + sobol_index * 2 + 1
        can_divide = this_divided
        if cfg.max_sobol_index > 0:
            can_divide = can_divide & (child_sobol1 < cfg.max_sobol_index)
        cd = can_divide.to(torch.int32)
        n_children_before = 2 * torch.cumsum(cd, dim=1, dtype=torch.int32) - 2 * cd
        slot0 = n_active[:, None] + n_children_before
        slot1 = slot0 + 1
        fits = can_divide & (slot1 < N)
        slot0 = torch.where(fits, slot0, N).long()
        slot1 = torch.where(fits, slot1, N).long()

        # division state: the parent's trajectory at the division time
        t_div = torch.where(torch.isnan(div_t), 0.0, div_t)
        y_div = interp(t_div[:, :, None, None].expand(B, N, n, 1), grid,
                       traj.transpose(2, 3))[..., 0]  # (B, N, n)
        if cfg.division_reset_idx:
            y_div = y_div.clone()
            for six, val in cfg.division_reset_idx:
                y_div[..., six] = val
        if child_ic_fn is not None:
            # daughter initial-condition variability, gathered by the
            # CHILD's Sobol index (two daughters differ)
            y_div0 = child_ic_fn(y_div, torch.clamp(child_sobol0, 0, M - 1))
            y_div1 = child_ic_fn(y_div, torch.clamp(child_sobol1, 0, M - 1))
        else:
            y_div0 = y_div1 = y_div

        parent_ids = slots.to(torch.int32).expand(B, N)
        child_creation = creation + t_div
        new_active = _scatter_slots(torch.zeros((B, N), dtype=torch.bool, device=dev),
                                    slot0, slot1, fits, fits)
        newly_active = new_active
        y_start = _scatter_slots(y_start, slot0, slot1, y_div0, y_div1)
        creation = _scatter_slots(creation, slot0, slot1, child_creation, child_creation)
        parent = _scatter_slots(parent, slot0, slot1, parent_ids, parent_ids)
        sobol_index = _scatter_slots(sobol_index, slot0, slot1, child_sobol0.to(torch.int32),
                                     child_sobol1.to(torch.int32))
        is_initial = is_initial & ~newly_active
        active = active | newly_active
        n_active = n_active + 2 * fits.sum(dim=1, dtype=torch.int32)
        stage("allocation")
        # const_y is shared (treatment species are set through the rhs
        # closure); children inherit the same constant species
        # (reference: Cell.cpp:124 copies constant_species_y)

    return PopulationResult(
        traj=traj,
        creation=creation,
        end_cell_time=end_cell_time,
        event_times=event_times,
        divided=divided,
        died=died,
        division_time=division_time,
        active=active,
        parent=parent,
        sobol_index=sobol_index,
        is_initial=is_initial,
        ok=ok,
    )


def species_value_at(grid, species_col, time, creation, end_cell_time, sync_time=None):
    """Interpolated species value of each cell at experiment times
    (reference: Cell.cpp GetInterpolatedSpeciesValue:280-340): cell_time =
    time - creation, or time + sync event time when synchronized; NaN
    outside [0, end_cell_time]. species_col (..., G); time (..., K);
    creation, end_cell_time and sync_time (..., 1) or broadcastable."""
    cell_t = time - creation if sync_time is None else time + sync_time
    val = interp(cell_t, grid, species_col)
    valid = (cell_t >= 0.0) & (cell_t <= end_cell_time)
    return torch.where(valid, val, torch.nan)
