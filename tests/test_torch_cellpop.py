"""The port's cell-population likelihood (bcm3_tpu_torch/cellpop) against the
JAX package's (bcm3_tpu/cellpop), float64, on identical inputs.

Both packages build each likelihood through their `create_likelihood` from
one likelihood.xml with inline SBML and a data.nc written here with h5py,
and score the same rows; the JAX side is `jax.jit(jax.vmap(log_prob))`.
Configurations, at the JAX tests' smallest shapes:

- the DP5 experiment of tests/test_cellpop_experiment.py (1 initial cell,
  capacity 7, population average);
- bench.py's stiff `cellpop` model (tools/bench_cellpop.py, adaptive
  RODAS3, Sobol variability on k_div) at capacity 4 with 2 initial cells,
  through the sparse stage solver (the JAX package's default) and the dense
  one (BCM3_SPARSE_STIFF=0 there, `sparse_stiff=False` here);
- a pulse treatment on a constant species that a rate law reads (the
  stiff solver's derivatives then by torch.func);
- every matched data type in one experiment (time points, duration, time
  course and a population average, tests/test_cellpop_matched_types.py's
  cycle model), and a failed integration (a NaN rate) scoring -inf;
- `simulate_population` on tests/test_cellpop_simulate.py's toy model: the
  division tree, and death before division.

Held: -inf sets equal; every slot's state (active, parent, Sobol index,
division, death) equal; trajectories, event times and creation times
within 1e-10 of each state's scale; log-densities within 1e-10. The
adaptive RODAS3 lands a clipped step with t + (t1 - t), one ulp short of
the stop for some last bits of t (tests/test_torch_rosenbrock.py), and the
stage LU rounds differently here, so some lanes take another step
sequence: a lane off by more than 1e-10 is printed and held to 1e-5 (the
solver's rtol 1e-6), and its row's log-density to 1e-6; at most a third of
the stiff lanes may.
"""

import dataclasses
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cellpop_experiment import CELL_MODEL as GROWTH_MODEL
from test_cellpop_matched_types import _cycle_model
from test_cellpop_simulate import _config, _rhs

import chip_smoke
from bcm3_tpu.cellpop import simulate as jsim
from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch.cellpop.simulate import PopulationConfig, simulate_population
from bcm3_tpu_torch.convert import population_config_from_arrays
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.model.variables import VariableSet

F64 = torch.float64
FLIP_TOL, FLIP_ROW_TOL = 1e-5, 1e-6


def _write(d, model, data, experiment):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cell.xml"), "w") as f:
        f.write(model)
    with h5py.File(os.path.join(d, "data.nc"), "w") as f:
        g = f.create_group("exp1")
        for k, v in data.items():
            g.create_dataset(k, data=v)
    path = os.path.join(d, "likelihood.xml")
    with open(path, "w") as f:
        f.write('<bcm_likelihood type="cell_population">\n' + experiment
                + "</bcm_likelihood>\n")
    return path


def _both(path, names, **kw):
    vs, jvs = VariableSet(), JVariableSet()
    for n in names:
        vs.add_variable(n)
        jvs.add_variable(n)
    return create_likelihood(path, vs, **kw), jax_create_likelihood(path, jvs)


def _lane_errors(a, b):
    """Each slot's largest difference of its trajectory (..., G, n),
    relative to each species' largest magnitude over the slot; NaN sets
    must agree."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.maximum(np.nanmax(np.abs(a), axis=-2, keepdims=True, initial=0.0), 1e-300)
    return np.nanmax(np.where(np.isnan(a), 0.0, np.abs(a - b) / scale), axis=(-2, -1),
                     initial=0.0)


def _compare(name, got, ref, max_flip_share=1 / 3):
    """A port PopulationResult of B rows against the JAX package's vmapped
    one. Returns the rows holding a lane off by more than 1e-10."""
    for f in ("active", "parent", "sobol_index", "is_initial", "divided", "died", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f"{name}: {f}")
    err = _lane_errors(np.asarray(ref.traj), got.traj.numpy())  # (B, N)
    for f in ("creation", "end_cell_time", "division_time", "event_times"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{name}: {f}")
        d = np.where(np.isnan(a), 0.0, np.abs(a - b) / np.maximum(np.abs(a), 1.0))
        err = np.maximum(err, d.reshape(*err.shape, -1).max(axis=-1))
    active = got.active.numpy()
    flips = np.argwhere(active & (err > 1e-10))
    for row, slot in flips:
        print(f"{name}: row {row} slot {slot} off by {err[row, slot]:.3e} (held to "
              f"{FLIP_TOL}): another step sequence")
    assert err.max() <= FLIP_TOL, (name, err.max())
    assert len(flips) <= max_flip_share * active.sum(), (name, len(flips))
    return np.unique(flips[:, 0])


def _jax_both(jlik, xs):
    """The JAX package's log-densities and simulations of the rows (its
    variables untransformed here), in one compiled program."""
    jexp = jlik.model.experiments[0]
    lp, res = jax.jit(jax.vmap(lambda x: (jlik.log_prob(x), jexp.simulate(x))))(jnp.asarray(xs))
    return np.asarray(lp), res


def _rows(name, got, ref, flipped_rows=()):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert not np.isnan(got).any()
    fin = np.isfinite(ref)
    rel = np.abs(got - ref) / np.abs(ref)
    limit = np.full(len(ref), 1e-10)
    limit[list(flipped_rows)] = FLIP_ROW_TOL
    bad = fin & (rel > limit)
    assert not bad.any(), (name, rel[fin], limit)


# ---------------------------------------------------------------------------
# the DP5 experiment


@pytest.fixture(scope="module")
def dp5(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp5"))
    times = np.array([0.5, 2.0, 4.5, 6.0, 7.5])
    path = _write(d, GROWTH_MODEL, {"time": times, "avg_mass": np.exp(0.1 * times)[None, :]},
                  '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
                  '  num_cells="1" max_cells="7" divide_cells="true" entry_time="0"\n'
                  '  solver_type="DP5" solver_relative_tolerance="1e-8"\n'
                  '  solver_absolute_tolerance="1e-10" trailing_simulation_time="0.5">\n'
                  '  <data type="time_course_population_average" data_name="avg_mass"\n'
                  '    species_name="mass" error_model="normal" stdev="sd"/>\n'
                  "</experiment>\n")
    lik, jlik = _both(path, ("k_growth", "k_div", "sd"))
    xs = np.array([[0.1, 0.25, 0.05], [0.12, 0.25, 0.05], [0.1, 0.3, 0.08],
                   [0.3, 0.25, 0.05]])
    return lik, jlik, xs


def test_dp5_experiment_matches_jax(dp5):
    lik, jlik, xs = dp5
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref, jres = _jax_both(jlik, xs)
    assert np.isfinite(got).all() and got[0] > got[3]
    exp = lik.model.experiments[0]
    res = exp.simulate(torch.as_tensor(xs))
    _compare("dp5", res, jres, max_flip_share=0)
    _rows("dp5", got, ref)
    # k_div = 0.25: divisions at t = 4 and 8 (past the end, 8.0): 3 cells
    assert res.active[0].sum() == 3
    pop = exp._population_size(res, torch.tensor([[1.0, 5.0]], dtype=F64).expand(4, 2))
    np.testing.assert_array_equal(pop[0].numpy(), [1, 2])


def test_batched_equals_one_row_calls(dp5):
    """log_prob_batched of a batch equals a loop of one-row calls."""
    lik, _, xs = dp5
    batch = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    single = [lik.log_prob_batched(torch.as_tensor(x)[None]).item() for x in xs]
    np.testing.assert_allclose(batch, single, rtol=1e-12)


# ---------------------------------------------------------------------------
# bench.py's stiff cellpop model, sparse and dense stage solvers


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_stiff_cellpop_matches_jax(tmp_path, monkeypatch, sparse):
    path, data = chip_smoke.cellpop_files(str(tmp_path), "cellpop", 4, 2)
    with h5py.File(tmp_path / "data.nc", "w") as f:
        g = f.create_group("exp1")
        for k, v in data.items():
            g.create_dataset(k, data=v)
    monkeypatch.setenv("BCM3_SPARSE_STIFF", "1" if sparse else "0")
    lik, jlik = _both(path, chip_smoke.CELLPOP_NAMES, _sparse_stiff=sparse)
    exp, jexp = lik.model.experiments[0], jlik.model.experiments[0]
    assert (exp.sparse_solver is None) == (jexp.sparse_solver is None) == (not sparse)
    xs = chip_smoke.cellpop_rows(3)
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref, jres = _jax_both(jlik, xs)
    res = exp.simulate(torch.as_tensor(xs))
    flipped = _compare(f"stiff {'sparse' if sparse else 'dense'}", res, jres)
    assert np.isfinite(got).all() and res.active.sum() == 3 * 4
    _rows("stiff", got, ref, flipped)


# a treatment: a drug pulse on a constant species that the growth law reads

TREATED_MODEL = f"""<?xml version="1.0"?>
<sbml xmlns="{chip_smoke.SBML_NS}" level="2" version="4">
<model id="cell">
<listOfSpecies>
  <species id="mass" initialAmount="1.0"/>
  <species id="cytokinesis" initialAmount="0.0"/>
  <species id="drug" initialAmount="0.0"/>
</listOfSpecies>
<listOfReactions>
  <reaction id="growth">
    <listOfProducts><speciesReference species="mass"/></listOfProducts>
    <kineticLaw><math xmlns="{chip_smoke.MATHML}"><apply><times/><ci>k_growth</ci><ci>mass</ci>
      <apply><minus/><cn>1</cn><apply><times/><cn>0.5</cn><ci>drug</ci></apply></apply>
    </apply></math></kineticLaw>
  </reaction>
  <reaction id="division_clock">
    <listOfProducts><speciesReference species="cytokinesis"/></listOfProducts>
    <kineticLaw><math xmlns="{chip_smoke.MATHML}"><ci>k_div</ci></math></kineticLaw>
  </reaction>
</listOfReactions>
</model>
</sbml>
"""


def test_treatment_matches_jax(tmp_path):
    """Pulses on the constant species `drug`, which slows growth: the
    right-hand side reads the treatment at every step, so the stiff solver
    takes its derivatives (d/dt through the pulse) by torch.func; the data
    read the sum of an ODE species and the treated one."""
    times = np.array([0.5, 2.0, 4.5, 6.0, 7.5])
    path = _write(str(tmp_path), TREATED_MODEL,
                  {"time": times, "avg_mass": np.exp(0.1 * times)[None, :]},
                  '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
                  '  num_cells="2" max_cells="4" divide_cells="true" entry_time="0"\n'
                  '  solver_type="CVODE" solver_relative_tolerance="1e-6"\n'
                  '  solver_absolute_tolerance="1e-8" trailing_simulation_time="0.5">\n'
                  '  <treatment_trajectory species_name="drug" type="pulses" times="0.5,3.0"/>\n'
                  '  <data type="time_course_population_average" data_name="avg_mass"\n'
                  '    species_name="mass+drug" error_model="normal" stdev="sd"/>\n'
                  "</experiment>\n")
    lik, jlik = _both(path, ("k_growth", "k_div", "sd"))
    xs = np.array([[0.1, 0.25, 0.05], [0.12, 0.3, 0.08], [0.09, 0.22, 0.06]])
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref, jres = _jax_both(jlik, xs)
    res = lik.model.experiments[0].simulate(torch.as_tensor(xs))
    assert np.isfinite(got).all()
    _rows("treatment", got, ref, _compare("treatment", res, jres))


# ---------------------------------------------------------------------------
# the matched data types, in one experiment


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("matched"))
    times = np.array([1.0, 2.5, 4.0])
    rng = np.random.default_rng(5)
    data = {
        "time": times,
        "obs_tp": np.exp(0.05 * times)[:, None] * rng.lognormal(0.0, 0.1, size=(3, 2)),
        "obs_tc": np.exp(0.05 * times)[None, :] * rng.lognormal(0.0, 0.1, size=(2, 1)),
        "obs_dur": np.array([2.1, 2.4]),
        "obs_avg": np.exp(0.05 * times)[None, :],
    }
    path = _write(
        d, _cycle_model(), data,
        '<experiment name="exp1" model_file="cell.xml" data_file="data.nc"\n'
        '  num_cells="2" max_cells="4" divide_cells="true" entry_time="0"\n'
        '  solver_type="CVODE" solver_relative_tolerance="1e-6"\n'
        '  solver_absolute_tolerance="1e-6" trailing_simulation_time="0.5">\n'
        '  <cell_variability distribution="diagonal_gaussian">\n'
        '    <variable model_parameter="k_rep" apply="multiplicative_log" scale="cv_krep"/>\n'
        "  </cell_variability>\n"
        '  <data type="time_points" data_name="obs_tp" species_name="mass"\n'
        '    error_model="normal" stdev="sd" time_dimension="time"/>\n'
        '  <data type="duration" data_name="obs_dur" period="Sphase"\n'
        '    error_model="normal" stdev="sd" simulation_time="8.0"/>\n'
        '  <data type="time_course" data_name="obs_tc" species_name="mass"\n'
        '    error_model="student_t4" stdev="sd" time_dimension="time" weight="0.5"/>\n'
        '  <data type="time_course_population_average" data_name="obs_avg"\n'
        '    species_name="mass" error_model="normal" stdev="sd" time_dimension="time"/>\n'
        "</experiment>\n")
    lik, jlik = _both(path, ("k_growth", "k_div", "k_rep", "k_rep2", "cv_krep", "sd"))
    base = np.array([0.05, 0.22, 0.8, 0.9, 0.25, 0.3])
    rng = np.random.default_rng(2)
    xs = base[None, :] * np.exp(0.08 * rng.normal(size=(3, 6)))
    # a NaN growth rate: the integration fails (non-finite states) -> -inf
    xs = np.concatenate([xs, [[np.nan, 0.22, 0.8, 0.9, 0.25, 0.3]]])
    return lik, jlik, xs


def test_matched_types_match_jax(matched):
    lik, jlik, xs = matched
    exp = lik.model.experiments[0]
    assert [type(dl).__name__ for dl in exp.matched_dls] == [
        "DataLikelihoodTimePoints", "DataLikelihoodDuration", "DataLikelihoodTimeCourse"]
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref, jres = _jax_both(jlik, xs)
    assert np.isneginf(got[3]) and np.isfinite(got[:3]).all()
    assert not bool(exp.simulate(torch.as_tensor(xs[3:])).ok[0])
    res = exp.simulate(torch.as_tensor(xs[:3]))
    flipped = _compare("matched", res, jax.tree_util.tree_map(lambda a: a[:3], jres))
    _rows("matched", got, ref, flipped)


def test_matched_accessors(matched):
    """The R-side accessors on one row, against the port's own simulation:
    the active cells' lineage, the matched cells' trajectories (the
    assignment against scipy's), each data likelihood's simulated data."""
    from scipy.optimize import linear_sum_assignment

    lik, _, xs = matched
    x = xs[0]
    t, values, parents = lik.model.simulated_trajectories(x, n_timepoints=20)
    _, mt = lik.model.matched_simulation(x, 2, n_timepoints=20)
    np.testing.assert_array_equal(parents, [-1, -1, 0, 0])
    np.testing.assert_allclose(t, np.linspace(0.0, 8.5, 20), rtol=1e-15)
    exp = lik.model.experiments[0]
    tv = torch.as_tensor(x)[None]
    res = exp.simulate(tv)
    dl = exp.data_likelihoods[2]
    cost, ov, sv = dl._cost(exp._data_sim_values(res, dl, tv, exp._nsp(tv))[1], tv, exp._nsp(tv))
    rows, cols = linear_sum_assignment(-cost[0].numpy())
    slots = np.flatnonzero(res.active[0].numpy())
    np.testing.assert_array_equal(mt[rows], values[np.searchsorted(slots, cols)])
    assert values.shape == (int(res.active.sum()), 20, exp.num_species)
    _, dur = lik.model.simulated_data(x, 1)
    expected = exp.data_likelihoods[1].durations_from_events(res.event_times[0])
    np.testing.assert_array_equal(dur, torch.where(res.active[0], expected, torch.nan).numpy())
    for ix, shape in ((0, (4, 3, 1)), (2, (4, 3, 1)), (3, (3,))):
        tt, sim = lik.model.simulated_data(x, ix)
        np.testing.assert_array_equal(tt, [1.0, 2.5, 4.0])
        assert sim.shape == shape


# ---------------------------------------------------------------------------
# simulate_population on the toy model


def _toy_rhs(t, y, args):
    params = args[0]
    return torch.stack([params[:, 0] * y[:, 0], params[:, 1], -0.0 * y[:, 2], params[:, 2]],
                       dim=1)


def test_simulate_population_matches_jax():
    """Two rows of the toy model: the division tree (1 + 2 + 4 cells), and
    apoptosis at t = 1.25 before division at 2 (one cell, dead)."""
    jcfg = _config()
    cfg = population_config_from_arrays({f.name: getattr(jcfg, f.name)
                                         for f in dataclasses.fields(jcfg)})
    assert cfg == PopulationConfig(**dataclasses.asdict(jcfg))
    N, G = cfg.capacity, 200
    params = np.stack([np.tile([0.1, 0.5, r_apo], (N, 1)) for r_apo in (0.0, 0.8)])
    init = np.tile([1.0, 0.0, 1.0, 0.0], (2, N, 1))
    grid = np.linspace(0.0, 4.5, G)

    def jrun(p):
        return jsim.simulate_population(jcfg, _rhs, jnp.asarray(init[0]), jnp.zeros((N, 0)), p,
                                        p, jnp.zeros((N,)), jnp.asarray(grid))

    jres = jax.jit(jax.vmap(jrun))(jnp.asarray(params))
    p = torch.as_tensor(params)
    res = simulate_population(cfg, _toy_rhs, torch.as_tensor(init), torch.zeros(2, N, 0, dtype=F64),
                              p, p, torch.zeros(2, N, dtype=F64), torch.as_tensor(grid))
    _compare("toy", res, jres, max_flip_share=0)
    assert res.active[0].sum() == 7 and bool(res.divided[0, 0])
    assert res.active[1].sum() == 1 and bool(res.died[1, 0])


def test_population_config_from_arrays_carries_the_sparse_solver(tmp_path):
    """The JAX package's configuration of the stiff cellpop experiment,
    its SparseStageSolver included, carries across field for field."""
    path, data = chip_smoke.cellpop_files(str(tmp_path), "cellpop", 4, 2)
    with h5py.File(tmp_path / "data.nc", "w") as f:
        g = f.create_group("exp1")
        for k, v in data.items():
            g.create_dataset(k, data=v)
    lik, jlik = _both(path, chip_smoke.CELLPOP_NAMES)
    jcfg = jlik.model.experiments[0].pop_config
    cfg = population_config_from_arrays({f.name: getattr(jcfg, f.name)
                                         for f in dataclasses.fields(jcfg)})
    port = lik.model.experiments[0].pop_config
    for f in dataclasses.fields(cfg):
        if f.name != "sparse":
            assert getattr(cfg, f.name) == getattr(port, f.name), f.name
    for attr in ("perm", "lu_pattern", "seeds", "jac_pattern"):
        np.testing.assert_array_equal(getattr(cfg.sparse, attr), getattr(port.sparse, attr))


def test_species_value_at_and_interp_grid_match_jax():
    """One species of three cells read at experiment times: NaN outside
    each cell's [0, end] window, synchronized or not."""
    from bcm3_tpu_torch.cellpop.simulate import interp_grid, species_value_at

    rng = np.random.default_rng(7)
    grid = np.linspace(0.0, 5.0, 40)
    col = rng.normal(size=(3, 40))
    creation, end = np.array([0.0, 1.0, 2.5]), np.array([5.0, 3.0, 1.0])
    times = np.array([0.5, 1.5, 3.0, 4.2])
    for sync in (None, np.array([0.3, 0.0, 1.2])):
        got = species_value_at(torch.as_tensor(grid), torch.as_tensor(col),
                               torch.as_tensor(times)[None], torch.as_tensor(creation)[:, None],
                               torch.as_tensor(end)[:, None],
                               None if sync is None else torch.as_tensor(sync)[:, None])
        for c in range(3):
            ref = [jsim.species_value_at(None, jnp.asarray(grid), jnp.asarray(col[c]), c, t,
                                         creation[c], end[c], None if sync is None else sync[c])
                   for t in times]
            np.testing.assert_allclose(got[c].numpy(), np.asarray(ref), rtol=1e-15)
    np.testing.assert_allclose(
        interp_grid(torch.as_tensor(grid), torch.as_tensor(col), torch.as_tensor(times)).numpy(),
        np.stack([[jsim.interp_grid(jnp.asarray(grid), jnp.asarray(col[c]), t) for t in times]
                  for c in range(3)]), rtol=1e-15)
