"""The port's cell likelihoods (`cell_cycle_marker`,
`mitosis_time_estimation`, `incucyte_population`,
bcm3_tpu_torch/likelihoods/cellmisc.py) against the JAX package's.

Both packages build each likelihood through their `create_likelihood` from
the same likelihood.xml and data file (a TSV track, or an HDF5 file
written here with h5py), so the loaders are held too. The rows are the
model's values with jitter, plus rows that must score -inf; the JAX side
is `jax.jit(log_prob)` row by row.

- `cell_cycle_marker`: a 220-point track with NaN entries
  (tests/test_cellmisc.py:41-79), 64 rows.
- `mitosis_time_estimation`: 8 cells x 30 timepoints of boxcars from the
  model's own Sobol construction (tests/test_cellmisc.py:82-103), 32 rows,
  matched on the host.
- `incucyte_population`: two experiments of 3 concentrations x 4
  replicates around `_incucyte_setup`'s values (tests/test_cellmisc.py
  :106-178), 16 rows, at G = 32: the ring solver with the pao control
  scored and not, and the fixed solver; the budget and adaptive solvers on
  the second experiment alone (their eager steps are most of this file's
  time), the adaptive one at 32 substeps an interval (at 8 every lane
  exhausts its trips at this grid, in both packages);
  `simulate_experiment`'s observables.

Tolerances, float64: rtol 1e-10 (1e-8 for the adaptive solvers) with equal
-inf sets; float32 rows against the JAX package's float32, rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cellmisc import _incucyte_setup

from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch.convert import incucyte_experiment_from_arrays
from bcm3_tpu_torch.likelihoods import create_likelihood
from bcm3_tpu_torch.likelihoods.cellmisc import IncucytePopulationLikelihood
from bcm3_tpu_torch.model.variables import VariableSet


def _varsets(names):
    vs, jvs = VariableSet(), JVariableSet()
    for n in names:
        vs.add_variable(n)
        jvs.add_variable(n)
    return vs, jvs


def _both(tmp_path, ltype, names, **attrs):
    """The port's and the JAX package's likelihood from one likelihood.xml."""
    xml = tmp_path / f"{ltype}.xml"
    fields = " ".join(f'{k}="{v}"' for k, v in attrs.items())
    xml.write_text(f'<bcm_likelihood type="{ltype}" {fields}/>\n')
    vs, jvs = _varsets(names)
    return create_likelihood(str(xml), vs), jax_create_likelihood(str(xml), jvs)


def _jax_rows(fn, xs):
    f = jax.jit(fn)
    return np.array([f(jnp.asarray(x)) for x in xs])


def _assert_rows(got, ref, rtol):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol)


def _float32(lik, jlik, xs):
    """The port's float32 rows against the JAX package's float32."""
    got = lik.log_prob_batched(torch.as_tensor(xs, dtype=torch.float32))
    assert got.dtype == torch.float32
    with jax.enable_x64(False):
        ref = _jax_rows(jlik.log_prob, xs.astype(np.float32))
    _assert_rows(got.numpy(), ref, 1e-4)


# ---------------------------------------------------------------------------
# cell_cycle_marker

CCM_NAMES = ("S_entry_time", "S_duration", "plateau_duration", "base_signal",
             "S_signal_increase", "plateau_signal_increase", "mitosis_signal_fraction",
             "mitosis_signal_decrease", "additive_noise", "proportional_noise")
CCM_TRUTH = np.array([30.0, 60.0, 40.0, 6.0, 0.8, 0.3, 0.5, 0.4, 1.0, 0.02])


def _ccm_track(n=220, seed=0):
    """tests/test_cellmisc.py:41-79's track: the model's own piecewise
    form at CCM_TRUTH with t(4) noise."""
    truth = CCM_TRUTH
    i = np.arange(n, dtype=float)
    s_entry, s_dur, plat_dur = truth[:3]
    plateau_t, mitosis_t = s_entry + s_dur, s_entry + s_dur + plat_dur
    x = np.full_like(i, truth[3])
    sel = (i > s_entry) & (i <= plateau_t)
    x[sel] = truth[3] + truth[4] * (i[sel] - s_entry)
    sel = (i > plateau_t) & (i <= mitosis_t)
    x[sel] = truth[3] + s_dur * truth[4] + (i[sel] - plateau_t) * truth[5]
    sel = i > mitosis_t
    x[sel] = (truth[3] + (s_dur * truth[4] + plat_dur * truth[5]) * truth[6]
              - truth[7] * (i[sel] - mitosis_t))
    rng = np.random.default_rng(seed)
    return x + rng.standard_t(4, size=n) * (1.0 + 0.02 * np.maximum(x, 0))


def test_cell_cycle_marker_matches_jax(tmp_path):
    data = _ccm_track()
    fn = tmp_path / "track.tsv"
    cells = ["nan" if k in (5, 77, 150) else f"{v:.6f}" for k, v in enumerate(data)]
    fn.write_text("\t".join(["id"] + [str(k) for k in range(len(data))]) + "\n"
                  + "\t".join(["track0"] + cells) + "\n")
    lik, jlik = _both(tmp_path, "cell_cycle_marker", CCM_NAMES, data_file=fn)
    assert np.isnan(lik.model.data).sum() == 3
    rng = np.random.default_rng(1)
    xs = CCM_TRUTH * (1.0 + 0.1 * rng.normal(size=(64, 10)))
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    _assert_rows(got, _jax_rows(jlik.log_prob, xs), 1e-10)
    assert np.isfinite(got).all()
    _float32(lik, jlik, xs)


# ---------------------------------------------------------------------------
# mitosis_time_estimation

MITOSIS_NAMES = ("mitosis_times_stdev", "entry_time_stdev", "trajectory_noise_stdev")


def test_mitosis_time_estimation_matches_jax(tmp_path):
    import h5py

    from bcm3_tpu_torch.likelihoods.cellmisc import MitosisTimeEstimationLikelihood

    tp = np.linspace(0, 10, 30)
    vs, _ = _varsets(MITOSIS_NAMES)
    sob = MitosisTimeEstimationLikelihood(vs, tp, np.zeros((30, 8))).sobol_values
    obs = ((tp[None, :] >= 1.5 * sob[:, 1:2])
           & (tp[None, :] < (1.5 * sob[:, 1:2] + 3.0 * sob[:, :1]))).astype(float).T
    fn = tmp_path / "trajectories.nc"
    with h5py.File(fn, "w") as f:
        f["simulation/time"] = tp
        f["simulation/trajectories"] = obs
    lik, jlik = _both(tmp_path, "mitosis_time_estimation", MITOSIS_NAMES, data_file=fn)
    np.testing.assert_array_equal(lik.model.sobol_values, sob)
    rng = np.random.default_rng(2)
    truth = np.log10([3.0, 1.5, 0.2])
    xs = truth + 0.2 * rng.normal(size=(32, 3))
    xs[5] = np.nan  # NaN costs -> -inf
    xs[6, 2] = -400.0  # a zero noise sd: every pair impossible -> -inf
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref = _jax_rows(jlik.log_prob, xs)
    assert np.isneginf(got[[5, 6]]).all() and np.isfinite(got).sum() == 30
    _assert_rows(got, ref, 1e-10)
    _float32(lik, jlik, xs)


# ---------------------------------------------------------------------------
# incucyte_population

INCUCYTE_RTOL = {"ring": 1e-10, "fixed": 1e-10, "budget": 1e-8, "adaptive": 1e-8}


def _incucyte_data(path):
    """Two experiments of 3 concentrations x 4 replicates around
    _incucyte_setup's observations, with noise and NaN entries."""
    import h5py

    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        cell = f.create_group("drugx").create_group("cellA")
        for k, (T, tmax, treat, seeding) in enumerate([(20, 96.0, 24.0, 1000.0),
                                                        (16, 72.0, 12.0, 1500.0)]):
            g = cell.create_group(f"experiment{k + 1}")
            g["time"] = np.linspace(0.0, tmax, T)
            g["drug_concentrations"] = np.array([0.1, 1.0, 10.0])
            for name, level, shape in [
                ("drug_confluence", 10.0, (T, 3, 4)), ("drug_apoptosis_marker", 1.0, (T, 3, 4)),
                ("negative_control_confluence", 20.0, (T, 4)),
                ("negative_control_apoptosis_marker", 0.5, (T, 4)),
                ("positive_control_confluence", 5.0, (T, 4)),
                ("positive_control_apoptosis_marker", 3.0, (T, 4)),
            ]:
                a = level * (1.0 + 0.1 * rng.normal(size=shape))
                a.reshape(-1)[rng.choice(a.size, 3, replace=False)] = np.nan
                g[name] = a
            g["cell_titer_blue_norm"] = np.array([0.9, np.nan, 0.2]) if k else \
                np.array([0.9, 0.5, 0.2])
            g.attrs["treatment_time"] = treat
            g.attrs["seeding_density"] = seeding


def _incucyte_rows(names, values, B=16):
    rng = np.random.default_rng(6)
    xs = values[None, :] + 0.002 * rng.normal(size=(B, len(values)))
    xs[:, names.index("apoptosis_duration")] = rng.uniform(3.0, 12.0, B)
    xs[3, names.index("sigma_confluence")] = -1.0  # log of a negative sd -> -inf
    xs[4] = np.nan
    return xs


@pytest.fixture(scope="module")
def incucyte_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("incucyte")
    _incucyte_data(tmp / "drug_response.h5")
    jlik, values = _incucyte_setup()
    names = list(jlik.varset.names)
    ix = names.index("seeding_density_deviation_1") + 1
    names.insert(ix, "seeding_density_deviation_2")
    values = np.insert(values, ix, 0.05)
    return tmp, names, _incucyte_rows(names, values)


def _incucyte(tmp, names, solver, use_pao="true"):
    lik, jlik = _both(tmp, "incucyte_population", names, drug="drugx", cell_line="cellA",
                      data_file=tmp / "drug_response.h5", use_pao_control=use_pao)
    # set before the JAX package traces its log_prob
    for m in (lik.model, jlik.model):
        m.grid_points, m.solver, m.trips_per_interval = 32, solver, 32
        if solver in ("budget", "adaptive"):
            m.experiments = m.experiments[1:]
    return lik, jlik


@pytest.mark.parametrize("solver,use_pao", [("ring", "true"), ("ring", "false"),
                                            ("fixed", "true"), ("budget", "true"),
                                            ("adaptive", "true")])
def test_incucyte_matches_jax(incucyte_case, solver, use_pao):
    tmp, names, xs = incucyte_case
    lik, jlik = _incucyte(tmp, names, solver, use_pao)
    assert isinstance(lik.model, IncucytePopulationLikelihood)
    assert lik.model.use_pao_control == (use_pao == "true") == jlik.model.use_pao_control
    got = lik.log_prob_batched(torch.as_tensor(xs)).numpy()
    ref = _jax_rows(jlik.log_prob, xs)
    assert np.isneginf(got[[3, 4]]).all() and np.isfinite(got).sum() == len(xs) - 2
    _assert_rows(got, ref, INCUCYTE_RTOL[solver])


def test_incucyte_observables_and_float32(incucyte_case):
    """`simulate_experiment` of the second experiment (its CTB has a NaN)
    against the JAX package's, on the experiment carried across by
    `incucyte_experiment_from_arrays`; then float32."""
    tmp, names, xs = incucyte_case
    lik, jlik = _incucyte(tmp, names, "ring")
    model, jmodel = lik.model, jlik.model
    rows = xs[[0, 1, 2, 5]]
    for je in jmodel.experiments[1:]:
        e = incucyte_experiment_from_arrays(dataclasses.asdict(je))
        got = model.simulate_experiment(torch.as_tensor(rows), e)
        sim = jax.jit(lambda x: jmodel.simulate_experiment(x, je))
        refs = [sim(jnp.asarray(x)) for x in rows]
        assert got["ok"].all()
        for key in ("cell_count", "apoptotic_cell_count", "debris", "confluence",
                    "apoptosis_marker", "ctb"):
            ref = np.stack([np.asarray(r[key]) for r in refs])
            assert got[key].shape == ref.shape, key
            np.testing.assert_allclose(got[key].numpy(), ref, rtol=1e-10, atol=1e-300,
                                       err_msg=key)
    _float32(lik, jlik, xs)
