"""The port's R bridge (bcm3_tpu_torch/rbridge.py) against the JAX package's
(bcm3_tpu/rbridge.py), accessor family by accessor family, on the same
fixture files, the port with device="cpu": the handle lifecycle, PopPK,
single-patient PK, pharmaco single and population, the ODE template,
incucyte, fISA (single-condition and incucyte-sequential) and cellpop.
Values in float64 within 1e-10 relative (the JAX bridge evaluates its
models eagerly). The cellpop accessors are held to the port's own
cell_population model, which tests/test_torch_cellpop.py holds to the JAX
package's (the JAX simulator's compile would cost this file half a
minute).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from bcm3_tpu import rbridge as jax_rbridge
from bcm3_tpu_torch import rbridge
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    truth_to_values,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)

RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=1e-12)


def _same_dicts(a, b, rtol=RTOL):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], (bool, np.bool_)):
            assert bool(a[k]) == bool(b[k]), k
        else:
            assert np.shape(a[k]) == np.shape(b[k]), k
            _close(a[k], b[k], rtol)


class Both:
    """One fixture folder opened by both bridges."""

    def __init__(self, folder, **options):
        self.h = rbridge.init(folder, device="cpu", **options)
        self.jh = jax_rbridge.init(folder)

    def call(self, name, *args, rtol=RTOL):
        got = getattr(rbridge, name)(self.h, *args)
        ref = getattr(jax_rbridge, name)(self.jh, *args)
        if isinstance(got, dict):
            _same_dicts(got, ref, rtol)
        elif isinstance(got, (list, tuple)) and got and isinstance(got[0], str):
            assert got == ref
        elif isinstance(got, tuple):
            for a, b in zip(got, ref):
                _close(a, b, rtol)
        else:
            assert np.shape(got) == np.shape(ref), name
            _close(got, ref, rtol)
        return got

    def close(self):
        rbridge.cleanup(self.h)
        jax_rbridge.cleanup(self.jh)


@pytest.fixture(scope="module")
def poppk_folder(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rbridge_poppk"))
    trial, truth = synthesize_trial(num_patients=4, num_timepoints=12, seed=3)
    trial.save(os.path.join(d, "pkdata.nc"), "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), 4, "one")
    write_poppk_likelihood_xml(os.path.join(d, "likelihood.xml"),
                               os.path.join(d, "pkdata.nc"), "TRIAL1", "lapatinib", "one")
    return d, truth


def test_init_device_and_cleanup(poppk_folder):
    """init runs on the card unless asked for the CPU, and raises without
    one; options without a leading "_" are refused; cleanup drops the
    handle."""
    poppk_folder, _ = poppk_folder
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rbridge.init(poppk_folder)
    with pytest.raises(TypeError, match="unexpected"):
        rbridge.init(poppk_folder, device="cpu", data={})
    h = rbridge.init(poppk_folder, device="cpu")
    assert rbridge.get_variable_names(h)
    rbridge.cleanup(h)
    with pytest.raises(KeyError):
        rbridge.get_log_likelihood(h, np.zeros(3))


def test_poppk_family(poppk_folder):
    d, truth = poppk_folder
    b = Both(d)
    try:
        b.call("get_variable_names")
        vals = np.asarray(truth_to_values(truth, rbridge._get(b.h)["varset"], "one"))
        for fn in ("get_log_likelihood", "get_log_prior", "popPK_get_simulated_data",
                   "popPK_get_simulated_trajectories"):
            b.call(fn, vals)
        b.call("popPK_get_observed_data")
        assert np.isfinite(rbridge.get_log_prior(b.h, vals))
    finally:
        b.close()


def _write_prior(path, spec):
    """Uniform priors wide around each (name, logspace, value)."""
    chip_smoke.write_uniform_prior(path, [(n, ls, v - 2.0 - abs(v), v + 2.0 + abs(v))
                                          for n, ls, v in spec])


def test_pk_single_family(tmp_path):
    from test_torch_pk_single import _LAYOUT, PATIENT

    d = str(tmp_path)
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=12, seed=7)
    trial.save(os.path.join(d, "pkdata.nc"), "T1", "lapatinib")
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write('<bcm_likelihood type="pharmacokinetic_trajectory">\n'
                f'  <pk_model drug="lapatinib" type="one" trial="T1" patient="{PATIENT}" '
                f'pkdata_file="{d}/pkdata.nc"/>\n</bcm_likelihood>\n')
    _write_prior(os.path.join(d, "prior.xml"), _LAYOUT["one"])
    b = Both(d)
    try:
        vals = np.array([v for _, _, v in _LAYOUT["one"]])
        b.call("get_log_likelihood", vals)
        b.call("PK_get_simulated_trajectories", vals)
    finally:
        b.close()


@pytest.mark.parametrize("kind", ["pharmaco_single", "pharmaco_population"])
def test_pharmaco_families(tmp_path, kind):
    from test_torch_pharmaco import _BENCH, _SINGLE, _trial

    d = str(tmp_path)
    _trial().save(os.path.join(d, "pkdata.nc"), "T1", "lapatinib")
    patient = ' patient="2"' if kind == "pharmaco_single" else ""
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write(f'<bcm_likelihood type="{kind}">\n  <pk_model drug="lapatinib" trial="T1" '
                f'pkdata_file="{d}/pkdata.nc"{patient}/>\n</bcm_likelihood>\n')
    spec = _SINGLE if kind == "pharmaco_single" else _BENCH
    _write_prior(os.path.join(d, "prior.xml"), spec)
    vals = np.array([v for _, _, v in spec])
    tps = np.linspace(1.0, 80.0, 15)
    b = Both(d)
    try:
        b.call("get_log_likelihood", vals)
        if kind == "pharmaco_single":
            b.call("pharmaco_get_simulation", vals)
            b.call("pharmacosingle_get_observed_data")
            b.call("pharmacosingle_get_simulated_data", vals)
            b.call("pharmacosingle_get_simulated_trajectory", vals, tps)
        else:
            assert b.call("pharmacopop_get_num_patients") > 1
            b.call("pharmacopop_get_observed_data", 1)
            b.call("pharmacopop_get_simulated_data", vals, 1)
            b.call("pharmacopop_get_simulated_trajectory", vals, 1, tps)
    finally:
        b.close()


def test_ode_family(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write('<bcm_likelihood type="ODE"/>\n')
    spec = [(f"p{i}", False, 0.1) for i in range(9)] + [
        ("p9", False, 300.0), ("p10", False, 10.0), ("p11", False, 10.0), ("p12", False, 10.0)]
    _write_prior(os.path.join(d, "prior.xml"), spec)
    b = Both(d)
    try:
        vals = np.array([v for _, _, v in spec])
        b.call("get_log_likelihood", vals, rtol=1e-8)
        traj = b.call("ODE_get_simulated_trajectories", vals, rtol=1e-8)
        assert traj.shape == (4, 100)
    finally:
        b.close()


def _register(bridge, model):
    handle = f"test_{id(model)}"
    bridge._handles[handle] = {"likelihood": model, "varset": None, "prior": None,
                               "base_folder": ""}
    return handle


def test_incucyte_family():
    """Hand-registered models (the JAX test's own construction, and
    chip_smoke's copy of it for the port)."""
    from test_cellmisc import _incucyte_setup

    from bcm3_tpu_torch import VariableSet
    from bcm3_tpu_torch.likelihoods.cellmisc import IncucytePopulationLikelihood

    jm, jvalues = _incucyte_setup()
    e, spec = chip_smoke.incucyte_setup()
    vs = VariableSet()
    for name, _ in spec:
        vs.add_variable(name)
    assert vs.names == list(jm.varset.names)
    values = np.array([v for _, v in spec])
    np.testing.assert_array_equal(values, np.asarray(jvalues))
    m = IncucytePopulationLikelihood(vs, [e], grid_points=jm.grid_points, ring_size=jm.ring_size,
                                     solver=jm.solver)
    h, jh = _register(rbridge, m), _register(jax_rbridge, jm)
    try:
        got = rbridge.incucyte_get_simulated_trajectories(h, values, 0)
        _same_dicts(got, jax_rbridge.incucyte_get_simulated_trajectories(jh, values, 0))
        _close(rbridge.incucyte_get_simulated_ctb(h, values, 0),
               jax_rbridge.incucyte_get_simulated_ctb(jh, values, 0))
    finally:
        rbridge.cleanup(h)
        jax_rbridge.cleanup(jh)


def _chain_folder(root):
    """tests/test_fisa.py's MODEL and end-to-end experiment: EGFR -> ERK ->
    proliferation with a drug inhibiting ERK's activity, 3 cell lines;
    returns the folder, its data group and values."""
    from test_torch_fisa import _write_h5

    d = os.path.join(root, "chain")
    os.makedirs(d)
    with open(os.path.join(d, "net.xml"), "w") as f:
        f.write(chip_smoke.fisa_sbml(
            [chip_smoke.fisa_species("s1", "EGFR", "PROTEIN"),
             chip_smoke.fisa_species("s2", "ERK", "PROTEIN"),
             chip_smoke.fisa_species("s3", "proliferation", "PHENOTYPE"),
             chip_smoke.fisa_species("s4", "drugX", "DRUG", "inhibit activity")],
            [chip_smoke.fisa_reaction("r1", "s1", "s2"), chip_smoke.fisa_reaction("r2", "s2", "s3"),
             chip_smoke.fisa_reaction("r3", "s4", "s2", positive=False)]))
    egfr = np.array([0.5, 0.7, 0.9])
    data = {"exp1": {"cell_lines": np.array([b"c1", b"c2", b"c3"]), "egfr_levels": egfr,
                     "prolif_data": (0.8 * 0.9 * egfr)[None, :]}}
    _write_h5(os.path.join(d, "data.nc"), data)
    with open(os.path.join(d, "likelihood.xml"), "w") as f:
        f.write('<bcm_likelihood type="fISA">\n'
                '<experiment name="exp1" model_file="net.xml" data_file="data.nc">\n'
                '  <condition species_name="EGFR" data_name="egfr_levels"/>\n'
                '  <data species_name="proliferation" data_name="prolif_data"\n'
                '    likelihood_function="normal" use_base="false" use_scale="false"\n'
                '    scale_var_with_mean="false" sd="0.05"/>\n'
                "</experiment>\n</bcm_likelihood>\n")
    spec = [("base_EGFR", False, 0.7), ("strength_EGFR_ERK", False, 0.9),
            ("strength_ERK_proliferation", False, 0.8), ("maxinhib_drugX_ERK", False, 0.0)]
    _write_prior(os.path.join(d, "prior.xml"), spec)
    return d, data, np.array([v for _, _, v in spec])


def _incucyte_folder(root):
    """chip_smoke.py's incucyte-sequential experiment relative to a
    single-condition one, with its prior and HDF5 data."""
    from test_torch_fisa import _write_h5

    d = os.path.join(root, "incucyte")
    _, data = chip_smoke.fisa_files(d, "incucyte", relative=True)
    _write_h5(os.path.join(d, "idata.nc"), data)
    _write_prior(os.path.join(d, "prior.xml"), chip_smoke.FISA_VARIABLES["incucyte"])
    return d, data, np.array([v for _, _, v in chip_smoke.FISA_VARIABLES["incucyte"]])


@pytest.mark.parametrize("name", ["chain", "incucyte_relative"])
def test_fisa_family(tmp_path, name):
    """Every fISA accessor (on the first and the last data part; the data
    parts themselves are held to the JAX package in tests/test_torch_fisa.py);
    the port's handle also from `_data` alone."""
    folder = _chain_folder if name == "chain" else _incucyte_folder
    d, data, vals = folder(str(tmp_path))
    vals = vals + 0.01
    b = Both(d)
    mem = rbridge.init(d, device="cpu", _data=data)
    try:
        assert b.call("fISA_get_num_experiments") == len(rbridge._model(b.h).experiments)
        b.call("get_log_likelihood", vals)
        assert rbridge.get_log_likelihood(mem, vals) == rbridge.get_log_likelihood(b.h, vals)
        for ex in range(rbridge.fISA_get_num_experiments(b.h)):
            b.call("fISA_get_num_cell_lines", ex)
            b.call("fISA_get_cell_line_names", ex)
            exp = rbridge._model(b.h).experiments[ex]
            if hasattr(exp, "drug_concentrations"):
                nd = 2 * len(exp.drug_concentrations)
            else:
                nd = b.call("fISA_get_num_data", ex)
            b.call("fISA_get_modeled_activities", ex, vals)
            for k in sorted({0, nd - 1}) if nd else []:
                b.call("fISA_get_observed_data", ex, k)
                b.call("fISA_get_modeled_data", ex, k, vals)
    finally:
        b.close()
        rbridge.cleanup(mem)


def test_cellpop_family(tmp_path):
    """The cellpop accessors on tests/test_rbridge.py's dividing-cell
    fixture against the port's cell_population model."""
    import test_rbridge

    from bcm3_tpu_torch.likelihoods import create_likelihood
    from bcm3_tpu_torch.model.variables import VariableSet

    d, times = test_rbridge.cellpop_folder.__wrapped__()
    h = rbridge.init(d, device="cpu")
    vals = np.array([0.1, 0.25, 0.05])
    try:
        lik = create_likelihood(os.path.join(d, "likelihood.xml"),
                                VariableSet.from_xml(os.path.join(d, "prior.xml")))
        m = lik.model
        x = torch.as_tensor(vals)
        assert rbridge.cellpop_get_num_species(h) == m.get_experiment().num_species == 2
        assert rbridge.cellpop_get_species_names(h) == ["mass", "cytokinesis"]
        assert rbridge.cellpop_get_num_data(h) == 2
        assert rbridge.get_log_likelihood(h, vals) == float(lik.log_prob_batched(x[None])[0])
        traj = rbridge.cellpop_get_simulated_trajectories(h, vals, n_timepoints=60)
        t, v, parents = m.simulated_trajectories(x, n_timepoints=60)
        _close(traj["time"], t)
        np.testing.assert_array_equal(traj["values"], v)
        np.testing.assert_array_equal(traj["parents"], parents)
        assert traj["values"].shape == (3, 60, 2) and traj["parents"][0] == -1
        obs = rbridge.cellpop_get_observed_data(h, 0)
        _close(obs["time"], times)
        for k in (0, 1):
            sim = rbridge.cellpop_get_simulated_data(h, vals, k)
            t, v = m.simulated_data(x, k)
            _close(sim["time"], t)
            np.testing.assert_array_equal(sim["values"], v)
        matched = rbridge.cellpop_get_matched_simulation(h, vals, 1, n_timepoints=60)
        t, v = m.matched_simulation(x, 1, n_timepoints=60)
        np.testing.assert_array_equal(matched["values"], v)
        assert matched["values"].shape == (2, 60, 2)
    finally:
        rbridge.cleanup(h)
