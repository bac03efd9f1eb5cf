"""The port's CLI against the JAX package's, file for file.

`bcm3_tpu.cli.main` and `bcm3_tpu_torch.cli.main --device cpu --dtype
float64` run on the same synthesized PopPK trial (4 patients x 6
timepoints), each mode once per module:

- run (clustered proposals, one boundary, both dumps on): output.nc has
  the JAX CLI's groups, datasets, shapes, dtypes, fill values, variable
  names, transforms and temperatures; every stored row's log-prior and
  log-likelihood are the JAX package's prior and likelihood at its values
  to 1e-10; the file loads through the JAX package's R-side loader; the
  adaptation and clustering dumps have the JAX CLI's names and shapes;
- --predict: both CLIs read the JAX CLI's output.nc and write equal
  prediction.nc, to 1e-10, with the same fill pattern;
- --bcmopt (one stored sample at each of 2 temperatures, with a prior
  that leaves one stored variable fixed): equal TSV headers and row
  counts; the port's TSVs are its bcmopt core's rows, and each row's MAP
  log posterior is the JAX package's prior plus likelihood at its values
  to 1e-10.
"""

import os
import sys
import xml.etree.ElementTree as ET

import h5py
import jax
import numpy as np
import pytest
import torch

from bcm3_tpu import cli as jax_cli
from bcm3_tpu.io.bundler import load_bundle as jax_load_bundle
from bcm3_tpu.io.hdf5r_compat import bcm3_load_results
from bcm3_tpu.likelihoods import create_likelihood as jax_create_likelihood
from bcm3_tpu.model.prior import Prior as JPrior
from bcm3_tpu.model.variables import VariableSet as JVariableSet
from bcm3_tpu_torch import cli
from bcm3_tpu_torch.io.bundler import load_bundle
from bcm3_tpu_torch.io.config import load_options
from bcm3_tpu_torch.io.output import load_results
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)

FIXED = "mean_excretion"  # the stored variable that --bcmopt's prior leaves out

CONFIG = """[sampler]
num_samples=20
use_every_nth=1
rngseed=77

[ptmhsampler]
num_chains=2
num_ensembles=16
proposal_type=clustered_covariance
adapt_proposal_samples=10
adapt_proposal_times=1
adapt_proposal_max_clustering_samples=40
output_proposal_adaptation=true
output_sample_clustering=true

[bcmopt]
num_samples=1
"""

PORT = ["--device", "cpu", "--dtype", "float64"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    P = 4
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=6, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), P, "one")
    write_poppk_likelihood_xml(os.path.join(d, "likelihood.xml"), pk, "TRIAL1", "lapatinib", "one")
    tree = ET.parse(os.path.join(d, "prior.xml"))
    root = tree.getroot()
    root.remove(next(v for v in root if v.get("name") == FIXED))
    tree.write(os.path.join(d, "prior_bcmopt.xml"))
    cfg = os.path.join(d, "config.txt")
    with open(cfg, "w") as f:
        f.write(CONFIG)

    def argv(folder, *extra, prior="prior.xml"):
        return ["-c", cfg, "--prior", os.path.join(d, prior),
                "--likelihood", os.path.join(d, "likelihood.xml"),
                "--output.folder", os.path.join(d, folder), *extra]

    jax_out = os.path.join(d, "jax_out", "output.nc")
    assert jax_cli.main(argv("jax_out")) == 0
    assert cli.main(argv("port_out", *PORT)) == 0
    assert jax_cli.main(argv("jax_out", "--predict")) == 0
    assert cli.main(argv("jax_out", "--predict", "--predict.output", "prediction_port.nc",
                         *PORT)) == 0
    # --bcmopt's samplers run 5 samples each, short of the first boundary
    for name, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, PORT)):
        assert main(argv(f"{name}_bcmopt", "--bcmopt", "--bcmopt.input", jax_out,
                         "--sampler.num_samples", "5", *extra, prior="prior_bcmopt.xml")) == 0
    return d, argv


def _layout(path):
    """{dataset path: (shape, dtype, fill value)} of an HDF5 file."""
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.shape, obj.dtype.kind if obj.dtype.kind in "OSU" else obj.dtype,
                         obj.fillvalue if obj.dtype.kind == "f" else None)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def _jax_model(d, prior="prior.xml", stored=None):
    """The JAX package's prior from `prior` and vmapped likelihood, over
    the prior's variables or over a stored file's (`stored`)."""
    vs = JVariableSet.from_xml(os.path.join(d, prior))
    prior_j = JPrior.from_xml(os.path.join(d, prior), vs)
    if stored is not None:
        vs = JVariableSet(names=list(stored["variables"]),
                          transforms=[int(t) for t in stored["variable_transform"]])
    lik = jax_create_likelihood(os.path.join(d, "likelihood.xml"), vs)
    return prior_j, jax.jit(jax.vmap(lik.log_prob))


def test_output_has_the_jax_layout(runs):
    d, _ = runs
    jpath, ppath = (os.path.join(d, f"{n}_out", "output.nc") for n in ("jax", "port"))
    assert _layout(ppath) == _layout(jpath)
    jres, pres = load_results(jpath), load_results(ppath)
    assert pres["variables"] == jres["variables"]
    np.testing.assert_array_equal(pres["variable_transform"], jres["variable_transform"])
    np.testing.assert_array_equal(pres["temperatures"], jres["temperatures"])
    assert pres["samples"].shape == (20 * 16, 2, len(pres["variables"]))
    # every row written: no fill value is left
    assert np.isfinite(pres["samples"]).all() and np.isfinite(pres["log_prior"]).all()


def test_stored_rows_match_jax_densities(runs):
    d, _ = runs
    res = load_results(os.path.join(d, "port_out", "output.nc"))
    prior, log_prob = _jax_model(d)
    S, C, D = res["samples"].shape
    rows = res["samples"].reshape(S * C, D)
    np.testing.assert_allclose(
        np.asarray(prior.log_pdf(rows)), res["log_prior"].reshape(-1), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(log_prob(rows)), res["log_likelihood"].reshape(-1), rtol=1e-10
    )


def test_output_loads_through_the_r_side_loader(runs):
    d, _ = runs
    model = bcm3_load_results(d, "port_out")
    post = model["posterior"]
    assert post["samples"].shape == (16, 2, 20 * 16)  # [var, temp, sample]
    assert np.isfinite(post["lposterior"]).all()
    assert set(model["sampler_adaptation"]) == {"adapt0", "adapt1"}


@pytest.mark.parametrize("dump", ["sampler_adaptation.nc", "sample_history_clustering.nc"])
def test_dumps_have_the_jax_names_and_shapes(runs, dump):
    d, _ = runs
    jlay = _layout(os.path.join(d, "jax_out", dump))
    play = _layout(os.path.join(d, "port_out", dump))
    assert {k: v[0] for k, v in play.items()} == {k: v[0] for k, v in jlay.items()}
    assert len(play) >= 5

    # and the port's bundle reader reads it as the JAX package's does
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else v.shape for k, v in tree.items()}

    path = os.path.join(d, "port_out", dump)
    assert shapes(load_bundle(path)) == shapes(jax_load_bundle(path))


def test_predict_matches_jax(runs):
    d, _ = runs
    preds = []
    for name in ("prediction.nc", "prediction_port.nc"):
        with h5py.File(os.path.join(d, "jax_out", name), "r") as f:
            preds.append((f["predictions/log_likelihood"][:], f["predictions/temperature"][:]))
    (jp, jt), (pp, pt) = preds
    np.testing.assert_array_equal(pt, jt)
    fill = jp == 9.9692099683868690e36
    np.testing.assert_array_equal(pp == 9.9692099683868690e36, fill)
    assert fill[:160].all() and not fill[160:].any()  # the second half is evaluated
    np.testing.assert_allclose(pp[~fill], jp[~fill], rtol=1e-10)


def test_bcmopt_tables(runs):
    d, argv = runs
    tables = {}
    for name in ("jax", "port"):
        tables[name] = [
            open(os.path.join(d, f"{name}_bcmopt", f)).read().splitlines()
            for f in ("MAP_estimates.tsv", "MAP_estimates_paramvalues.tsv")
        ]
    for jt, pt in zip(tables["jax"], tables["port"]):
        assert pt[0] == jt[0] and len(pt) == len(jt)
    assert len(tables["port"][1]) == 1 + 2  # a header, then 2 temperatures x 1 sample
    assert f"fixed_{FIXED}" in tables["port"][1][0]

    # the port's TSVs are its core's rows, formatted: rerun the core
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood

    opts = load_options(os.path.join(d, "config.txt"), {
        "sampler.num_samples": "5", "device": "cpu", "dtype": "float64"})
    stored = load_results(os.path.join(d, "jax_out", "output.nc"))
    vs = VariableSet.from_xml(os.path.join(d, "prior_bcmopt.xml"))
    full = create_likelihood(
        os.path.join(d, "likelihood.xml"),
        VariableSet(names=stored["variables"], transforms=list(stored["variable_transform"])),
    )
    result = cli.bcmopt_core(opts, Prior.from_xml(os.path.join(d, "prior_bcmopt.xml"), vs),
                             full, stored)
    out = os.path.join(d, "core")
    os.makedirs(out)
    for fn, lines in zip(cli.write_bcmopt_tables(out, result), tables["port"]):
        assert open(fn).read().splitlines() == lines

    # each row's MAP log posterior is the JAX prior + likelihood at its values
    prior, log_prob = _jax_model(d, "prior_bcmopt.xml", stored=stored)
    fixed_ix = stored["variables"].index(FIXED)
    for row in result["rows"]:
        x = row["map_sample"]
        full_x = np.insert(x, fixed_ix, row["fixed"][0])
        want = float(prior.log_pdf(x[None])[0]) + float(log_prob(full_x[None])[0])
        np.testing.assert_allclose(row["map_lposterior"], want, rtol=1e-10)


def test_run_needs_h5py(runs, monkeypatch):
    """Without h5py, run fails before it samples and writes no output; it
    never falls back to another format."""
    d, argv = runs
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        cli.main(argv("no_h5py", *PORT))
    assert not os.path.exists(os.path.join(d, "no_h5py"))


# the samplers beyond the reference, each at a few iterations on the banana
# fixture, and the rows each emits (the gradient samplers pool their chains)
_SAMPLER_CONFIGS = {
    "hmc": ("[hmcsampler]\nnum_chains=2\nnum_warmup=0\nnum_leapfrog_steps=1\n", 4 * 2),
    "nuts": ("[nutssampler]\nnum_chains=2\nnum_warmup=0\nmax_tree_depth=3\n", 4 * 2),
    "smc": ("[smcsampler]\nnum_particles=64\nmutation_steps=1\n", 64),
    "vi": ("[visampler]\nnum_iterations=5\nnum_mc_samples=4\n", 4),
}


@pytest.mark.parametrize("stype", sorted(_SAMPLER_CONFIGS))
def test_other_samplers_write_the_jax_layout(tmp_path, stype):
    """`run` with sampler.type hmc, nuts, smc or vi writes output.nc with
    the JAX CLI's layout for the same config.txt, every row finite and
    scored by the JAX package's prior and likelihood to 1e-10; --predict
    over the port's rows equals the stored log-likelihoods."""
    section, rows = _SAMPLER_CONFIGS[stype]
    d = str(tmp_path)
    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "examples", "banana")
    cfg = os.path.join(d, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"[sampler]\ntype={stype}\nnum_samples=4\nrngseed=3\n\n{section}")

    def argv(folder, *extra):
        return ["-c", cfg, "--prior", os.path.join(fixture, "prior.xml"),
                "--likelihood", os.path.join(fixture, "likelihood.xml"),
                "--output.folder", os.path.join(d, folder), *extra]

    assert jax_cli.main(argv("jax_out")) == 0
    assert cli.main(argv("port_out", *PORT)) == 0
    jpath, ppath = (os.path.join(d, f"{n}_out", "output.nc") for n in ("jax", "port"))
    assert _layout(ppath) == _layout(jpath)
    res = load_results(ppath)
    assert res["samples"].shape == (rows, 1, 2)
    assert np.isfinite(res["samples"]).all() and np.isfinite(res["log_likelihood"]).all()
    vs = JVariableSet.from_xml(os.path.join(fixture, "prior.xml"))
    jprior = JPrior.from_xml(os.path.join(fixture, "prior.xml"), vs)
    jlik = jax_create_likelihood(os.path.join(fixture, "likelihood.xml"), vs)
    x = res["samples"][:, 0, :]
    np.testing.assert_allclose(res["log_prior"][:, 0], np.asarray(jprior.log_pdf(x)), rtol=1e-10)
    np.testing.assert_allclose(res["log_likelihood"][:, 0],
                               np.asarray(jax.vmap(jlik.log_prob)(x)), rtol=1e-10)
    assert cli.main(argv("port_out", "--predict", *PORT)) == 0
    with h5py.File(os.path.join(d, "port_out", "prediction.nc"), "r") as f:
        pred = f["predictions/log_likelihood"][:]
    half = np.arange(rows // 2, rows)
    np.testing.assert_allclose(pred[half, 0], res["log_likelihood"][half, 0], rtol=1e-10)


@pytest.mark.parametrize("stype", ["hmc", "nuts", "vi"])
def test_gradient_samplers_take_a_transit_model(tmp_path, stype):
    """`run` with sampler.type hmc, nuts or vi on a transit PopPK model
    (the gradient mode, B2J's plain version here) writes output.nc, and its
    stored log-likelihoods are the model's own (the gradient mode's values
    are the eager solve's bit for bit). A budget of 128 trips (these
    trajectories take tens) keeps the CPU's solves short."""
    from bcm3_tpu_torch import VariableSet as PVariableSet
    from bcm3_tpu_torch import create_likelihood

    d = str(tmp_path)
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=6, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, 4, "two_transit")
    write_poppk_likelihood_xml(lik_xml, pk, "TRIAL1", "lapatinib", "two_transit")
    tree = ET.parse(lik_xml)
    tree.getroot().find("pk_model").set("solver_trips", "128")
    tree.write(lik_xml)
    section, rows = {
        "hmc": ("[hmcsampler]\nnum_chains=2\nnum_warmup=0\nnum_leapfrog_steps=1\n", 4),
        "nuts": ("[nutssampler]\nnum_chains=2\nnum_warmup=0\nmax_tree_depth=2\n", 4),
        "vi": ("[visampler]\nnum_iterations=2\nnum_mc_samples=4\n", 2),
    }[stype]
    cfg = os.path.join(d, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"[sampler]\ntype={stype}\nnum_samples=2\nrngseed=3\n\n{section}")
    out = os.path.join(d, "out")
    assert cli.main(["-c", cfg, "--prior", prior_xml, "--likelihood", lik_xml,
                     "--output.folder", out, *PORT]) == 0
    res = load_results(os.path.join(out, "output.nc"))
    vs = PVariableSet.from_xml(prior_xml)
    assert res["samples"].shape == (rows, 1, vs.num_variables)
    lik = create_likelihood(lik_xml, vs)
    x = torch.as_tensor(res["samples"][:, 0, :])
    np.testing.assert_array_equal(res["log_likelihood"][:, 0], lik.log_prob_batched(x).numpy())
