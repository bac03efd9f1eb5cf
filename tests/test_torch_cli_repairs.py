"""Two faults of the CLI, repaired in the port (CPU, float64, PopPK `one`
on 4 patients x 6 timepoints):

- `--bcmopt` with `ptmhsampler.checkpoint_file` set: every inner sampler
  runs from scratch, so every (temperature, sample) row has a finite MAP
  log posterior and a MAP sample, and MAP_estimates_paramvalues.tsv has
  as many columns on every row as in its header (the JAX CLI resumes each
  sampler after the first from the first one's finished checkpoint);
- a `run` interrupted after its first segment and resumed from its
  checkpoint writes on into the interrupted run's output.nc, which then
  equals an uninterrupted run's, array by array; an output file of
  another shape is refused by name.
"""

import os
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest

from bcm3_tpu_torch import cli
from bcm3_tpu_torch.io.output import NC_FILL_DOUBLE
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.sampler.pt import SamplerPT

CONFIG = """[sampler]
num_samples=20
use_every_nth=1
rngseed=5

[ptmhsampler]
num_chains=3
num_ensembles=4
proposal_type=global_covariance
adapt_proposal_samples=10
adapt_proposal_times=1
"""


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_repairs"))
    trial, _ = synthesize_trial(num_patients=4, num_timepoints=6, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(os.path.join(d, "prior.xml"), 4, "one")
    write_poppk_likelihood_xml(os.path.join(d, "likelihood.xml"), pk, "TRIAL1", "lapatinib", "one")
    tree = ET.parse(os.path.join(d, "prior.xml"))
    root = tree.getroot()
    root.remove(next(v for v in root if v.get("name") == "mean_excretion"))
    tree.write(os.path.join(d, "prior_bcmopt.xml"))
    with open(os.path.join(d, "config.txt"), "w") as f:
        f.write(CONFIG)
    return d


def _argv(d, folder, *extra, prior="prior.xml"):
    return ["-c", os.path.join(d, "config.txt"), "--prior", os.path.join(d, prior),
            "--likelihood", os.path.join(d, "likelihood.xml"),
            "--output.folder", os.path.join(d, folder), "--device", "cpu",
            "--dtype", "float64", *extra]


def _with_checkpoint(d, folder):
    cfg = os.path.join(d, f"config_{folder}.txt")
    with open(cfg, "w") as f:
        f.write(CONFIG + f"checkpoint_file={os.path.join(d, folder, 'ckpt.npz')}\n")
    return cfg


def test_bcmopt_with_a_checkpoint_file_finds_every_map(model):
    d = model
    assert cli.main(_argv(d, "stored")) == 0
    stored = os.path.join(d, "stored", "output.nc")
    argv = _argv(d, "bcmopt", "--bcmopt", "--bcmopt.input", stored, "--bcmopt.num_samples",
                 "2", "--sampler.num_samples", "5", prior="prior_bcmopt.xml")
    argv[1] = _with_checkpoint(d, "bcmopt")
    assert cli.main(argv) == 0
    with open(os.path.join(d, "bcmopt", "MAP_estimates_paramvalues.tsv")) as f:
        lines = f.read().splitlines()
    header, rows = lines[0].split("\t"), [r.split("\t") for r in lines[1:]]
    assert len(rows) == 3 * 2  # 3 temperatures x 2 stored samples
    assert all(len(r) == len(header) for r in rows)
    lpost = np.array([float(r[header.index("log posterior")]) for r in rows])
    assert np.isfinite(lpost).all()
    optimized = [i for i, h in enumerate(header) if h.startswith("optimized_")]
    assert np.isfinite([[float(r[i]) for i in optimized] for r in rows]).all()


class _Interrupted(Exception):
    pass


def _arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_resumed_run_keeps_the_rows_written_before(model, monkeypatch):
    d = model
    argv = _argv(d, "whole")
    argv[1] = _with_checkpoint(d, "whole")
    assert cli.main(argv) == 0

    argv = _argv(d, "resumed")
    argv[1] = _with_checkpoint(d, "resumed")
    save = SamplerPT._save_checkpoint

    def save_then_stop(self, *args):
        save(self, *args)
        raise _Interrupted  # the first save: the end of the first segment

    with monkeypatch.context() as m:
        m.setattr(SamplerPT, "_save_checkpoint", save_then_stop)
        with pytest.raises(_Interrupted):
            cli.main(argv)
    first = _arrays(os.path.join(d, "resumed", "output.nc"))["samples/log_likelihood"]
    # the first segment's 10 samples of 4 ensembles are written, the rest
    # of the file holds the fill value
    assert (first[:10 * 4] != NC_FILL_DOUBLE).all() and (first[10 * 4:] == NC_FILL_DOUBLE).all()
    assert cli.main(argv) == 0

    whole = _arrays(os.path.join(d, "whole", "output.nc"))
    resumed = _arrays(os.path.join(d, "resumed", "output.nc"))
    assert sorted(whole) == sorted(resumed)
    for name in whole:
        np.testing.assert_array_equal(resumed[name], whole[name], err_msg=name)


def test_resume_refuses_an_output_file_of_another_shape(model):
    """A run with another ladder finds the checkpoint and the output file of
    a finished run: the file is refused by name before any sampling."""
    d = model
    argv = _argv(d, "other")
    argv[1] = _with_checkpoint(d, "other")
    assert cli.main(argv) == 0
    with pytest.raises(ValueError, match="output.nc"):
        cli.main(argv + ["--ptmhsampler.num_chains", "4"])
