"""Checkpoint/resume of the port's SamplerPT (io/checkpoint.py), by the
protocol of the JAX package's tests/test_checkpoint.py:20-71.

- A run interrupted at a boundary and resumed equals the uninterrupted
  run exactly (samples, log-densities and acceptance counters), for GMM,
  global-covariance and clustered proposals (whose checkpoint holds the
  ClusterAssigner); also when interrupted after the last boundary, where
  the running segment's per-chain proposal state must come back too.
- A checkpoint of a finished run resumes to an empty tail, with the
  counters restored.
- A checkpoint of another version, one written by the JAX package, and
  one whose history has another shape are refused by name.
- The atomic write leaves no temporary file behind.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcm3_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from bcm3_tpu.sampler.pt import PTState as JPTState
from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.io import checkpoint
from bcm3_tpu_torch.likelihoods.poppk_synth import (
    synthesize_trial,
    write_poppk_likelihood_xml,
    write_poppk_prior_xml,
)
from bcm3_tpu_torch.sampler import PTConfig, SamplerPT


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("poppk_ckpt"))
    P = 4
    trial, _ = synthesize_trial(num_patients=P, num_timepoints=6, seed=5)
    pk = os.path.join(d, "pkdata.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    prior_xml, lik_xml = os.path.join(d, "prior.xml"), os.path.join(d, "likelihood.xml")
    write_poppk_prior_xml(prior_xml, P, "one")
    write_poppk_likelihood_xml(lik_xml, pk, "TRIAL1", "lapatinib", "one")
    vs = VariableSet.from_xml(prior_xml)
    return Prior.from_xml(prior_xml, vs), create_likelihood(lik_xml, vs)


_COMMON = dict(
    num_samples=30, use_every_nth=2, num_chains=4, num_ensembles=16,
    adapt_proposal_samples=10, adapt_proposal_times=2, seed=11,
    adapt_proposal_max_clustering_samples=100, device="cpu", dtype=torch.float64,
)


def _run(model, **cfg):
    s = SamplerPT(*model, PTConfig(**dict(_COMMON, **cfg)))
    return s, s.run()


@pytest.mark.parametrize(
    "proposal_type,stop",
    [("gaussian_mixture", 10), ("global_covariance", 10), ("clustered_covariance", 10),
     ("global_covariance", 25)],
    ids=["gmm", "global_covariance", "clustered", "after_last_boundary"],
)
def test_resume_is_identical(model, tmp_path, proposal_type, stop):
    ck = str(tmp_path / "state.ckpt")
    _, full = _run(model, proposal_type=proposal_type)
    # the interrupted run: only the samples up to `stop`, checkpointing on
    _, part1 = _run(model, proposal_type=proposal_type, num_samples=stop, checkpoint_file=ck)
    s2, part2 = _run(model, proposal_type=proposal_type, checkpoint_file=ck)
    E = _COMMON["num_ensembles"]
    assert part1["samples"].shape[0] == stop * E
    assert part2["samples"].shape[0] == (30 - stop) * E
    for k in ("samples", "log_prior", "log_likelihood"):
        np.testing.assert_array_equal(np.concatenate([part1[k], part2[k]]), full[k], err_msg=k)
    for k, v in full["acceptance"].items():
        np.testing.assert_array_equal(part2["acceptance"][k], v, err_msg=k)
    assert part2["adaptation_boundaries"] == (2 if stop == 10 else 0)
    assert s2.adaptations_done == 2
    if proposal_type == "clustered_covariance":
        assert s2._assigner is not None and all(p.clustered for p in s2.proposals)


def test_finished_run_resumes_to_an_empty_tail(model, tmp_path):
    ck = str(tmp_path / "state.ckpt")
    cfg = dict(num_samples=20, adapt_proposal_times=1, checkpoint_file=ck)
    s1, _ = _run(model, **cfg)
    s2, res = _run(model, **cfg)
    assert res["samples"].shape == (0, 4, s2.num_variables)
    assert res["log_prior"].shape == res["log_likelihood"].shape == (0, 4)
    assert s2.adaptations_done == 1 and s2.adaptation_iteration == s1.adaptation_iteration == 2
    for k, f in (("attempted_mutate", "att_mut"), ("accepted_mutate", "acc_mut"),
                 ("attempted_exchange", "att_exc"), ("accepted_exchange", "acc_exc")):
        np.testing.assert_array_equal(res["acceptance"][k], getattr(s1.state, f).numpy())


def _jax_checkpoint(path):
    """A checkpoint written by the JAX package's own save_checkpoint."""
    fields = {f.name: jnp.zeros(2) for f in dataclasses.fields(JPTState)}
    jax_save_checkpoint(path, JPTState(**fields), [], [np.arange(2)], 0, 0, 1)


@pytest.mark.parametrize("kind", ["other_version", "jax_package", "history_shape"])
def test_foreign_checkpoints_are_refused(model, tmp_path, monkeypatch, kind):
    ck = str(tmp_path / "state.ckpt")
    if kind == "jax_package":
        _jax_checkpoint(ck)
        match = "checkpoint of the JAX package"
    else:
        with monkeypatch.context() as m:
            if kind == "other_version":
                m.setattr(checkpoint, "CHECKPOINT_VERSION", 99)
            _run(model, num_samples=10, checkpoint_file=ck)
        match = "of version 99; this package reads version 1" if kind == "other_version" \
            else r"holds a history of shape \(64, 640\), this sampler's is \(64, 320\)"
    with pytest.raises(ValueError, match=match):
        # another history size for the last case: 10 samples x 2 iterations x 2
        # moves = 40 rows of 16 variables in the file, 10 x 1 x 2 = 20 rows here
        _run(model, checkpoint_file=ck, use_every_nth=1 if kind == "history_shape" else 2)


def test_write_leaves_no_temporary_file(model, tmp_path, monkeypatch):
    ck = tmp_path / "sub" / "state.ckpt"
    s, _ = _run(model, num_samples=10, adapt_proposal_samples=0, checkpoint_file=str(ck))
    assert sorted(os.listdir(tmp_path / "sub")) == ["state.ckpt"]
    payload = checkpoint.load_checkpoint(str(ck), "cpu", torch.float64)
    assert payload["emitted"] == 10 and payload["state"].history.shape == s.state.history.shape
    torch.testing.assert_close(payload["state"].x, s.state.x, rtol=0, atol=0)
    # a write that fails leaves the previous checkpoint as it was, and no
    # temporary file
    def failing_savez(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", failing_savez)
    with pytest.raises(OSError, match="disk full"):
        s._save_checkpoint(str(ck), s.state, s.proposals, 3)
    assert sorted(os.listdir(tmp_path / "sub")) == ["state.ckpt"]
    assert checkpoint.load_checkpoint(str(ck), "cpu", torch.float64)["emitted"] == 10
