"""The port's ProgressIndicatorConsole (a copy of the JAX package's) and its
wiring into the port's SamplerPT (reference:
src/sampler/ProgressIndicatorConsole.cpp, SamplerPT.cpp:223-226)."""

import io

import numpy as np
import pytest
import torch

from bcm3_tpu.io.progress import ProgressIndicatorConsole as JProgress
from bcm3_tpu_torch.io.progress import ProgressIndicatorConsole


def _throttle_and_map(cls):
    """tests/test_progress.py:11-28: huge throttle, MAP tracking."""
    buf = io.StringIO()
    p = cls(update_time=1000.0, stream=buf)
    p.start()
    p.notify_max_lposterior(-12.5)
    p.notify_max_lposterior(-20.0)  # lower: must not replace the max
    p.notify_max_lposterior(np.nan)  # non-finite: ignored
    p.update(0.1)  # first update always renders
    counts = [buf.getvalue().count("Progress:")]
    p.update(0.2)  # throttled (update_time huge, fraction < 1)
    p.update(0.3)
    counts.append(buf.getvalue().count("Progress:"))
    p.update(1.0)  # fraction >= 1 always renders
    counts.append(buf.getvalue().count("Progress:"))
    out = buf.getvalue()
    assert counts == [1, 1, 2]
    assert "100.0%" in out and "max lposterior: -12.5" in out
    return counts


def _zero_throttle(cls):
    """tests/test_progress.py:31-36: every update renders."""
    buf = io.StringIO()
    p = cls(update_time=0.0, stream=buf)
    p.update(0.25)
    p.update(0.5)
    assert buf.getvalue().count("Progress:") == 2
    return [2]


@pytest.mark.parametrize("case", [_throttle_and_map, _zero_throttle],
                         ids=["throttle_and_map", "zero_throttle"])
def test_progress_matches_jax(case):
    assert case(ProgressIndicatorConsole) == case(JProgress)


def test_port_sampler_drives_progress(tmp_path):
    """One tick per emitted chunk, a final 100% line and the running MAP of
    the fixed-temperature chains."""
    from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
    from bcm3_tpu_torch.likelihoods.poppk_synth import (
        synthesize_trial,
        write_poppk_likelihood_xml,
        write_poppk_prior_xml,
    )
    from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

    trial, _ = synthesize_trial(num_patients=2, num_timepoints=6, seed=5)
    pk = str(tmp_path / "pk.nc")
    trial.save(pk, "TRIAL1", "lapatinib")
    write_poppk_prior_xml(str(tmp_path / "prior.xml"), 2, "one")
    write_poppk_likelihood_xml(str(tmp_path / "lik.xml"), pk, "TRIAL1", "lapatinib", "one")
    vs = VariableSet.from_xml(str(tmp_path / "prior.xml"))
    s = SamplerPT(
        Prior.from_xml(str(tmp_path / "prior.xml"), vs),
        create_likelihood(str(tmp_path / "lik.xml"), vs),
        PTConfig(num_samples=6, num_chains=2, adapt_proposal_samples=3, adapt_proposal_times=1,
                 seed=11, device="cpu", dtype=torch.float64),
    )
    buf = io.StringIO()
    s.progress = ProgressIndicatorConsole(update_time=0.0, stream=buf)
    res = s.run()
    out = buf.getvalue()
    # two segments (the boundary after 3 samples), one chunk each, then finish
    assert out.count("Progress:") == 3
    assert " 50.0%" in out and "100.0%" in out
    best = np.max(res["log_prior"][:, -1] + res["log_likelihood"][:, -1])
    assert f"max lposterior: {best:.5g}" in out
