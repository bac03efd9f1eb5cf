"""SamplerPT's chunked emission and `profile_dir`, on the CPU in float64.

The banana fixture at the shape of the JAX package's chunked-emission test
(tests/test_ensembles.py `test_chunked_emission_bit_identical`: 40 samples
thinned by 2, 4 chains, 2 ensembles, one adaptation after 20), with
global-covariance proposals (what the chunks could change is the stream of
the segments around the boundary, not the fit; the Gaussian mixture's host
EM took 90% of the test's time): the samples,
log-densities, acceptance counts and handler calls are the same bit for bit
for `emit_chunk_size` 0 (one pull a segment), 7 and None (~32 MB a pull),
with and without `emit_fixed_only`. A run with `profile_dir` writes a
torch.profiler trace there that holds the sampling span.
"""

import glob
import os

import numpy as np
import pytest
import torch

from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.sampler import PTConfig, SamplerPT

BANANA = os.path.join(os.path.dirname(__file__), "fixtures", "examples", "banana")
COMMON = dict(num_samples=40, use_every_nth=2, num_chains=4, num_ensembles=2,
              adapt_proposal_samples=20, adapt_proposal_times=1,
              proposal_type="global_covariance", seed=5, device="cpu", dtype=torch.float64)


class _Kept:
    """A sample handler that keeps the chunks it receives."""

    def __init__(self):
        self.calls = []

    def receive_samples(self, x, lprior, llh, temperatures):
        self.calls.append((x.copy(), lprior.copy(), llh.copy()))


def _model():
    vs = VariableSet.from_xml(f"{BANANA}/prior.xml")
    return Prior.from_xml(f"{BANANA}/prior.xml", vs), create_likelihood(
        f"{BANANA}/likelihood.xml", vs)


def _run(chunk, fixed_only):
    prior, lik = _model()
    handler = _Kept()
    s = SamplerPT(prior, lik, PTConfig(emit_chunk_size=chunk, emit_fixed_only=fixed_only,
                                       **COMMON), sample_handlers=[handler])
    return s.run(), handler.calls


@pytest.mark.parametrize("fixed_only", [False, True])
def test_chunk_size_leaves_the_samples_bit_identical(fixed_only):
    mono, mono_calls = _run(0, fixed_only)
    L = 1 if fixed_only else COMMON["num_chains"]
    assert mono["samples"].shape == (40 * 2, L, 2)
    # one pull a segment: the segments before and after the adaptation
    assert [c[0].shape[0] for c in mono_calls] == [20 * 2, 20 * 2]
    for chunk in (7, None):
        res, calls = _run(chunk, fixed_only)
        for key in ("samples", "log_prior", "log_likelihood"):
            np.testing.assert_array_equal(res[key], mono[key])
        for key, counts in res["acceptance"].items():
            np.testing.assert_array_equal(counts, mono["acceptance"][key])
        # the handlers see the same rows in order, chunk by chunk
        sizes = [c[0].shape[0] // 2 for c in calls]
        assert sizes == ([7, 7, 6, 7, 7, 6] if chunk == 7 else [20, 20])
        for i in range(3):
            np.testing.assert_array_equal(np.concatenate([c[i] for c in calls]),
                                          np.concatenate([c[i] for c in mono_calls]))


def test_profile_dir_writes_a_trace(tmp_path):
    prior, lik = _model()
    cfg = PTConfig(**dict(COMMON, num_samples=4, adapt_proposal_samples=0,
                          adapt_proposal_times=0), profile_dir=str(tmp_path))
    SamplerPT(prior, lik, cfg).run()
    traces = glob.glob(str(tmp_path / "*.pt.trace.json*"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert "SamplerPT.sampling" in f.read()


def test_negative_chunk_size_is_refused():
    prior, lik = _model()
    with pytest.raises(ValueError, match="emit_chunk_size"):
        SamplerPT(prior, lik, PTConfig(emit_chunk_size=-1, **COMMON))
