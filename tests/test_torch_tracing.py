"""The port's profiler spans and run() counters, on the CPU (banana, float64).

With no profiler on, a run enters no `torch.profiler.record_function`;
under `torch.profiler.profile` every layer span of SamplerPT and
SamplerNUTS is in the trace, nested and counted as the samplers' docs
say; the samples are the same bit for bit either way; and run()'s
`counters` hold their keys within the run's own walls.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bcm3_tpu_torch import Prior, VariableSet, create_likelihood
from bcm3_tpu_torch.sampler import NUTSConfig, PTConfig, SamplerNUTS, SamplerPT

BANANA = os.path.join(os.path.dirname(__file__), "fixtures", "examples", "banana")
PT = dict(num_samples=6, use_every_nth=2, num_chains=3, num_ensembles=2,
          adapt_proposal_samples=0, adapt_proposal_times=0, seed=7, device="cpu",
          dtype=torch.float64)
NUTS = dict(num_samples=3, num_warmup=20, num_chains=8, max_tree_depth=3, seed=7,
            device="cpu", dtype=torch.float64)
ITERATIONS = PT["num_samples"] * PT["use_every_nth"]


def _model():
    vs = VariableSet.from_xml(f"{BANANA}/prior.xml")
    return Prior.from_xml(f"{BANANA}/prior.xml", vs), create_likelihood(
        f"{BANANA}/likelihood.xml", vs)


def _pt():
    return SamplerPT(*_model(), PTConfig(**PT))


def _nuts():
    return SamplerNUTS(*_model(), NUTSConfig(**NUTS))


def _traced(sampler):
    """(run()'s result, {span name: sorted (start, end) ns}) of a run under
    the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sampler.run()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return res, {k: sorted(v) for k, v in spans.items()}


def _inside(spans, name, parents):
    """How many occurrences of `name` lie inside an occurrence of one of
    `parents`."""
    outer = [iv for p in parents for iv in spans.get(p, [])]
    return sum(any(a <= s and e <= b for a, b in outer) for s, e in spans.get(name, []))


@pytest.fixture(scope="module")
def pt_traced():
    s = _pt()
    res, spans = _traced(s)
    return s, res, spans


@pytest.fixture(scope="module")
def nuts_traced():
    s = _nuts()
    before = s.target.gradient_evaluations
    res, spans = _traced(s)
    return s.target.gradient_evaluations - before, res, spans


@pytest.mark.parametrize("make", [_pt, _nuts], ids=["pt", "nuts"])
def test_no_profiler_no_record_function(make, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    make().run()
    assert entered == []


@pytest.mark.parametrize("make", [_pt, _nuts], ids=["pt", "nuts"])
def test_the_profiler_leaves_the_samples_bit_identical(make):
    plain = make().run()
    res, _ = _traced(make())
    for key in ("samples", "log_prior", "log_likelihood"):
        np.testing.assert_array_equal(res[key], plain[key])


def test_pt_spans_nest_and_count(pt_traced):
    s, _, spans = pt_traced
    blocks = len(s.blocks)
    for name in ("SamplerPT.sampling", "SamplerPT.start_search", "SamplerPT.result"):
        assert len(spans[name]) == 1, name
    for name in ("SamplerPT.start_search", "SamplerPT.result"):
        assert _inside(spans, name, ["SamplerPT.sampling"]) == 0, name
    for name in ("SamplerPT.draw", "SamplerPT.exchange", "SamplerPT.mutate"):
        assert len(spans[name]) == ITERATIONS, name
        assert _inside(spans, name, ["SamplerPT.sampling"]) == ITERATIONS, name
    assert _inside(spans, "SamplerPT.propose", ["SamplerPT.mutate"]) == ITERATIONS * blocks
    assert len(spans["SamplerPT.propose"]) == ITERATIONS * blocks
    for name in ("SamplerPT.prior", "SamplerPT.likelihood"):
        # each mutate's evaluations, and the start search's tries
        assert _inside(spans, name, ["SamplerPT.mutate"]) == ITERATIONS * blocks, name
        searched = _inside(spans, name, ["SamplerPT.start_search"])
        assert searched >= 1 and searched + ITERATIONS * blocks == len(spans[name]), name
    for name in ("SamplerPT.emit", "SamplerPT.drain"):
        assert spans[name] and _inside(spans, name, ["SamplerPT.sampling"]) == len(spans[name])


def test_nuts_spans_nest_and_count(nuts_traced):
    evaluations, _, spans = nuts_traced
    leaves = evaluations - 1  # the start's evaluation is no leaf
    assert len(spans["SamplerNUTS.leaf"]) == leaves > NUTS["num_warmup"]
    assert len(spans["LogPosterior.value_and_grad"]) == leaves + 1
    assert _inside(spans, "LogPosterior.value_and_grad", ["SamplerNUTS.leaf"]) == leaves
    assert _inside(spans, "SamplerNUTS.leaf",
                   ["SamplerNUTS.warmup", "SamplerNUTS.sampling"]) == leaves
    for name in ("SamplerNUTS.warmup", "SamplerNUTS.sampling", "SamplerNUTS.emit"):
        assert len(spans[name]) == 1, name
    assert _inside(spans, "SamplerNUTS.warmup", ["SamplerNUTS.sampling"]) == 0


def test_run_counters(pt_traced, nuts_traced):
    res = pt_traced[1]
    c = res["counters"]
    assert set(c) == {"start_search_seconds"}
    assert 0.0 < c["start_search_seconds"] <= res["elapsed_seconds"] - res["sampling_seconds"]
    res = nuts_traced[1]
    c = res["counters"]
    assert set(c) == {"warmup_seconds", "host_wait_seconds"}
    assert 0.0 < c["host_wait_seconds"] <= c["warmup_seconds"] + res["sampling_seconds"]
    assert c["warmup_seconds"] <= res["elapsed_seconds"] - res["sampling_seconds"]
