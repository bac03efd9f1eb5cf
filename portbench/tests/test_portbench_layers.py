"""harness/layers.py and the per-layer launch metrics on hand-made traces:
launch calls counted by their host time inside a span's occurrences, the
occurrences kept inside another span, child spans left out, and the PT
partition of an iteration's launch calls closing exactly."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.harness import layers, registry
from portbench.harness.trace import TraceSummary


def span(name, start, end):
    return (name, False, start, end, True)


def host(name, at):
    return (name, False, at, at + 1, False)


def device(start, end):
    return ("void some_kernel<float>()", True, start, end, False)


# one run of one iteration: the start search, then the sampling span
PT_EVENTS = [
    span("SamplerPT.start_search", 0, 100),
    span("SamplerPT.prior", 10, 20), host("cudaLaunchKernel", 15),
    span("SamplerPT.likelihood", 30, 40), host("cudaLaunchKernel", 35),
    span("SamplerPT.sampling", 200, 1000),
    span("SamplerPT.draw", 210, 230), host("cudaLaunchKernel", 215),
    host("aten::add", 216), host("cuLaunchKernelEx", 220),
    span("SamplerPT.exchange", 240, 260), host("cudaLaunchKernelExC", 250),
    span("SamplerPT.mutate", 270, 400),
    span("SamplerPT.propose", 275, 300), host("cudaLaunchKernel", 280),
    host("cudaMemsetAsync", 305),
    span("SamplerPT.prior", 310, 320), host("cudaLaunchKernel", 315),
    span("SamplerPT.likelihood", 330, 360), host("cudaLaunchKernel", 335),
    host("cudaMemcpyAsync", 340), host("cudaLaunchKernel", 345),
    host("cudaLaunchKernel", 370),
    span("SamplerPT.emit", 410, 420), host("cudaMemcpyAsync", 415),
    host("cudaEventRecord", 416),
    span("SamplerPT.drain", 430, 440), host("cudaEventSynchronize", 435),
    device(215, 300),
]
PT_METRICS = {"pt.draw_launches": 2, "pt.exchange_launches": 1, "pt.propose_launches": 1,
              "pt.prior_launches": 1, "pt.likelihood_launches": 3,
              "pt.mutate_self_launches": 2}

# two leaves, each one gradient evaluation and tree arithmetic, after the
# start's evaluation; the warm-up holds the first leaf
NUTS_EVENTS = [
    span("LogPosterior.value_and_grad", 0, 50), host("cudaLaunchKernel", 10),
    span("SamplerNUTS.warmup", 100, 200),
    span("SamplerNUTS.leaf", 110, 150),
    span("LogPosterior.value_and_grad", 115, 140), host("cudaLaunchKernel", 120),
    host("cudaLaunchKernel", 125), host("cudaLaunchKernel", 145),
    host("cudaLaunchKernel", 160),  # the transition's own, outside a leaf
    span("SamplerNUTS.sampling", 300, 400),
    span("SamplerNUTS.leaf", 310, 350),
    span("LogPosterior.value_and_grad", 315, 340), host("cudaLaunchKernel", 320),
    host("cudaLaunchKernel", 325), host("cudaLaunchKernel", 345),
    device(110, 150),
]


def summary(events):
    return TraceSummary(events, 1.0)


def read(name, trace, runs=({"iterations": 1},)):
    ctx = SimpleNamespace(trace=trace, runs=list(runs))
    return registry.load_module("metrics", name).read(ctx)


def test_launch_calls_nest_and_leave_out_children():
    t = summary(PT_EVENTS)
    assert layers.launch_calls(t, "SamplerPT.prior") == (2, 2)
    # the start search's evaluation is left out by "inside another span"
    assert layers.launch_calls(t, "SamplerPT.prior", within="SamplerPT.sampling") == (1, 1)
    assert layers.launch_calls(t, "SamplerPT.start_search") == (2, 1)
    assert layers.launch_calls(t, "SamplerPT.mutate") == (7, 1)
    children = ("SamplerPT.propose", "SamplerPT.prior", "SamplerPT.likelihood")
    assert layers.launch_calls(t, "SamplerPT.mutate", exclude=children) == (2, 1)
    assert layers.launch_calls(t, "SamplerPT.drain") == (0, 1)
    assert layers.launch_calls(t, "SamplerPT.absent") is None
    assert layers.launch_calls(t, "SamplerPT.draw", within="SamplerPT.absent") is None


def test_a_trace_without_launch_calls_reads_nothing():
    """A CPU trace has the spans but no CUDA runtime call: every launch
    metric is left out, never 0."""
    cpu = [e for e in PT_EVENTS + NUTS_EVENTS if e[4] or e[0].startswith("aten")]
    t = summary(cpu)
    assert layers.launch_calls(t, "SamplerPT.draw") is None
    for name in list(PT_METRICS) + ["nuts.grad_launches_per_leaf",
                                    "nuts.tree_launches_per_leaf", "nuts.warmup_idle"]:
        assert read(name, t) is None, name
        assert read(name, None) is None, name


@pytest.mark.parametrize("name,value", sorted(PT_METRICS.items()))
def test_pt_launch_metrics(name, value):
    t = summary(PT_EVENTS)
    assert read(name, t) == value
    # two runs' iterations, one sampling span: the runs are not the trace's
    assert read(name, t, runs=[{"iterations": 1}] * 2) is None


def test_the_pt_partition_closes():
    """The six layers, the emission and the drain hold every launch call
    of the sampling span, each once."""
    t = summary(PT_EVENTS)
    total, _ = layers.launch_calls(t, "SamplerPT.sampling")
    parts = sum(read(name, t) for name in PT_METRICS)
    parts += sum(layers.launch_calls(t, s)[0] for s in ("SamplerPT.emit", "SamplerPT.drain"))
    assert parts == total == 11


def test_nuts_launch_metrics():
    t = summary(NUTS_EVENTS)
    assert read("nuts.grad_launches_per_leaf", t) == 2.0  # the start's call left out
    assert read("nuts.tree_launches_per_leaf", t) == 1.0
    assert read("nuts.warmup_idle", t) == pytest.approx(60.0)
