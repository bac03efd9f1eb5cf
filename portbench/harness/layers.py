"""Launch calls by program layer in a traced run.

A launch call is a host CUDA runtime call that enqueues device work:
`cudaLaunchKernel*`, `cuLaunchKernel*`, `cudaMemcpyAsync`,
`cudaMemsetAsync`. It is put down to a span by its host start time, so it
is attributed to the layer that issued it even where the device runs far
behind the host (a device operation's start, which `device_in_span` reads,
is not), and on any thread: the autograd engine launches a backward pass
from its own thread while the span that called it waits. The readers here
take a `TraceSummary` (harness/trace.py) as it is and change nothing in it.
"""

from __future__ import annotations

import re

import numpy as np

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpyAsync|cudaMemsetAsync)")


def _covered(t, occurrences):
    """Which of the sorted times t lie inside one of a span's occurrences
    (sorted by start; a span's occurrences do not overlap each other)."""
    ss, se = occurrences
    if len(ss) == 0:
        return np.zeros(len(t), dtype=bool)
    i = np.searchsorted(ss, t, side="right") - 1
    return (i >= 0) & (t <= se[np.clip(i, 0, None)])


def launch_times(trace):
    """The host start times of every launch call of the trace."""
    hit = np.array([bool(LAUNCH.match(n)) for n in trace.names] or [False])
    return trace.cpu_start[hit[trace.cpu_name]] if len(trace.cpu_name) else trace.cpu_start


def launch_calls(trace, span, within=None, exclude=()):
    """(launch calls, occurrences) of `span`: the calls that start inside
    its occurrences, keeping only the occurrences that start inside an
    occurrence of the span `within` where that is given, and leaving out
    the calls that start inside an occurrence of a span of `exclude`
    (child spans). None where the trace holds no launch call at all (no
    device trace) or no occurrence of `span`."""
    t = launch_times(trace)
    if len(t) == 0 or span not in trace.spans:
        return None
    ss, se = trace.spans[span]
    if within is not None:
        keep = _covered(ss, trace.spans.get(within, ((), ())))
        ss, se = ss[keep], se[keep]
        if len(ss) == 0:
            return None
    inside = _covered(t, (ss, se))
    for child in exclude:
        if child in trace.spans:
            inside &= ~_covered(t, trace.spans[child])
    return int(inside.sum()), len(ss)


def per_iteration(ctx, span, exclude=()):
    """Launch calls of `span` inside the "SamplerPT.sampling" spans (less
    those in the `exclude` spans) over the iterations of the traced runs."""
    sampling = "SamplerPT.sampling"
    if ctx.trace is None or ctx.trace.span_count(sampling) != len(ctx.runs):
        return None
    found = launch_calls(ctx.trace, span, within=sampling, exclude=exclude)
    iters = sum(r["iterations"] for r in ctx.runs)
    return found[0] / iters if found and iters else None


def per_leaf(ctx, span, within=None, exclude=()):
    """Launch calls of `span` over the NUTS leaves ("SamplerNUTS.leaf"
    spans, warm-up and sampling) of the traced runs."""
    if ctx.trace is None:
        return None
    leaves = ctx.trace.span_count("SamplerNUTS.leaf")
    found = launch_calls(ctx.trace, span, within=within, exclude=exclude)
    return found[0] / leaves if found and leaves else None
