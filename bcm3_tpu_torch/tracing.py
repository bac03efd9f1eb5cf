"""Profiler spans at the port's layer boundaries, free when no profiler runs.

`span(name)` is a `torch.profiler.record_function` range while a profiler
is on (a `torch.profiler.profile` block, `PTConfig.profile_dir`, a
benchmark's traced window) and one shared no-op context otherwise: a bare
`record_function` costs microseconds a call even with the profiler off,
the flag read a fraction of one. `traced(name)` runs a whole function in
such a span. The ranges lie in the profiler's own timeline, on the clock
of its device trace, so a reader of a trace can put device work, idle
time and launch calls down to the innermost layer.

The spans, by layer (the sampler's modules name them):

- `SamplerPT.sampling` (the iterations), `SamplerPT.adaptation` (a
  boundary), `SamplerPT.start_search` (a run's start-position search),
  `SamplerPT.result` (the result's assembly after the iterations);
  inside the iterations `SamplerPT.draw`, `SamplerPT.exchange`,
  `SamplerPT.mutate` (and in it `SamplerPT.propose`, `SamplerPT.prior`,
  `SamplerPT.likelihood`; the prior and likelihood spans also lie in the
  start search), `SamplerPT.emit` (the emitted rows, their stack and their
  copy's start) and `SamplerPT.drain` (the copy's wait and the host's
  share);
- `SamplerNUTS.warmup`, `SamplerNUTS.sampling`, `SamplerNUTS.leaf` (one
  leapfrog step of every chain and its tree updates), `SamplerNUTS.emit`;
  `SamplerHMC.sampling`; `LogPosterior.value_and_grad` (forward and
  backward of the gradient samplers' target).
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler is on, else a no-op
    context. The profiler's flag is read at each call."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def traced(name: str):
    """Decorate a function to run inside `span(name)` at each call."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
