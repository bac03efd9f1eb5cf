"""The traced run's window: torch.profiler over it, reduced to arrays.

`Trace` runs the profiler (host and device activities) over the
window's first runs, until TRACE_SECONDS (or the window's length, where
that is shorter) have passed: reading a trace takes time in proportion
to its events (some 5 us an event, and a NUTS run makes ~2 million), and
a traced run has 360 s in all; the rest of the window runs untraced, and
the program's own spans and counters are read over those runs, which
the profiler's host cost does not slow. `summary()` turns the raw events into numpy
arrays of device operations, host operations and named spans, read straight from the
profiler's raw results (the FunctionEvent tree that `events()` builds
takes minutes at a window's millions of events). `TraceSummary`
answers what the metric readers ask: device operations and busy time
inside a span, a kernel's device seconds, the device's busy seconds over
the window, and the breakdown of the result line.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

# a host operation's label walks back at most this many events
_WALK = 64
TOP = 10
TRACE_SECONDS = 20.0


class Trace:
    """The profiler over the window's runs until TRACE_SECONDS, or the
    window's `seconds` where fewer, have passed at the end of a run; `runs`
    is how many it covered."""

    def __init__(self, enabled: bool, device: str, seconds: float):
        self.enabled = enabled
        self.device = device
        self.seconds = min(TRACE_SECONDS, seconds)
        self.prof = None
        self.window_s = None
        self.runs = 0

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    @property
    def tracing(self) -> bool:
        return self.prof is not None and self.window_s is None

    def after_run(self):
        """Count a finished run; stop tracing once its seconds have passed."""
        if self.tracing:
            self.runs += 1
            if time.perf_counter() - self._t0 >= self.seconds:
                self._stop()

    def _stop(self):
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        if self.tracing:
            self._stop()
        return False

    def summary(self) -> "TraceSummary | None":
        if self.prof is None:
            return None
        return TraceSummary(_raw_events(self.prof), self.window_s)


def _raw_events(prof):
    """(name, on the device, start ns, end ns, user annotation) of every
    event, read from the profiler's raw results, one accessor call an
    attribute."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, start, start + e.duration_ns(),
                    e.is_user_annotation()))
    return out


def _union(starts, ends):
    """Merged [start, end) intervals of possibly overlapping ones."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    groups = np.cumsum(new) - 1
    ms = s[new]
    me = np.zeros(len(ms), dtype=np.int64)
    np.maximum.at(me, groups, e)
    return ms, me


class TraceSummary:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        names, index = [], {}

        def ix(name):
            if name not in index:
                index[name] = len(names)
                names.append(name)
            return index[name]

        # every host span (torch.profiler.record_function, the benchmark's and
        # the program's, by name); a span's device-side range is no work
        dev, cpu, spans = [], [], {}
        for name, on_device, start, end, annotation in events:
            if annotation and not on_device:
                spans.setdefault(name, []).append((start, end))
        for name, on_device, start, end, annotation in events:
            if not (annotation or name in spans):
                (dev if on_device else cpu).append((start, end, ix(name)))
        self.names = names

        def arrays(rows):
            a = np.array(rows, dtype=np.int64).reshape(-1, 3)
            order = np.argsort(a[:, 0], kind="stable")
            return a[order, 0], a[order, 1], a[order, 2]

        self.dev_start, self.dev_end, self.dev_name = arrays(dev)
        self.cpu_start, self.cpu_end, self.cpu_name = arrays(cpu)
        self.spans = {k: arrays([(s, e, 0) for s, e in v])[:2] for k, v in spans.items()}

    # -- what the readers ask ----------------------------------------------

    def span_count(self, span: str) -> int:
        return len(self.spans.get(span, ((), ()))[0])

    def device_in_span(self, span: str):
        """(device operations, device busy seconds, span seconds) over the
        span's occurrences; an operation counts where it starts inside one."""
        if span not in self.spans or len(self.dev_start) == 0:
            return 0, 0.0, 0.0
        ss, se = self.spans[span]
        i = np.searchsorted(ss, self.dev_start, side="right") - 1
        inside = (i >= 0) & (self.dev_start <= se[np.clip(i, 0, None)])
        ms, me = _union(self.dev_start[inside], self.dev_end[inside])
        return int(inside.sum()), float((me - ms).sum()) / 1e9, float((se - ss).sum()) / 1e9

    def kernel_seconds(self, pattern: str):
        """Device seconds and launches of the operations whose name matches
        the regular expression."""
        rx = re.compile(pattern)
        hit = np.array([bool(rx.search(n)) for n in self.names] or [False])
        sel = hit[self.dev_name] if len(self.dev_name) else np.zeros(0, dtype=bool)
        return float((self.dev_end[sel] - self.dev_start[sel]).sum()) / 1e9, int(sel.sum())

    def busy_s(self) -> float:
        ms, me = _union(self.dev_start, self.dev_end)
        return float((me - ms).sum()) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's idle
        time by what the host was doing when it went idle (the innermost
        span, and the innermost host operation or "python")."""
        secs = np.zeros(len(self.names))
        np.add.at(secs, self.dev_name, (self.dev_end - self.dev_start) / 1e9)
        top = np.argsort(-secs)[:TOP]
        device_ops = [[self.names[i][:160], float(secs[i])] for i in top if secs[i] > 0]

        ms, me = _union(self.dev_start, self.dev_end)
        if len(ms) < 2:
            return {"device_ops": device_ops, "idle_gaps": []}
        g0, glen = me[:-1], (ms[1:] - me[:-1]) / 1e9
        label = np.array(["python"] * len(g0), dtype=object)
        # the innermost host operation (not a CUDA runtime call) at g0
        skip = np.array([n.startswith("cuda") for n in self.names])
        names = np.array(self.names, dtype=object)
        base = np.searchsorted(self.cpu_start, g0, side="right") - 1
        found = np.zeros(len(g0), dtype=bool)
        for k in range(_WALK if len(self.cpu_start) else 0):
            j = base - k
            jj = np.clip(j, 0, None)
            cover = (~found) & (j >= 0) & (self.cpu_end[jj] >= g0) & ~skip[self.cpu_name[jj]]
            label[cover] = names[self.cpu_name[jj[cover]]]
            found |= cover
            if found.all():
                break
        # the innermost span at g0
        span_label = np.array([""] * len(g0), dtype=object)
        span_start = np.full(len(g0), -1, dtype=np.int64)
        for name, (ss, se) in self.spans.items():
            i = np.searchsorted(ss, g0, side="right") - 1
            ii = np.clip(i, 0, None)
            cover = (i >= 0) & (se[ii] >= g0) & (ss[ii] > span_start)
            span_label[cover] = name
            span_start[cover] = ss[ii][cover]
        full = np.array([f"{s or 'no span'} / {o}" for s, o in zip(span_label, label)],
                        dtype=object)
        totals = {}
        for name, sec in zip(full, glen):
            totals[name] = totals.get(name, 0.0) + float(sec)
        idle = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": device_ops, "idle_gaps": [[k[:160], v] for k, v in idle]}
