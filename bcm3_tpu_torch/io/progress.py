"""Throttled console progress indicator.

Copied from the JAX package's bcm3_tpu/io/progress.py, which is pure
Python (reference: src/sampler/ProgressIndicator.h,
ProgressIndicatorConsole.cpp; wired by Sampler::Run via UpdateProgress,
Sampler.cpp:190-201). The reference throttles console updates by a
``progress_update_time`` option and logs the running maximum
log-posterior during sampling (SamplerPT.cpp:223-226).

The sampler runs whole segments on the device, so progress ticks at
emission-chunk boundaries (the host's touchpoints) instead of per sample;
each tick carries the fraction done, an ETA extrapolated from wall-clock
so far, the evaluation throughput when given and the running max
log-posterior over the fixed-temperature chains.
"""

from __future__ import annotations

import sys
import time

import numpy as np


class ProgressIndicatorConsole:
    """Throttled single-line console progress display.

    Parameters
    ----------
    update_time:
        Minimum seconds between console updates (reference option
        ``progress_update_time``, SamplerPT.cpp option table).
    stream:
        Output stream; defaults to stderr so piped/redirected sample
        output stays clean.
    """

    def __init__(self, update_time: float = 0.5, stream=None):
        self.update_time = float(update_time)
        self.stream = stream if stream is not None else sys.stderr
        self._start = None
        self._last_update = 0.0
        self._max_lposterior = -np.inf
        self._wrote = False

    def start(self):
        self._start = time.time()
        self._last_update = 0.0

    def notify_max_lposterior(self, value: float):
        """Track the running MAP value (reference: SamplerPT.cpp:223-226)."""
        if np.isfinite(value) and value > self._max_lposterior:
            self._max_lposterior = float(value)

    def update(self, fraction: float, evals_per_sec: float | None = None):
        """Report progress; rendered at most every ``update_time`` seconds.

        ``fraction`` is in [0, 1]. Always renders at fraction >= 1.
        """
        if self._start is None:
            self.start()
        now = time.time()
        if fraction < 1.0 and (now - self._last_update) < self.update_time:
            return
        self._last_update = now
        elapsed = now - self._start
        if fraction > 0:
            eta = elapsed * (1.0 - fraction) / fraction
            eta_str = f"{eta:6.0f}s remaining"
        else:
            eta_str = "   ?  remaining"
        parts = [f"Progress: {100.0 * fraction:5.1f}%", eta_str]
        if evals_per_sec:
            parts.append(f"{evals_per_sec:,.0f} evals/s")
        if np.isfinite(self._max_lposterior):
            parts.append(f"max lposterior: {self._max_lposterior:.5g}")
        line = " | ".join(parts)
        end = "\n" if fraction >= 1.0 else "\r"
        try:
            self.stream.write(line.ljust(79) + end)
            self.stream.flush()
            self._wrote = True
        except (ValueError, OSError):  # closed stream: drop silently
            pass

    def finish(self):
        if self._wrote:
            self.update(1.0)
