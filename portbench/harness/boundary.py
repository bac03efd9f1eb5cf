"""The one boundary the benchmark owns: the likelihood it builds and hands
to the sampler.

`Boundary` wraps the program's PopPK likelihood model. Every call is
counted with its rows. In a traced run each call is a span,
"portbench.likelihood", and every EVERY_NTH_CALL-th call keeps a copy
of ROWS of its input rows (one device copy), from which the rooflines
count the work of the window's calls (rows spread over the batch).
"""

from __future__ import annotations

import contextlib

import torch

SPAN = "portbench.likelihood"
EVERY_NTH_CALL = 16
ROWS = 4


class Boundary:
    def __init__(self, model):
        self.model = model
        self.traced = False
        self.reset()

    def reset(self):
        self.calls = 0
        self.call_rows = []  # rows of each call
        self.call_grad = []  # whether the model was in its gradient mode
        self.samples = []  # (call index, input rows (rows, D) on the device)

    def __call__(self, xs: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        if not self.traced:
            return self.model.log_prob_batched(xs)
        self.call_rows.append(int(xs.shape[0]))
        self.call_grad.append(bool(getattr(self.model, "gradient_mode", False)))
        if (self.calls - 1) % EVERY_NTH_CALL == 0:
            # rows spread over the batch, from an offset that moves call to
            # call, so that every temperature and ensemble is drawn from
            step = max(1, xs.shape[0] // ROWS)
            start = (len(self.samples) * 7919) % step
            rows = xs[start::step][:ROWS]
            self.samples.append((self.calls - 1, rows.detach().clone()))
        with torch.profiler.record_function(SPAN):
            return self.model.log_prob_batched(xs)

    @contextlib.contextmanager
    def tracing(self, traced: bool):
        """Count from 0, and trace or not, for the duration."""
        self.reset()
        self.traced = traced
        try:
            yield self
        finally:
            self.traced = False
