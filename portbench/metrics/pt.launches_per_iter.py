"""pt.launches_per_iter (launches/iter, device trace): device operations
that start inside the "SamplerPT.sampling" spans, over the iterations of
those runs (the benchmark's boundary adds one copy every 16th likelihood
call in a traced run)."""

SPAN = "SamplerPT.sampling"


def read(ctx):
    if ctx.trace is None or ctx.trace.span_count(SPAN) != len(ctx.runs):
        return None
    ops, _, _ = ctx.trace.device_in_span(SPAN)
    iters = sum(r["iterations"] for r in ctx.runs)
    return ops / iters if ops and iters else None
