"""nuts.launches_per_leaf (launches/leaf, device trace): device operations
that start inside the "SamplerNUTS.sampling" spans, over the batched
gradient evaluations (leaves) of those sampling loops."""

SPAN = "SamplerNUTS.sampling"


def read(ctx):
    if ctx.trace is None or ctx.trace.span_count(SPAN) != len(ctx.runs):
        return None
    ops, _, _ = ctx.trace.device_in_span(SPAN)
    leaves = sum(r["gradient_evaluations_per_transition"] * r["sampling_transitions"]
                 for r in ctx.runs)
    return ops / leaves if ops and leaves else None
