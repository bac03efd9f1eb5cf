"""nuts.warmup_idle (%, device trace): 100 x (1 - device busy / wall)
inside the program's "SamplerNUTS.warmup" spans, as device_idle.nuts reads
"SamplerNUTS.sampling": the warm-up, two thirds of a run's transitions."""

SPAN = "SamplerNUTS.warmup"


def read(ctx):
    if ctx.trace is None:
        return None
    ops, busy, wall = ctx.trace.device_in_span(SPAN)
    return 100.0 * (1.0 - busy / wall) if ops and wall > 0 else None
