"""device_idle.nuts (%, device trace): 100 x (1 - device busy / wall)
inside the "SamplerNUTS.sampling" spans."""

SPAN = "SamplerNUTS.sampling"


def read(ctx):
    if ctx.trace is None:
        return None
    ops, busy, wall = ctx.trace.device_in_span(SPAN)
    return 100.0 * (1.0 - busy / wall) if ops and wall > 0 else None
