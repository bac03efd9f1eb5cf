"""device_idle.pt (%, device trace): 100 x (1 - device busy / wall) inside
the "SamplerPT.sampling" spans; busy is the union of the device
operations that start inside them."""

SPAN = "SamplerPT.sampling"


def read(ctx):
    if ctx.trace is None:
        return None
    ops, busy, wall = ctx.trace.device_in_span(SPAN)
    return 100.0 * (1.0 - busy / wall) if ops and wall > 0 else None
