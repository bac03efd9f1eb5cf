"""pt.iter_ms (ms, program span): milliseconds a PT iteration, from the
sampler's own sampling_seconds (its iterations alone) summed over the
runs, over their iterations: in a traced run, the window's untraced runs,
which the profiler's host cost does not slow."""


def read(ctx):
    iters = sum(r["iterations"] for r in ctx.runs)
    return 1e3 * sum(r["sampling_seconds"] for r in ctx.runs) / iters if iters else None
