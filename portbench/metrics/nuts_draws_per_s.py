"""nuts_draws_per_s (draws/s, host clock): NUTS transitions a second over
all chains, warm-up included: chains x transitions of every completed
SamplerNUTS.run() call over all of their wall time."""


def read(ctx):
    wall = sum(r["wall_s"] for r in ctx.runs)
    return sum(r["work"] for r in ctx.runs) / wall if wall > 0 else None
