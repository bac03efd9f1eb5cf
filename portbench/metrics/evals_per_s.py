"""evals_per_s (evals/s, host clock): likelihood evaluations a second of
the window's SamplerPT.run() calls: chains x iterations of every completed
call, counted from the traffic mix, over all of their wall time (start
search, iterations, emission and result included)."""


def read(ctx):
    wall = sum(r["wall_s"] for r in ctx.runs)
    return sum(r["work"] for r in ctx.runs) / wall if wall > 0 else None
