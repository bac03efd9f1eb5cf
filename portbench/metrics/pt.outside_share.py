"""pt.outside_share (%, program span): the share of the window's wall that
run() spends outside its iterations (the start-position search, the
emission's drain, the result's assembly): sum of elapsed_seconds -
sampling_seconds over the runs' wall: in a traced run, the window's
untraced runs."""


def read(ctx):
    wall = sum(r["wall_s"] for r in ctx.runs)
    outside = sum(r["elapsed_seconds"] - r["sampling_seconds"] for r in ctx.runs)
    return 100.0 * outside / wall if wall > 0 else None
