"""nuts.syncs_per_leaf (syncs/leaf, program counter): the sampler's host
reads over its batched gradient evaluations in the sampling loops,
host_syncs_per_transition / gradient_evaluations_per_transition summed
over the runs (in a traced run, the window's untraced runs)."""


def read(ctx):
    syncs = sum(r["host_syncs_per_transition"] * r["sampling_transitions"] for r in ctx.runs)
    leaves = sum(r["gradient_evaluations_per_transition"] * r["sampling_transitions"]
                 for r in ctx.runs)
    return syncs / leaves if leaves else None
