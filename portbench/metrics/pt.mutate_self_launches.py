"""pt.mutate_self_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.mutate" spans inside
"SamplerPT.sampling" less those in its children "SamplerPT.propose",
"SamplerPT.prior" and "SamplerPT.likelihood", over the iterations of the
traced runs: the MH test, acceptance, bookkeeping, the evaluation's NaN
masks and casts, and the history add (SamplerPT._mutate)."""

from portbench.harness import layers

CHILDREN = ("SamplerPT.propose", "SamplerPT.prior", "SamplerPT.likelihood")


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.mutate", exclude=CHILDREN)
