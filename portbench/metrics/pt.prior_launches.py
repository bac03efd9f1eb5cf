"""pt.prior_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.prior" spans inside
"SamplerPT.sampling" (the start search's evaluations left out), over the
iterations of the traced runs: the log-prior (model/prior.py)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.prior")
