"""pt.likelihood_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.likelihood" spans inside
"SamplerPT.sampling" (the start search's evaluations left out), over the
iterations of the traced runs: the log-likelihood (likelihoods/poppk.py
and its kernels; the benchmark's boundary adds one copy every 16th call)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.likelihood")
