"""nuts.grad_launches_per_leaf (launches/leaf, device trace): launch calls
(harness/layers.py) in the program's "LogPosterior.value_and_grad" spans
inside "SamplerNUTS.leaf" spans, over the leaves of the traced runs
(warm-up and sampling): the gradient target, forward and backward."""

from portbench.harness import layers


def read(ctx):
    return layers.per_leaf(ctx, "LogPosterior.value_and_grad", within="SamplerNUTS.leaf")
