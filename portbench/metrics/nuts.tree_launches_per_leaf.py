"""nuts.tree_launches_per_leaf (launches/leaf, device trace): launch calls
(harness/layers.py) in the program's "SamplerNUTS.leaf" spans less those in
"LogPosterior.value_and_grad", over the leaves of the traced runs: the
leapfrog arithmetic and the tree's per-leaf updates (sampler/nuts.py)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_leaf(ctx, "SamplerNUTS.leaf", exclude=("LogPosterior.value_and_grad",))
