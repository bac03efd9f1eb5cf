"""pt.propose_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.propose" spans inside
"SamplerPT.sampling", over the iterations of the traced runs: the scale
update, the block proposal and the new positions (sampler/proposal.py)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.propose")
