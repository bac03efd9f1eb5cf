"""pt.draw_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.draw" spans inside
"SamplerPT.sampling", over the iterations of the traced runs: the random
numbers of an iteration (SamplerPT.draw)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.draw")
