"""pt.exchange_launches (launches/iter, device trace): launch calls
(harness/layers.py) in the program's "SamplerPT.exchange" spans inside
"SamplerPT.sampling", over the iterations of the traced runs: the replica
exchange move (SamplerPT._exchange)."""

from portbench.harness import layers


def read(ctx):
    return layers.per_iteration(ctx, "SamplerPT.exchange")
