"""setup_s (s, host clock): process start to the window's start: torch and
the CUDA context, the kernel library (built on a checkout's first run),
the inputs, the model, the set-up run of the sampler; less the time the
driver spent on the reference (its `reference_s`: NUTS's start
selection)."""


def read(ctx):
    return ctx.setup_s
