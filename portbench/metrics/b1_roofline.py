"""b1_roofline (%, device trace): kernel B1's share of its roofline over
the traced window (roofline/b1.py)."""


def read(ctx):
    return ctx.roofline("b1")
