"""b2_roofline (%, device trace): kernel B2's share of its roofline over
the traced window (roofline/b2.py)."""


def read(ctx):
    return ctx.roofline("b2")
