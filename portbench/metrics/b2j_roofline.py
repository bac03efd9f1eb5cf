"""b2j_roofline (%, device trace): kernel B2J's share of its roofline over
the traced window (roofline/b2j.py)."""


def read(ctx):
    return ctx.roofline("b2j")
