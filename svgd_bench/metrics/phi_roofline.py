"""phi's share, in %, of the card's roofline: the least time phi's work
could take at the published peaks (flops.py: its operations counted once
from the shapes, or its bytes, whichever bounds) over the phi layer's
device time a step."""


def read(ctx):
    s = ctx.layer_s.get("phi")
    if not s:
        return None
    bound = ctx.flops.roofline_s(ctx.phi_ops, ctx.phi_bytes)
    return 100.0 * bound / (s / ctx.steps)
