"""Device microseconds a step of the port's median kernels (the layer
"median": the median kernel, the warm search, the distance block, the
bracket pass, the bin count)."""


def read(ctx):
    s = ctx.layer_s.get("median")
    return None if s is None else s / ctx.steps * 1e6
