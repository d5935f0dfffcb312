"""Device microseconds a step of the port's phi kernels (the layer "phi":
the tile, its prep and reduce, svgd_on_d, the symmetric tile)."""


def read(ctx):
    s = ctx.layer_s.get("phi")
    return None if s is None else s / ctx.steps * 1e6
