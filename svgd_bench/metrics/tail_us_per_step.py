"""Device microseconds a step of the port's step-tail kernels (the layer
"step tail": the clip and optimizer update, the epilogue)."""


def read(ctx):
    s = ctx.layer_s.get("tail")
    return None if s is None else s / ctx.steps * 1e6
