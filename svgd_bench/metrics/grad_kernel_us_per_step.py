"""Device microseconds a step of the port's gradient kernels (the layer
"gradients": the data products, nn_grad, the glm and logistic stages)."""


def read(ctx):
    s = ctx.layer_s.get("gradients")
    return None if s is None else s / ctx.steps * 1e6
