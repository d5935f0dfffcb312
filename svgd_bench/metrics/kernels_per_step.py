"""Device operations launched a step (all of them, graph replays
included), on rank 0's card."""


def read(ctx):
    return sum(c for _, _, c in ctx.trace.kernels) / ctx.steps
