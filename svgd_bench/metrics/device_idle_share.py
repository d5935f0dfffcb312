"""The traced window's share, in %, in which nothing ran on rank 0's
card: 100 (1 - union of device activity / window)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
