"""NCCL kernels' share of rank 0's device time, in %, waits on the other
ranks included (the profiler sees rank 0 only)."""


def read(ctx):
    s = ctx.layer_s.get("nccl")
    total = sum(t for _, t, _ in ctx.trace.kernels)
    return None if s is None or total <= 0 else 100.0 * s / total
