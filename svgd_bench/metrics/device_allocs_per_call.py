"""The card's cudaMalloc calls a call (counter device_allocs, the
``num_device_alloc`` delta over each svgd.run span), on rank 0."""

from svgd_bench import spans


def read(ctx):
    return spans.per_call(ctx, "device_allocs")
