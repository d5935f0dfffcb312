"""Device us a step of the per-call cold seed (span svgd.seed: the call's
entry to the seed's last kernel), on rank 0."""

from svgd_bench import spans


def read(ctx):
    return spans.per_step(ctx, "svgd.seed", "device_s")
