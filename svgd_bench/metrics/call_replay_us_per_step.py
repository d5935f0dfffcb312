"""Device us a step from just before the first graph replay to the call's
end (span svgd.replays: the first launch's idle, the replays, the aux
copy-outs and the clone), on rank 0."""

from svgd_bench import spans


def read(ctx):
    return spans.per_step(ctx, "svgd.replays", "device_s")
