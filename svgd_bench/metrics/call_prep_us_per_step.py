"""Device us a step from the seed's end to the first replay (span
svgd.prep: the feed, the layout keys, the capture-flag psum, the carry's
copy-in; idle included), on rank 0."""

from svgd_bench import spans


def read(ctx):
    return spans.per_step(ctx, "svgd.prep", "device_s")
