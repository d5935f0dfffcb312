"""Host us a step blocked in the mesh's capture-flag psum and its read
(span svgd.agree): rank 0's wait on the slowest rank. None on one rank."""

from svgd_bench import spans


def read(ctx):
    return spans.per_step(ctx, "svgd.agree", "host_s")
