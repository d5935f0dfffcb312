"""Host us a step in the graph replays' launches (span svgd.launch, each
``graph.replay()``), on rank 0."""

from svgd_bench import spans


def read(ctx):
    return spans.per_step(ctx, "svgd.launch", "host_s")
