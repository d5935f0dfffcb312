"""Device microseconds a step of the kernel that forms D for phi on the
tile's wide route (phi_gram_kernel, csrc/svgd_wide.cu), read from the
trace's kernels by its own name; None where the program has no such
kernel."""

import re

PATTERN = re.compile(r"\bphi_gram_kernel\b")


def read(ctx):
    s = sum(sec for name, sec, _ in ctx.trace.kernels if PATTERN.search(name))
    return s / ctx.steps * 1e6 if s else None
