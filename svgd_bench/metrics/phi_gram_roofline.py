"""The share, in %, of its roofline that the kernel forming D for phi on
the tile's wide route takes (phi_gram_kernel, csrc/svgd_wide.cu): the
Gram's 2 rows n p operations and D's 3 rows n, or theta's and D's bytes,
whichever bounds (flops.roofline_s), over the kernel's device time a step
in the trace; None where the program has no such kernel."""

import re

PATTERN = re.compile(r"\bphi_gram_kernel\b")


def read(ctx):
    s = sum(sec for name, sec, _ in ctx.trace.kernels if PATTERN.search(name))
    if not s:
        return None
    rows, n, p = ctx.rows, ctx.n, ctx.p
    ops = 2 * rows * n * p + 3 * rows * n
    nbytes = (n * p + rows * n) * 4
    return 100.0 * ctx.flops.roofline_s(ops, nbytes) / (s / ctx.steps)
