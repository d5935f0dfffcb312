"""The yardstick of the rooflines: the H100's published peaks and the
operations and bytes an SVGD step needs, counted once from the cell's
shapes, whatever kernels or routes the program runs them by. A model
kind's gradient operations are counted in its own file under kinds/."""

# NVIDIA H100 SXM, dense: TF32 tensor-core rate and HBM3 bandwidth (the
# data sheet's figures at 700 W). No float32-class route exceeds the TF32
# rate; a 3xTF32 route tops out at a third of it.
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def phi_ops(rows, n, p):
    """phi for ``rows`` particles against all ``n``: the pairwise Gram and
    K @ u (2 rows n p each), D, K and its row sums (6 a pair), u = grads -
    theta / h^2 (2 n p) and the rows' combine (3 rows p)."""
    return 4 * rows * n * p + 6 * rows * n + 2 * n * p + 3 * rows * p


def phi_bytes(rows, n, p, itemsize=4):
    """theta and the gradients read once, phi written once."""
    return (2 * n * p + rows * p) * itemsize


def median_ops(rows, n, p):
    """The median block's Gram and D: ``rows`` sampled rows against all
    ``n`` particles."""
    return 2 * rows * n * p + 3 * rows * n


def roofline_s(ops, nbytes):
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
