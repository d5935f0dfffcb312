"""Log-density helpers matching tf.contrib.distributions semantics.

PyTorch counterpart of ``stein_tpu/models/distributions.py`` (the part the
ported models use).
"""

import math


def normal_log_prob(x, loc, scale):
    """log N(x; loc, scale). Matches tf.distributions.Normal.log_prob."""
    z = (x - loc) / scale
    return -0.5 * z * z - math.log(scale) - 0.5 * math.log(2.0 * math.pi)
