"""The plain SVGD step the benchmark judges the port by.

Plain PyTorch, written from the reference semantics (JamesBrofos/Stein, as
``baselines/numpy_svgd.py`` states them) and from the sampler options the
cells run. It imports no module of the port and takes nothing the port has
made: the caller hands it the data and particles the benchmark drew.

- D = |a - b|^2, formed about the particles' mean (the same numbers as
  r + r^T - 2 T T^T in exact arithmetic);
- the bandwidth's median: the exact median of all n^2 entries
  (``median="exact"``), or the sort-free warm search the cells run: a
  strided block of rows, the tightest of three brackets around the
  previous median whose ends straddle the median's rank, then quad-ary
  rounds (``median="bisect"``, ``warm_median=True``); each call seeds the
  carry by the same search with no hint;
- h^2 = median / log(n), K = exp(-D / h^2 / 2),
  phi = (K @ grads + (ksum * theta - K @ theta) / h^2) / n;
- the global-norm clip phi *= c / max(c, ||phi||_F);
- the reference's Adam (first moments phi and phi^2, bias correction
  still applied, the learning rate decayed after every step) or Adagrad.

``dtype`` and ``tf32`` set the arithmetic: float64 judges, and float32
with TF32 matmuls is the control that has to come out as not correct.
"""

import contextvars
import math
from contextlib import contextmanager

import torch

BRACKETS = ((0.92, 1.09), (0.7, 1.4), (0.25, 4.0))
# Above this many entries the search refines one rank by quad-ary rounds;
# at or below it, both middle ranks by halving.
QUAD_MIN_TOTAL = 100_000


_TF32 = contextvars.ContextVar("svgd_bench_tf32", default=False)


@contextmanager
def matmul_precision(tf32):
    """Matmuls in TF32 (``tf32=True``) or in the dtype's own precision.
    TF32 is applied by rounding each float32 operand of ``mm`` to TF32's
    10-bit mantissa (round to nearest, ties away, as the tensor cores'
    conversion does) with float32 accumulation, so it holds for every
    shape, including those the library would run without tensor cores."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    token = _TF32.set(tf32)
    try:
        yield
    finally:
        _TF32.reset(token)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), as float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b):
    """torch.matmul, with TF32 operands inside matmul_precision(True) (an
    operand that autograd follows keeps its gradient)."""
    if _TF32.get() and a.dtype == torch.float32:
        a, b = (x + (to_tf32(x.detach()) - x.detach()) for x in (a, b))
    return torch.matmul(a, b)


def strided_rows(n, max_rows):
    """Rows 0, s, 2s, ... (s = n // max_rows) of the median's block, or
    None when every row is kept."""
    if n <= max_rows:
        return None
    return torch.arange(max_rows) * (n // max_rows)


def sq_dists(rows, cols, center):
    """|rows_i - cols_j|^2, about ``center``."""
    a = rows - center
    b = cols - center
    return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
            - 2.0 * mm(a, b.T))


def _count(D, t):
    return int((D <= t).sum())


def _quad_rounds(D, lo, hi, k, rounds):
    for _ in range(rounds):
        w = 0.25 * (hi - lo)
        below = sum(_count(D, lo + j * w) < k for j in (1, 2, 3))
        lo = lo + below * w
        hi = lo + w
    return 0.5 * (lo + hi)


def _halving(D, lo, hi, passes):
    """Both middle ranks by halving (np.median's midpoint of the two)."""
    total = D.numel()
    ks = ((total + 1) // 2, total // 2 + 1)
    ends = [[lo, hi], [lo, hi]]
    for _ in range(passes):
        for e, k in zip(ends, ks):
            mid = 0.5 * (e[0] + e[1])
            e[1 if _count(D, mid) >= k else 0] = mid
    return 0.5 * (0.5 * sum(ends[0]) + 0.5 * sum(ends[1]))


def search_median(D, med_prev, passes, brackets=BRACKETS):
    """The sort-free median of the block D: with a hint (``med_prev`` >
    0) the tightest bracket of ``brackets`` x med_prev whose end counts
    straddle rank k = ceil(total / 2), else the range [min(D, 0), max(D)];
    then ceil(passes / 2) quad-ary rounds. Without a hint and at or
    below QUAD_MIN_TOTAL entries, ``passes`` halvings of both middle
    ranks."""
    total = D.numel()
    lo, hi = min(float(D.min()), 0.0), float(D.max())
    if med_prev <= 0 and total <= QUAD_MIN_TOTAL:
        return _halving(D, lo, hi, passes)
    k = (total + 1) // 2
    if med_prev > 0:
        for a, b in brackets:
            if (_count(D, a * med_prev) < k
                    and _count(D, b * med_prev) >= k):
                lo, hi = a * med_prev, b * med_prev
                break
    return _quad_rounds(D, lo, hi, k, (passes + 1) // 2)


def exact_median(theta):
    """np.median of all n^2 entries of D."""
    D = sq_dists(theta, theta, theta.mean(0))
    return float(torch.quantile(D.reshape(-1).double().cpu(), 0.5))


def median_block(theta, rows=None):
    """D of the particles ``rows`` (an index tensor; None: all) against
    every particle."""
    r = theta if rows is None else theta[rows.to(theta.device)]
    return sq_dists(r, theta, theta.mean(0))


def phi_parts(theta, grads, h2, block_rows=4096):
    """The SVGD direction's two terms, K formed a block of rows at a time:
    (K @ grads / n, (ksum * theta - K @ theta) / (h^2 n)), about the mean."""
    n, p = theta.shape
    tc = theta - theta.mean(0)
    sq = (tc * tc).sum(1)
    both = torch.cat([grads, tc], dim=1)
    drive, rep = [], []
    for i in range(0, n, block_rows):
        r = tc[i:i + block_rows]
        D = sq[i:i + block_rows, None] + sq[None, :] - 2.0 * mm(r, tc.T)
        K = torch.exp(-D / h2 / 2.0)
        kb = mm(K, both)
        drive.append(kb[:, :p])
        rep.append(K.sum(1, keepdim=True) * r - kb[:, p:])
    return torch.cat(drive) / n, torch.cat(rep) / (h2 * n)


def phi(theta, grads, h2, block_rows=4096):
    """The SVGD direction phi = (K @ grads + dK) / n."""
    drive, rep = phi_parts(theta, grads, h2, block_rows)
    return drive + rep


class Adam:
    """The reference's Adam (adam_gradient_descent.py:41-58)."""

    def __init__(self, learning_rate, decay=1.0, beta_1=0.9, beta_2=0.999):
        self.lr0, self.decay = learning_rate, decay
        self.b1, self.b2 = beta_1, beta_2

    def init(self, theta):
        z = torch.zeros_like(theta)
        return {"mu": z, "nu": z.clone(), "count": 0, "lr": self.lr0}

    def update(self, s, phi_c):
        if s["count"] == 0:
            mu, nu = phi_c, phi_c * phi_c
        else:
            mu = self.b1 * s["mu"] + (1.0 - self.b1) * phi_c
            nu = self.b2 * s["nu"] + (1.0 - self.b2) * phi_c * phi_c
        t = s["count"] + 1
        step = (mu / (1.0 - self.b1 ** t)
                / (1e-8 + torch.sqrt(nu / (1.0 - self.b2 ** t))) * s["lr"])
        return step, {"mu": mu, "nu": nu, "count": t,
                      "lr": s["lr"] * self.decay}


def optimizer(spec):
    """The step rule a configuration's ``optimizer`` entry names."""
    kw = {k: v for k, v in spec.items() if k != "rule"}
    if spec["rule"] != "adam":
        raise ValueError(f"no reference step rule {spec['rule']!r}")
    return Adam(**kw)


class Sampler:
    """Steps of the plain SVGD on one block of particles.

    ``grad_fn(theta) -> (log_p [n], grads [n, p])`` is the model's plain
    gradient on the cell's data; ``median`` is "exact" or "bisect" over
    the block of the particles ``rows`` (None: all); with ``warm=True``
    (bisect only) each call of ``steps`` seeds the carry by the search
    without a hint over ``median_passes``, then every step searches from
    the previous median over ``warm_passes``."""

    def __init__(self, grad_fn, gd, median="bisect", rows=None,
                 median_passes=30, warm_passes=8, warm=True,
                 max_phi_norm=10.0):
        self.grad_fn, self.gd = grad_fn, gd
        self.median, self.rows = median, rows
        self.median_passes, self.warm_passes = median_passes, warm_passes
        self.warm, self.c = warm, max_phi_norm

    def step(self, theta, opt, med_prev):
        """One step: (theta, opt state, aux)."""
        n = theta.shape[0]
        log_p, grads = self.grad_fn(theta)
        if self.median == "exact":
            med = exact_median(theta)
        else:
            med = search_median(median_block(theta, self.rows),
                                med_prev if self.warm else 0.0,
                                self.warm_passes if self.warm
                                else self.median_passes)
        h2 = med / math.log(n)
        ph = phi(theta, grads, h2)
        norm = float(torch.sqrt((ph * ph).sum()))
        delta, opt = self.gd.update(opt, ph * (self.c / max(self.c, norm)))
        aux = {"median": med, "h2": h2, "phi_norm": norm,
               "log_p_mean": float(log_p.mean())}
        return theta + delta, opt, aux

    def steps(self, theta, opt, k):
        """``k`` steps as one call of the sampler's run: (theta, opt,
        {name: [k] list})."""
        med = 0.0
        if self.median == "bisect" and self.warm:
            med = search_median(median_block(theta, self.rows), 0.0,
                                self.median_passes)
        out = {}
        for _ in range(k):
            theta, opt, aux = self.step(theta, opt, med)
            med = aux["median"]
            for key, v in aux.items():
                out.setdefault(key, []).append(v)
        return theta, opt, out
