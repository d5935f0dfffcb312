"""The comparison that decides ``correct``.

The cells' recipe (Adam at learning rate 0.1 on a posterior a few
hundredths wide) is chaotic: two float32 runs of the same step part by
the end of a call, whatever the arithmetic. So the reference follows the
program step by step from the program's own state: from the particles and
optimizer state a checked call started from (for the run's first call,
from the seed's particles and a fresh optimizer), FOLLOW steps, each step
with the bandwidth the program's median gives, once that median has been
judged. What it compares, the worst over every followed step of every
checked call:

- ``median_gap``: the program's median against the k-th smallest entry of
  the reference's distance block (k = ceil(total / 2)), in halves of the
  final interval of the search the program runs (the bracket the previous
  median selects, split 2^warm_passes ways): the search's result is the
  middle of an interval that holds that entry, so a sound run reads at
  most 1 plus the program's rounding of D;
- ``phi_norm_gap``: the gap of phi's norm before the clip (the
  gradients, the kernel sums and phi, at the program's bandwidth), in
  units of the norms of the two terms phi sums, K grads / n and the
  repulsion: as the particles settle the terms cancel, and a float32 phi
  is then only as exact as the terms are large;
- ``logp_gap``: the relative gap of the mean log p (the gradient stage's
  forward);
- ``steps_gap``: steps the call's optimizer state counts, less those
  asked for (exact).

The first step of a call is judged on the program's state itself; the
next ones on the reference's own steps from it, through the clip and the
optimizer. Every number is read in float64 (``dtype``); the control runs
the same code in float32 with TF32 matmuls in the program's place."""

import math

import torch

from svgd_bench.reference import svgd as ref

FOLLOW = 3   # steps followed from the start of each checked call
KEEP = 4     # window calls checked besides the run's first


def median_rows(n, max_rows, ranks=1):
    """The rows of the median's block: every ``n // max_rows``-th particle
    on one card; on a mesh each rank's strided share of ``max_rows``
    (``max_rows // ranks`` rows a rank, strided over its block)."""
    if ranks == 1:
        idx = ref.strided_rows(n, max_rows)
        return torch.arange(n) if idx is None else idx
    n_loc = n // ranks
    m = max(min(max_rows // ranks, n_loc), 1)
    stride = max(n_loc // m, 1)
    return torch.cat([r * n_loc + torch.arange(m) * stride
                      for r in range(ranks)])


def _worse(gaps, name, value):
    """Keep the worse reading; a NaN is the worst."""
    value = float(value)
    if not value <= gaps[name]:
        gaps[name] = value


class Judge:
    """Follows checked calls with the plain reference and reads the
    numbers. ``search`` is "quad" or "grid" (the mesh's two-collective
    search); both end on an interval 2^warm_passes times narrower than
    their bracket for an even ``warm_passes``."""

    def __init__(self, grad_fn, gd, n, k, rows, max_rows_passes,
                 search="quad", dtype=torch.float64):
        self.grad_fn, self.gd, self.n, self.k = grad_fn, gd, n, k
        self.rows = rows
        self.median_passes, self.warm_passes = max_rows_passes
        self.search, self.dtype = search, dtype

    def _final_width(self, D, hint):
        total = D.numel()
        kk = (total + 1) // 2
        lo, hi = min(float(D.min()), 0.0), float(D.max())
        if hint > 0:
            for a, b in ref.BRACKETS:
                if ((D <= a * hint).sum() < kk
                        and (D <= b * hint).sum() >= kk):
                    lo, hi = a * hint, b * hint
                    break
        w = self.warm_passes
        splits = 2 ** w if self.search == "grid" else 4 ** ((w + 1) // 2)
        return (hi - lo) / splits

    def follow(self, call, gaps):
        """Follow one call; fold its gaps into ``gaps``."""
        theta = call["theta"].to(self.dtype)
        opt = {"mu": call["mu"].to(self.dtype),
               "nu": call["nu"].to(self.dtype),
               "count": call["count"], "lr": call["lr"]}
        hint = ref.search_median(ref.median_block(theta, self.rows), 0.0,
                                 self.median_passes)
        for i in range(len(call["median"])):
            D = ref.median_block(theta, self.rows)
            flat = D.reshape(-1)
            x_k = float(torch.kthvalue(flat.cpu(), (flat.numel() + 1) // 2)
                        .values)
            med = call["median"][i]
            half = 0.5 * self._final_width(D, hint)
            _worse(gaps, "median_gap", abs(med - x_k) / max(half, 1e-300))
            log_p, grads = self.grad_fn(theta)
            h2 = med / math.log(self.n)
            drive, rep = ref.phi_parts(theta, grads, h2)
            ph = drive + rep
            norm = float(torch.sqrt((ph * ph).sum()))
            terms = float(drive.norm() + rep.norm())
            lp = float(log_p.mean())
            _worse(gaps, "phi_norm_gap", abs(call["phi_norm"][i] - norm)
                   / max(terms, 1e-300))
            _worse(gaps, "logp_gap", abs(call["log_p_mean"][i] - lp)
                   / max(abs(lp), 1e-300))
            c = 10.0
            delta, opt = self.gd.update(opt, ph * (c / max(c, norm)))
            theta = theta + delta
            hint = med
        _worse(gaps, "steps_gap", abs(call["steps_done"] - self.k))

    def readings(self, calls):
        gaps = dict.fromkeys(
            ("median_gap", "phi_norm_gap", "logp_gap", "steps_gap"), 0.0)
        for call in calls:
            self.follow(call, gaps)
        return gaps


def _setting(cell, kw, n):
    """(median rows, (cold passes, warm passes), search kind) of a cell."""
    rows = median_rows(n, kw["median_max_rows"], cell.chips)
    search = ("grid" if cell.chips > 1
              and kw.get("median_collectives") == "grid" else "quad")
    return rows, (kw["median_passes"], kw["warm_passes"]), search


def read_calls(cell, prob, records, kw, n):
    """The float64 reference's readings of each record, one dict a call."""
    dtype = torch.float64
    data = {key: v.to(dtype) for key, v in prob.data.items()}
    rows, passes, search = _setting(cell, kw, n)
    j = Judge(prob.kind.reference(cell.config, data),
              ref.optimizer(cell.config["optimizer"]), n,
              int(cell.traffic["k"]), rows, passes, search, dtype)
    with ref.matmul_precision(False):
        return [j.readings([r]) for r in records]


def control_records(cell, prob, records, kw, n):
    """The control: the reference in float32 with TF32 matmuls put in the
    program's place, from each record's state, its own medians and all."""
    data = {key: v.float() for key, v in prob.data.items()}
    rows, passes, _ = _setting(cell, kw, n)
    out = []
    with ref.matmul_precision(True):
        s = ref.Sampler(prob.kind.reference(cell.config, data),
                        ref.optimizer(cell.config["optimizer"]), rows=rows,
                        median_passes=passes[0], warm_passes=passes[1])
        for call in records:
            opt = {"mu": call["mu"].float(), "nu": call["nu"].float(),
                   "count": call["count"], "lr": call["lr"]}
            _, _, aux = s.steps(call["theta"].float(), opt,
                                len(call["median"]))
            out.append(dict(call, steps_done=int(cell.traffic["k"]), **{
                name: aux[name] for name in ("median", "phi_norm",
                                             "log_p_mean")}))
    return out


def verdict(readings, limits):
    """(correct, [(name, reading, limit)]) for every limit."""
    rows = [(name, readings[name], limits[name]) for name in sorted(limits)]
    return all(r <= lim for _, r, lim in rows), rows
