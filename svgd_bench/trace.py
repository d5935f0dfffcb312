"""The traced window: torch.profiler over graph replays, reduced to what
the per-layer metrics read.

- kernels: every device operation's name, device seconds and launches;
- layers: each kernel's layer by the pattern files ``layers/<slug>.*.json``
  (``{"layer": words, "patterns": [regex, ...]}``; every file of a slug is
  merged, so a later kernel adds a file). A kernel no file matches is named
  on standard error with its time and counted in no layer;
- busy: the union of device activity inside the window;
- idle gaps: the stretches inside the window with nothing on the device,
  named by the innermost host operation that spans them ("python" where no
  recorded operation does)."""

import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "svgd_bench.window"


def layer_patterns(bench_dir):
    """{slug: (layer words, [compiled patterns])}, every file of a slug
    merged, in file-name order."""
    out = {}
    for path in sorted((Path(bench_dir) / "layers").glob("*.json")):
        slug = path.name.split(".", 1)[0]
        spec = json.loads(path.read_text())
        words, pats = out.setdefault(slug, (spec["layer"], []))
        pats.extend(re.compile(p) for p in spec["patterns"])
    return out


def classify(kernels, patterns):
    """({slug: device seconds}, {slug: launches}, [(name, seconds)] of the
    kernels no layer claims). A kernel is the first claiming slug's, in
    slug order."""
    secs, counts, unmatched = defaultdict(float), defaultdict(int), []
    for name, s, count in kernels:
        for slug in sorted(patterns):
            if any(p.search(name) for p in patterns[slug][1]):
                secs[slug] += s
                counts[slug] += count
                break
        else:
            unmatched.append((name, s))
    return dict(secs), dict(counts), unmatched


class Trace:
    """One profiled window's reduction."""

    def __init__(self, events, steps):
        self.steps = steps
        from torch.autograd import DeviceType

        win = [e for e in events if e.name == WINDOW
               and e.device_type == DeviceType.CPU]
        if not win:
            raise RuntimeError("svgd_bench: the traced window has no "
                               "marker event")
        t0, t1 = win[0].time_range.start, win[0].time_range.end
        self.window_s = (t1 - t0) * 1e-6
        dev, host = [], []
        agg = defaultdict(lambda: [0.0, 0])
        for e in events:
            s, f = e.time_range.start, e.time_range.end
            if e.name == WINDOW or getattr(e, "is_user_annotation", False):
                continue    # ranges the host marked, not device work
            if e.device_type == DeviceType.CUDA:
                if f <= t0 or s >= t1:
                    continue
                dev.append((max(s, t0), min(f, t1)))
                a = agg[e.name]
                a[0] += (f - s) * 1e-6
                a[1] += 1
            elif f > t0 and s < t1:
                host.append((s, f, e.name))
        self.kernels = sorted(((k, v[0], v[1]) for k, v in agg.items()),
                              key=lambda r: -r[1])
        merged = []
        for s, f in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], f)
            else:
                merged.append([s, f])
        self.busy_s = sum(f - s for s, f in merged) * 1e-6
        gaps = []
        edge = t0
        for s, f in merged + [[t1, t1]]:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, f)
        self.idle = self._name_gaps(gaps, host)

    NAMED_GAPS = 500

    @classmethod
    def _name_gaps(cls, gaps, host):
        """{host op name: idle device seconds}: each of the longest
        NAMED_GAPS gaps goes to the shortest host operation that spans its
        middle; the rest are summed as "shorter gaps"."""
        import numpy as np

        out = defaultdict(float)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])
        for s, f in gaps[cls.NAMED_GAPS:]:
            out["shorter gaps"] += (f - s) * 1e-6
        starts = np.array([h[0] for h in host], dtype=np.float64)
        ends = np.array([h[1] for h in host], dtype=np.float64)
        for s, f in gaps[:cls.NAMED_GAPS]:
            mid = 0.5 * (s + f)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = ("python" if hit.size == 0 else
                    host[hit[np.argmin(ends[hit] - starts[hit])]][2])
            out[name] += (f - s) * 1e-6
        return dict(out)

    def breakdown(self):
        top = lambda pairs: [[n[:160], s] for n, s in sorted(
            pairs, key=lambda r: -r[1])[:10]]
        return {"device_ops": top([(k, s) for k, s, _ in self.kernels]),
                "idle_gaps": top(self.idle.items())}


def profile(run_window):
    """Profile ``run_window()`` (which returns the steps it ran) inside
    the window marker. Returns a Trace."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            steps = run_window()
            torch.cuda.synchronize()
    t = time.perf_counter()
    out = Trace(prof.events(), steps)
    print(f"svgd_bench: trace read in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    return out
