"""Profiling hooks with ``torch.profiler``, and the program's spans.

PyTorch counterpart of ``stein_tpu/utils/profiling.py``: named spans around
step regions (``annotate``), and a one-call trace capture around a block of
steps (``trace``).

The spans are on exactly while a ``torch.profiler`` session runs
(``trace``, or any profiler a caller starts): there is no other switch.
Off, ``annotate`` returns one shared no-op context and records nothing (no
``record_function``, no CUDA event, no ``memory_stats`` read). On, a span

- emits ``record_function(name)``: a labelled range in the profiler's
  trace, on its clock, beside the kernels;
- times itself on the host (``perf_counter_ns``) and keeps the span that
  encloses it (its cause) and the id of the ``svgd.run`` call it lies in;
- given a CUDA ``device``, records a timing event on the device's current
  stream at each edge, except while that stream is capturing a graph.

Each span name aggregates in the process: its count, steps, host seconds,
host self seconds (its duration less its children's) and device seconds
(end event less start event, resolved once both have completed, at the
end of each outermost span, so the pending events stay few over a long
profile). Each ``svgd.run`` call also keeps its own record (its steps, its
spans' host and device seconds, its allocations), the latest ``CALLS`` of
them. ``summary()`` reads both, with the program's counters, after one
synchronize; ``reset()`` clears them.

The sampler's per-call spans (``SVGDSampler._steps``,
``utils/graphs.py``): ``svgd.run`` (a call, its steps), ``svgd.seed`` (the
warm median's cold seed), ``svgd.prep`` (up to the first replay: the feed,
the layout keys, ``svgd.agree``, ``svgd.capture``, the carry's copy-in),
``svgd.agree`` (the mesh's capture-flag psum, read on the host),
``svgd.capture``, ``svgd.replays`` (from the first replay to the call's
end) and ``svgd.launch`` (each graph replay). The step functions' stages,
``svgd.grad``, ``svgd.median``, ``svgd.phi`` and ``svgd.update``, take no
device: they cost nothing in a replay and are legal inside a capture.
Inside ``svgd.phi`` the streaming tile's wide route (``ops/svgd_tile.py``)
records ``svgd.phi.gram`` (D formed once) and ``svgd.phi.contract`` (K @ u
and the reduce), which take the device: timed by events in an eager call,
none while a capture records them."""

import collections
import contextlib
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

RUN = "svgd.run"
# The svgd.run calls whose own records summary() keeps, the latest.
CALLS = 4096


@contextlib.contextmanager
def trace(log_dir):
    """Capture a host and device trace of everything inside the block and
    write it to ``log_dir/trace.json`` (Chrome trace format: view it with
    Perfetto or chrome://tracing):

        with profiling.trace("svgd-trace"):
            for _ in range(20):
                sampler.train_on_batch(batch)

    In a process group of more than one rank each rank writes its own
    ``log_dir/trace.rank<r>.json``. The CUDA activity is recorded when a
    card is present; the spans are on inside the block. Yields the
    ``torch.profiler.profile`` object (``key_averages()`` and so on)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, _trace_name()))


def _trace_name():
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return f"trace.rank{dist.get_rank()}.json"
    return "trace.json"


# The one context ``annotate`` returns with the spans off.
_OFF = contextlib.nullcontext()


def annotate(name, device=None, steps=0):
    """Named span context: a labelled range in a trace, and a span of the
    recorder while a profiler runs (see the module's docstring). A CUDA
    ``device`` adds device time by events on its current stream;
    ``steps`` adds to the name's step count."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name, device, steps)


class _Stat:
    __slots__ = ("count", "steps", "host_ns", "self_ns", "device_ms",
                 "timed", "parents", "calls", "last_call")

    def __init__(self):
        self.count = self.steps = self.host_ns = self.self_ns = 0
        self.device_ms = 0.0
        self.timed = self.calls = 0
        self.parents = collections.Counter()
        self.last_call = None


class _Recorder:
    """The process's span aggregate (the profiler, which switches it, is
    per process too); spans nest per thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self):
        with self.lock:
            self.stats = collections.defaultdict(_Stat)
            # (stat, the call's entry or None, start, end) event pairs
            self.pending = collections.deque()
            self.spare = []                      # resolved events, reused
            self.device_allocs = None
            self.last_call = 0
            self.calls = collections.deque(maxlen=CALLS)

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self, device):
        """A timing event recorded on ``device``'s current stream, or None
        off a card or while the stream captures."""
        if device is None or device.type != "cuda" or \
                torch.cuda.is_current_stream_capturing():
            return None
        with self.lock:
            ev = self.spare.pop() if self.spare else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def add(self, span, host_ns, start, end, allocs):
        with self.lock:
            st = self.stats[span.name]
            st.count += 1
            st.steps += span.steps
            st.host_ns += host_ns
            st.self_ns += host_ns - span.child_ns
            st.parents[span.parent.name if span.parent else None] += 1
            if span.call != st.last_call:
                st.calls += 1
                st.last_call = span.call
            entry = None
            if span.record is not None:
                entry = span.record["spans"].setdefault(
                    span.name, {"count": 0, "host_s": 0.0, "device_s": None})
                entry["count"] += 1
                entry["host_s"] += host_ns * 1e-9
            if allocs is not None:
                self.device_allocs = (self.device_allocs or 0) + allocs
                span.record["device_allocs"] = allocs
            if span.name == RUN:
                self.calls.append(span.record)
            if start is not None:
                if end is None:
                    self.spare.append(start)
                else:
                    self.pending.append((st, entry, start, end))
            if span.parent is None or len(self.pending) > 256:
                self._resolve(wait=False)   # off the call's inner edges

    def _resolve(self, wait):
        """Fold completed event pairs, oldest first (lock held)."""
        while self.pending:
            st, entry, start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            ms = start.elapsed_time(end)
            st.device_ms += ms
            st.timed += 1
            if entry is not None:
                entry["device_s"] = (entry["device_s"] or 0.0) + ms * 1e-3
            self.spare += (start, end)

    def summary(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self.lock:
            self._resolve(wait=True)
            spans = {
                name: {"count": st.count, "steps": st.steps,
                       "host_s": st.host_ns * 1e-9,
                       "self_s": st.self_ns * 1e-9,
                       "device_s": (st.device_ms * 1e-3 if st.timed
                                    else None),
                       "timed": st.timed, "calls": st.calls,
                       "parents": dict(st.parents)}
                for name, st in self.stats.items()}
            calls = [dict(c, spans={k: dict(v) for k, v in c["spans"].items()})
                     for c in self.calls]
            allocs = self.device_allocs
        return spans, calls, allocs


_RECORDER = _Recorder()


def _device_allocs(device):
    """The caching allocator's cudaMalloc calls so far (the nested form:
    ``memory_stats`` flattens every other statistic too)."""
    return torch.cuda.memory_stats_as_nested_dict(device).get(
        "num_device_alloc", 0)


class _Span:
    __slots__ = ("name", "device", "steps", "parent", "call", "record",
                 "child_ns", "_rf", "_start", "_allocs", "_t0")

    def __init__(self, name, device, steps):
        self.name, self.device, self.steps = name, device, steps

    def __enter__(self):
        rec = _RECORDER
        stack = rec.stack()
        self.parent = stack[-1] if stack else None
        if self.name == RUN:
            with rec.lock:
                rec.last_call += 1
                self.call = rec.last_call
            self.record = {"call": self.call, "steps": self.steps,
                           "spans": {}, "device_allocs": None}
        else:
            self.call = self.parent.call if self.parent else None
            self.record = self.parent.record if self.parent else None
        self.child_ns = 0
        self._allocs = (_device_allocs(self.device)
                        if self.name == RUN and self.device is not None
                        and self.device.type == "cuda" else None)
        # A nested span's events bracket its record_function, an outermost
        # span's lie inside its own: a parent's device time is then its
        # children's and the short host gaps between them, with no span's
        # record_function (the profiler's costliest part) in a gap.
        nested = self.parent is not None
        if nested:
            self._start = rec.event(self.device)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        if not nested:
            self._start = rec.event(self.device)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self._t0
        rec = _RECORDER
        stack = rec.stack()
        if self in stack:   # spans an exception left open end here too
            del stack[stack.index(self):]
        timed = self._start is not None
        end = rec.event(self.device) if timed and not self.parent else None
        self._rf.__exit__(*exc)
        if timed and self.parent:
            end = rec.event(self.device)
        allocs = (_device_allocs(self.device) - self._allocs
                  if self._allocs is not None and end is not None else None)
        if self.parent is not None:
            self.parent.child_ns += host_ns
        rec.add(self, host_ns, self._start, end, allocs)
        return False


def summary():
    """The spans recorded since the last ``reset()`` and the program's
    counters, after one synchronize:

        {"spans": {name: {"count", "steps", "host_s", "self_s",
                          "device_s" (None without device events), "timed"
                          (the event pairs in device_s), "calls" (the
                          svgd.run calls it lay in), "parents" ({enclosing
                          span's name or None: count})}},
         "calls": [{"call": id, "steps", "spans": {name: {"count",
                    "host_s", "device_s"}}, "device_allocs"}, ...] (the
                  latest CALLS svgd.run calls, oldest first),
         "counters": {"device_allocs": cudaMalloc calls over the timed
                      svgd.run spans (None off a card), "captures": every
                      live sampler's graph captures, "launches": the
                      kernel wrappers' launch counts (graphs.read_counts():
                      "B3-wide" the tile's wide route, "B3-wgmma" its
                      wgmma route, both within "B3")}}

    The span names: svgd.run, svgd.seed, svgd.prep, svgd.agree,
    svgd.capture, svgd.replays, svgd.launch; the stages svgd.grad,
    svgd.median, svgd.phi, svgd.update; and in svgd.phi on the tile's wide
    route svgd.phi.gram and svgd.phi.contract."""
    from . import graphs

    spans, calls, allocs = _RECORDER.summary()
    return {"spans": spans, "calls": calls,
            "counters": {"device_allocs": allocs,
                         "captures": sum(g.captures
                                         for g in list(graphs._LIVE)),
                         "launches": graphs.read_counts()}}


def reset():
    """Clear the recorded spans (the program's own counters stay)."""
    _RECORDER.reset()
