"""Profiling hooks with ``torch.profiler``.

PyTorch counterpart of ``stein_tpu/utils/profiling.py``: named spans around
step regions, and a one-call trace capture around a block of steps."""

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir):
    """Capture a host and device trace of everything inside the block and
    write it to ``log_dir/trace.json`` (Chrome trace format: view it with
    Perfetto or chrome://tracing):

        with profiling.trace("svgd-trace"):
            for _ in range(20):
                sampler.train_on_batch(batch)

    The CUDA activity is recorded when a card is present. Yields the
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
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name):
    """Named span context (``torch.profiler.record_function``): shows as a
    labelled range in a trace."""
    return record_function(name)
