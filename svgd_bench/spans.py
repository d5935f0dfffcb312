"""The program's own spans and counters, as the span metrics read them.

``stein_tpu_torch.utils.profiling.summary()`` holds every span the port
recorded while a profiler ran, and each ``svgd.run`` call's own record. In
a ``--trace 1`` run, on rank 0, those are the run's one earlier profiled
call and the traced window's calls; the metrics read the window's own: the
latest calls that hold its steps (``ctx.steps``). The earlier call is left
out: on a mesh every rank profiles it, and it runs slower than the window's
calls, where rank 0 alone does. A port without the recorder (no
``summary``) or a summary without the span reads None, and the metric is
left out of the line."""


def window_calls(ctx):
    """The recorder's latest calls that hold the traced window's steps (all
    of them where they hold fewer); None without the recorder or a call."""
    from stein_tpu_torch.utils import profiling

    read = getattr(profiling, "summary", None)
    if read is None:
        return None
    calls, steps = [], 0
    for call in reversed(read()["calls"]):
        if steps >= ctx.steps:
            break
        calls.append(call)
        steps += call["steps"]
    return calls or None


def per_step(ctx, name, field):
    """``field`` ("device_s" or "host_s") of span ``name`` in us a step of
    the window's calls; None where no call has it."""
    calls = window_calls(ctx)
    if calls is None:
        return None
    values = [c["spans"][name][field] for c in calls
              if name in c["spans"]]
    if not values or None in values:
        return None
    return sum(values) * 1e6 / sum(c["steps"] for c in calls)


def per_call(ctx, key):
    """The window's calls' ``key`` (a count each call records) a call;
    None where a call lacks it."""
    calls = window_calls(ctx)
    if calls is None or any(c[key] is None for c in calls):
        return None
    return sum(c[key] for c in calls) / len(calls)
