"""The measured window: a closed loop with one client.

Each call is ``sampler.run(batch, k)`` followed by reading the call's last
``phi_norm`` on the host (the monitoring a modeller does between chunks,
which also ends the call). Calls repeat until ``seconds`` have passed; the
window runs from the first call's start to the last call's end.

A few calls are kept for the check, drawn from the seed by reservoir
sampling (every call of the window equally likely, whatever their
number): the state the call started from, the aux of its first steps and
the optimizer's step count it ended with. Keeping them copies nothing:
every call hands back fresh state tensors."""

import dataclasses
import random
import time


@dataclasses.dataclass
class Call:
    before: object        # the SVGDState the call started from
    aux: dict             # {name: [follow] tensor}, the first steps' aux
    count_after: object   # the optimizer's step count after the call


def keep_call(before, aux, after, follow):
    return Call(before, {k: v[:follow] for k, v in aux.items()},
                after.opt_state.count)


def closed_loop(sampler, batch, k, seconds, seed, follow, keep,
                agree=None):
    """Run the window. ``agree(done) -> done`` makes every rank of a mesh
    take rank 0's decision to stop. Returns (calls, seconds, kept)."""
    rng = random.Random(int(seed) * 2 + 1)
    kept = []
    calls = 0
    t0 = time.perf_counter()
    while True:
        before = sampler.state
        aux = sampler.run(batch, k)
        aux["phi_norm"][-1].item()
        t_end = time.perf_counter()
        slot = calls if calls < keep else rng.randrange(calls + 1)
        if slot < keep:
            call = keep_call(before, aux, sampler.state, follow)
            if slot < len(kept):
                kept[slot] = call
            else:
                kept.append(call)
        calls += 1
        done = t_end - t0 >= seconds
        if agree is not None:
            done = agree(done)
        if done:
            return calls, t_end - t0, kept
