"""The windows' arithmetic, apart from the card so that tests can drive it
on a fake clock.

A window starts when the driver starts the entry point and ends at the
first whole unit of work (a delivered batch, a finished step) at or after
``seconds``; a rate is the work of all units over all of that time, so a
stall inside the window lowers it. An open loop's latency is taken from a
request's due time on the schedule, and a request that fails or is not
delivered counts as missing: no latency limit is met by it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Sequence


def batch_window(batches: Iterable, seconds: float,
                 clock: Callable[[], float] = time.perf_counter,
                 on_batch: Callable = None) -> Dict[str, float]:
    """Consume delivered batches (anything with a length) until the first
    delivery at or after ``seconds``. Returns the units delivered, the
    batches and the seconds from the start to the last delivery."""
    t0 = clock()
    units = count = 0
    t_last = t0
    for b in batches:
        t_last = clock()
        units += len(b)
        count += 1
        if on_batch is not None:
            on_batch(b)
        if t_last - t0 >= seconds:
            break
    return {"units": units, "batches": count, "elapsed": t_last - t0}


def step_window(step: Callable[[], object], seconds: float,
                clock: Callable[[], float] = time.perf_counter
                ) -> Dict[str, float]:
    """Run ``step`` (which returns once its step is finished on the
    device) until the first step boundary at or after ``seconds``."""
    t0 = clock()
    steps = 0
    while True:
        step()
        steps += 1
        t = clock()
        if t - t0 >= seconds:
            return {"steps": steps, "elapsed": t - t0}


def rate(units: float, elapsed: float) -> float:
    if elapsed <= 0 or units <= 0:
        raise ValueError(f"no work in the window ({units} in {elapsed} s)")
    return units / elapsed


def percentile_with_missing(latencies: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``latencies``, where a
    missing request is ``math.inf``: it ranks above every delivered one."""
    vals = sorted(latencies)
    if not vals:
        raise ValueError("no requests were due in the window")
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


def open_loop_latencies(due: Sequence[float], done: Dict[int, float],
                        failed: Iterable[int]) -> list:
    """Latency of each request due in the window, from its due time to its
    delivery (``done``: index -> delivery time, on the same clock as
    ``due``); a failed or undelivered request is ``math.inf``."""
    bad = set(failed)
    out = []
    for i, t in enumerate(due):
        d = done.get(i)
        out.append(math.inf if d is None or i in bad else d - t)
    return out
