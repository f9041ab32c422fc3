"""The windows' arithmetic on a fake clock: whole batches and steps, the
rate over all the window's time, due-time latency, missing requests."""

import math

import pytest

from benchmark.harness import window


class Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_batch_window_ends_at_first_delivery_past_the_limit():
    clock = Clock([0.0, 1.0, 2.5, 3.9, 4.2, 9.0])
    got = window.batch_window([[0] * 32] * 10, 4.0, clock=clock)
    assert got == {"units": 4 * 32, "batches": 4, "elapsed": 4.2}
    assert window.rate(got["units"], got["elapsed"]) == 128 / 4.2


def test_a_stall_lowers_the_rate():
    steady = window.batch_window([[0]] * 3, 2.5, clock=Clock([0, 1, 2, 3]))
    stalled = window.batch_window([[0]] * 3, 2.5, clock=Clock([0, 1, 2, 6]))
    assert stalled["units"] == steady["units"]
    assert window.rate(stalled["units"], stalled["elapsed"]) \
        < window.rate(steady["units"], steady["elapsed"])


def test_step_window_counts_whole_steps():
    calls = []
    got = window.step_window(lambda: calls.append(1), 2.0,
                             clock=Clock([0.0, 0.8, 1.6, 2.4, 3.2]))
    assert got == {"steps": 3, "elapsed": 2.4} and len(calls) == 3


def test_no_work_is_an_error():
    with pytest.raises(ValueError):
        window.rate(0, 1.0)


def test_latency_from_due_time_and_missing_requests():
    due = [0.0, 0.1, 0.2, 0.3]
    done = {0: 0.5, 1: 0.4, 3: 1.3}
    lat = window.open_loop_latencies(due, done, failed=[1])
    assert lat[0] == 0.5 and lat[3] == pytest.approx(1.0)
    assert math.isinf(lat[1]) and math.isinf(lat[2])
    assert math.isinf(window.percentile_with_missing(lat, 95))
    assert window.percentile_with_missing([1.0] * 19 + [math.inf], 95) == 1.0
    assert math.isinf(window.percentile_with_missing([1.0] * 18 + [math.inf] * 2, 95))
