"""The traffic generator: the same seed gives the same schedule, labels,
seeds and arrivals; another seed another order of the same work."""

import numpy as np

from benchmark.harness import traffic


def test_balanced_schedule():
    a = traffic.balanced_labels(5000, 1000, 50, 2 ** 31 + 7)
    assert np.array_equal(a, traffic.balanced_labels(5000, 1000, 50, 2 ** 31 + 7))
    b = traffic.balanced_labels(5000, 1000, 50, 12)
    assert not np.array_equal(a, b)
    for lab in (a, b):
        _, counts = np.unique(lab, return_counts=True)
        assert counts.max() <= 50 and len(counts) in (100, 101)
        assert lab.min() >= 0 and lab.max() < 1000
    whole = traffic.balanced_labels(50000, 1000, 50, 99)
    assert np.array_equal(np.bincount(whole), np.full(1000, 50))


def test_seeds_and_arrivals_repeat():
    s = 3_000_000_001
    assert np.array_equal(traffic.request_seeds(64, s), traffic.request_seeds(64, s))
    assert len(set(traffic.request_seeds(4096, s).tolist())) == 4096
    assert np.array_equal(traffic.uniform_labels(10, 1000, s),
                          traffic.uniform_labels(10, 1000, s))
    t = traffic.open_loop_arrivals(40.0, 30.0, s)
    assert np.array_equal(t, traffic.open_loop_arrivals(40.0, 30.0, s))
    assert np.all(np.diff(t) > 0) and t[-1] < 30.0 and len(t) == 1200
    u = traffic.open_loop_arrivals(40.0, 30.0, 12)
    assert not np.array_equal(t, u)
    gaps = np.diff(np.concatenate([[0.0], t]))
    assert np.allclose(np.sort(gaps), np.sort(np.diff(np.concatenate([[0.0], u]))))
    assert abs(gaps.mean() - 1 / 40.0) < 1e-3
    assert abs(gaps.std() - 1 / 40.0) < 0.1 / 40.0   # exponential: std = mean
    assert traffic.sample_seed0(2 ** 32 + 5) == 5
