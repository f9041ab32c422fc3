"""The one traffic generator. A cell's ``traffic`` object in
``workloads/<cell>.json`` holds its parameters; everything here is a pure
function of those parameters and the run's seed, so the same seed gives
the same schedule, labels and request seeds, and every seed gives the
same amount and shape of work (only which classes, seeds and arrival
times, in another order)."""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & MASK32, (seed >> 32) & MASK32, stream])


def balanced_labels(num: int, num_classes: int, per_class: int,
                    seed: int) -> np.ndarray:
    """The FID protocol's class-balanced schedule (``per_class`` images of
    each class, class by class), started at a class drawn from the seed
    and wrapping round: (num,) int64."""
    start = int(rng(seed, 10).integers(num_classes)) * per_class
    idx = (start + np.arange(num)) % (num_classes * per_class)
    return (idx // per_class).astype(np.int64)


def uniform_labels(num: int, num_classes: int, seed: int) -> np.ndarray:
    return rng(seed, 11).integers(0, num_classes, num).astype(np.int64)


def sample_seed0(seed: int) -> int:
    """The first per-sample seed of a run: sample i is seeded seed0 + i
    (mod 2^32), the FID protocol's ``seed + index``."""
    return seed & MASK32


def request_seeds(num: int, seed: int) -> np.ndarray:
    """One 32-bit seed a request, distinct within the run."""
    return rng(seed, 12).permutation(1 << 24)[:num].astype(np.int64) \
        * 251 + (seed & 0xFF)


def open_loop_arrivals(rate: float, duration: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of an open loop at
    ``rate`` per second over ``duration``: round(rate * duration) arrivals
    whose gaps are the exponential distribution's quantiles at
    (i + 1/2) / n, the gaps of a Poisson process of that rate, in an order
    drawn from the seed. Every seed offers the same arrivals, gaps and
    count in another order, so the seed does not change the load."""
    n = max(1, round(rate * duration))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng(seed, 13).permutation(gaps)
    return np.cumsum(gaps) * (duration * n / (n + 1)) / gaps.sum()
