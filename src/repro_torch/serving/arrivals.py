"""Arrival processes for serving experiments.

All generators are deterministic under a seed and return absolute arrival
times (seconds) sorted ascending — the currency of the discrete-event
scheduler and of offered-load sweeps. (The port's copy of the JAX
package's module, numpy only.)
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """n arrival times of a Poisson process with `rate` req/s."""
    if rate <= 0:
        return np.full(n, start)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return start + np.cumsum(gaps)


def burst_arrivals(n: int, *, burst_size: int = 4, burst_gap: float = 0.5,
                   jitter: float = 0.0, seed: int = 0,
                   start: float = 0.0) -> np.ndarray:
    """Bursty traffic: groups of `burst_size` back-to-back requests separated
    by `burst_gap` seconds of silence (flash-crowd / retry-storm shape)."""
    rng = np.random.default_rng(seed)
    times = []
    t = start
    for i in range(n):
        if i and i % burst_size == 0:
            t += burst_gap
        times.append(t + (rng.uniform(0, jitter) if jitter > 0 else 0.0))
    return np.sort(np.asarray(times))


def uniform_arrivals(rate: float, n: int, *, start: float = 0.0) -> np.ndarray:
    """Evenly spaced arrivals at `rate` req/s (closed-form offered load)."""
    if rate <= 0:
        return np.full(n, start)
    return start + np.arange(n) / rate


def make_arrivals(kind: str, rate: float, n: int, *, seed: int = 0,
                  burst_size: int = 4) -> np.ndarray:
    if kind == "poisson":
        return poisson_arrivals(rate, n, seed=seed)
    if kind == "burst":
        gap = burst_size / rate if rate > 0 else 0.5
        return burst_arrivals(n, burst_size=burst_size, burst_gap=gap, seed=seed)
    if kind == "uniform":
        return uniform_arrivals(rate, n)
    raise ValueError(f"unknown arrival kind: {kind!r}")
