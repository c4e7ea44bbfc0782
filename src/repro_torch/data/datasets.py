"""SOSD-style key datasets (paper Section 5.1), synthesized to match the
published distribution shapes since the benchmark files are not available
offline:

  fb     — Facebook user ids: heavy-tailed cluster mixture over a 2^45 space
           (ids allocated in bursts => locally dense, globally sparse).
  wikits — Wikipedia request timestamps: near-linear increments with
           bursty (Poisson-mixture) inter-arrival times.
  logn   — lognormal(0, sigma) scaled to int64, the paper's heavy-tail set.

All generators are deterministic per (name, n, seed) and return unique sorted
int64 keys < 2^52 (exactly representable in float64 during spline fitting).
"""
from __future__ import annotations

import numpy as np

_MAX_KEY = 1 << 52


def _unique_pad(keys: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    keys = np.unique(keys)
    while len(keys) < n:
        extra = rng.integers(0, _MAX_KEY, size=2 * (n - len(keys)))
        keys = np.unique(np.concatenate([keys, extra]))
    return np.sort(keys[:n]).astype(np.int64)


def make_fb(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_clusters = max(64, n // 4096)
    centers = np.sort(rng.integers(0, _MAX_KEY, n_clusters))
    sizes = rng.pareto(1.2, n_clusters) + 1
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 1)
    offs = rng.integers(0, 1 << 24, size=int(sizes.sum()))
    reps = np.repeat(centers, sizes)
    return _unique_pad(reps + offs[: len(reps)], n, rng)


def make_wikits(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # bursty inter-arrivals: exponential mixture (quiet / busy periods)
    busy = rng.random(n) < 0.3
    gaps = np.where(
        busy,
        rng.exponential(2.0, n),
        rng.exponential(50.0, n),
    ).astype(np.int64) + 1
    keys = np.cumsum(gaps) + 1_500_000_000
    return _unique_pad(keys, n, rng)


def make_logn(n: int, seed: int = 0, sigma: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, sigma, 2 * n)
    scaled = (x / x.max() * (_MAX_KEY - 1)).astype(np.int64)
    return _unique_pad(scaled, n, rng)


def make_uniform(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _unique_pad(rng.integers(0, _MAX_KEY, 2 * n), n, rng)


DATASETS = {
    "fb": make_fb,
    "wikits": make_wikits,
    "logn": make_logn,
    "uniform": make_uniform,
}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    return DATASETS[name](n, seed)
