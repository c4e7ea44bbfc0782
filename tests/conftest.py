"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only launch/dryrun.py forces the 512-device placeholder mesh."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_keys(n: int, seed: int = 0, hi: int = 1 << 48) -> np.ndarray:
    r = np.random.default_rng(seed)
    keys = np.unique(r.integers(0, hi, int(n * 1.2)).astype(np.int64))
    while len(keys) < n:
        keys = np.unique(
            np.concatenate([keys, r.integers(0, hi, n).astype(np.int64)])
        )
    return keys[:n]
