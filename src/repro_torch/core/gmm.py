"""Gaussian mixture over the key domain (port of the bulk-load parts of
``repro/core/gmm.py``).

The bulk load only needs the uniform prior and the host-side mixture CDF
that sizes the Nullifier gaps (Eq. 6). The EM fit arrives with the tuning
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import GMMState

_SQRT2 = float(np.sqrt(2.0))


def init_gmm_uniform(lo: float, hi: float, n_components: int = 4) -> GMMState:
    """Uniform prior over [lo, hi] — the Phase-2 assumption before any update
    has been observed (Section 3.2, Phase 2)."""
    lo, hi = float(lo), float(hi)
    span = max(hi - lo, 1.0)
    centers = lo + (np.arange(n_components) + 0.5) / n_components * span
    stds = np.full(n_components, span / n_components)
    return GMMState(
        weights=torch.full((n_components,), 1.0 / n_components,
                           dtype=torch.float64),
        means=torch.as_tensor(centers, dtype=torch.float64),
        stds=torch.as_tensor(stds, dtype=torch.float64),
    )


def gmm_cdf_np(state: GMMState, x: np.ndarray) -> np.ndarray:
    """Host-side mixture CDF (numpy/scipy): the integral in Eq. 6 between
    two keys is a CDF difference."""
    from scipy.special import erf

    x = np.asarray(x, dtype=np.float64)
    w = state.weights.numpy()
    mu = state.means.numpy()
    sd = state.stds.numpy()
    z = (x[:, None] - mu[None, :]) / (sd[None, :] * _SQRT2)
    return (w[None, :] * 0.5 * (1.0 + erf(z))).sum(axis=1)


def gmm_memory_bytes(state: GMMState) -> int:
    return sum(a.numel() * a.element_size() for a in state)
