"""Gaussian mixture over the key domain (port of ``repro/core/gmm.py``,
Section 3.4).

UpLIF learns the incoming-update distribution D_update with a 1-D GMM and
sizes the Nullifier gaps (Eq. 6) from its CDF. The mixture is host-side
state: CPU float64 tensors. The EM fit (``fit_gmm``) runs in plain float64
torch, as the JAX package runs it outside any Pallas kernel; the streaming
forecaster's E-step is the K3 kernel (``repro_torch/kernels/gmm_estep.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import GMMState

_SQRT2 = float(np.sqrt(2.0))
_LOG_SQRT_2PI = float(0.5 * np.log(2.0 * np.pi))
_MIN_STD = 1e-9


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


def _log_prob(state: GMMState, x: torch.Tensor) -> torch.Tensor:
    """(N, K) component log densities."""
    z = (x[:, None] - state.means[None, :]) / state.stds[None, :]
    return (
        torch.log(state.weights)[None, :]
        - 0.5 * z * z
        - torch.log(state.stds)[None, :]
        - _LOG_SQRT_2PI
    )


def e_step(state: GMMState, x: torch.Tensor):
    """Responsibilities (N, K) and per-point log-likelihood (N,)."""
    lp = _log_prob(state, x)
    norm = torch.logsumexp(lp, dim=1, keepdim=True)
    return torch.exp(lp - norm), norm[:, 0]


def _em(state: GMMState, x: torch.Tensor, n_iters: int) -> GMMState:
    for _ in range(n_iters):
        resp, _ = e_step(state, x)
        nk = resp.sum(dim=0) + 1e-12
        means = (resp * x[:, None]).sum(dim=0) / nk
        var = (resp * (x[:, None] - means[None, :]) ** 2).sum(dim=0) / nk
        stds = torch.sqrt(torch.clamp(var, min=_MIN_STD))
        weights = nk / x.shape[0]
        state = GMMState(weights=weights, means=means, stds=stds)
    return state


def fit_gmm(
    keys,
    n_components: int = 4,
    n_iters: int = 25,
    seed: int = 0,
) -> GMMState:
    """Fit D_update from an observed update-key sample (float64 positions in
    key space). k-quantile init keeps EM deterministic and restart-safe."""
    x = torch.as_tensor(keys, dtype=torch.float64)
    qs = torch.quantile(
        x, torch.linspace(0.0, 1.0, n_components + 2, dtype=torch.float64)[1:-1]
    )
    span = torch.clamp(x.max() - x.min(), min=1.0)
    init = GMMState(
        weights=torch.full((n_components,), 1.0 / n_components,
                           dtype=torch.float64),
        means=qs,
        stds=torch.full((n_components,), float(span / (2.0 * n_components)),
                        dtype=torch.float64),
    )
    return _em(init, x, n_iters)


def gmm_pdf(state: GMMState, x) -> torch.Tensor:
    """Mixture density (float64) at each of ``x``."""
    lp = _log_prob(state, torch.as_tensor(x, dtype=torch.float64))
    return torch.exp(torch.logsumexp(lp, dim=1))


def gmm_cdf(state: GMMState, x) -> torch.Tensor:
    """Mixture CDF (float64) — the integral in Eq. 6 between two keys is a
    CDF difference."""
    x = torch.as_tensor(x, dtype=torch.float64)
    z = (x[:, None] - state.means[None, :]) / (state.stds[None, :] * _SQRT2)
    comp = 0.5 * (1.0 + torch.special.erf(z))
    return (state.weights[None, :] * comp).sum(dim=1)


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
