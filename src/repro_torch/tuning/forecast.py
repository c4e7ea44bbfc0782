"""Streaming D_update forecasting (port of ``repro/tuning/forecast.py``,
Section 3.4 online).

The forecaster tracks the insert stream live with a GMM and drives three
decisions: per-shard insert mass (delta-buffer presizing, split
triggers), the current GMM (Eq. 6 gap sizing at a shard retrain) and mass
drift (a distribution-shift signal).

Estimation is stepwise EM over decayed sufficient statistics (Cappé &
Moulines 2009): each observed batch contributes one E-step — the dense
(N, K) responsibilities — followed by a closed-form M-step on the decayed
stats. On a CUDA device the E-step is the K3 kernel
(``repro_torch/kernels/gmm_estep.py``): the keys are mapped to the unit
interval and cast to float32 on the host, K3 runs on the device, and the
responsibilities come back as float64; a kernel failure raises. Elsewhere
the E-step is a float64 numpy pass, as the JAX package runs it off the
TPU. The statistics accumulate in float64 on the raw keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gmm import gmm_cdf_np, init_gmm_uniform
from repro_torch.core.nullifier import gap_sizes
from repro_torch.core.types import GMMState
from repro_torch.kernels import ops
from repro_torch.kernels.ops import native_kernels, resolve_device

_MIN_STD_FRAC = 1e-6   # std floor as a fraction of the key-domain span


@dataclasses.dataclass
class ForecastConfig:
    n_components: int = 4
    decay: float = 0.65       # per-batch geometric decay of the EM stats
    min_obs: int = 256        # observations before the forecast is trusted
    max_batch: int = 8192     # subsample cap per observed batch
    # E-step through the K3 kernel wrapper; None = where the device has
    # native kernels (CUDA). On a CPU device the wrapper runs K3's plain
    # float32 version.
    use_kernel: Optional[bool] = None
    seed: int = 0


class UpdateForecaster:
    """Streaming-EM GMM over observed insert keys."""

    def __init__(
        self,
        lo: float,
        hi: float,
        config: ForecastConfig = ForecastConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        if config.use_kernel is None:
            config = dataclasses.replace(
                config, use_kernel=native_kernels(self.device)
            )
        self.cfg = config
        self.lo = float(lo)
        self.hi = float(hi)
        self.span = max(self.hi - self.lo, 1.0)
        K = config.n_components
        self.gmm: GMMState = init_gmm_uniform(lo, hi, K)
        # decayed sufficient statistics (responsibility-weighted moments)
        self._s0 = np.zeros(K)   # sum of responsibilities
        self._s1 = np.zeros(K)   # sum of resp * x
        self._s2 = np.zeros(K)   # sum of resp * x^2
        self.n_obs = 0
        self.n_batches = 0
        # distribution-shift signal: EWMA of the per-step component-mean
        # movement (span-normalized), the "shift" axis of the workload
        # signature
        self.drift_ewma = 0.0
        self._rng = np.random.default_rng(config.seed)

    # -- estimation ---------------------------------------------------------
    def kernel_inputs(self, x: np.ndarray):
        """K3's inputs for the samples ``x`` under the current mixture, on
        the forecaster's device: float32 samples and float64 (weights,
        means, stds), all mapped to the unit key domain. The scaling keeps
        the float32 kernel conditioned on 52-bit keys; the shared
        -log(span) shifts every component equally and cancels in the
        softmax."""
        xs = ((x - self.lo) / self.span).astype(np.float32)
        ms = (self.gmm.means.numpy() - self.lo) / self.span
        ss = np.maximum(self.gmm.stds.numpy() / self.span, _MIN_STD_FRAC)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (xs, self.gmm.weights.numpy(), ms, ss))

    def _responsibilities(self, x: np.ndarray) -> np.ndarray:
        """(N, K) responsibilities under the current mixture."""
        if self.cfg.use_kernel:
            resp = ops.gmm_estep(*self.kernel_inputs(x))
            return resp.cpu().numpy().astype(np.float64)
        # a K-component E-step over numpy is microseconds per batch
        w = self.gmm.weights.numpy()
        mu = self.gmm.means.numpy()
        sd = np.maximum(self.gmm.stds.numpy(), 1e-300)
        z = (x[:, None] - mu[None, :]) / sd[None, :]
        logp = np.log(w[None, :]) - 0.5 * z * z - np.log(sd[None, :])
        m = logp.max(axis=1, keepdims=True)
        e = np.exp(logp - m)
        return e / e.sum(axis=1, keepdims=True)

    def observe(self, keys: np.ndarray):
        """One streaming-EM step on a batch of observed insert keys."""
        x = np.asarray(keys, dtype=np.float64)
        if len(x) == 0:
            return
        if len(x) > self.cfg.max_batch:
            x = self._rng.choice(x, self.cfg.max_batch, replace=False)
        resp = self._responsibilities(x)
        d = self.cfg.decay
        self._s0 = d * self._s0 + resp.sum(axis=0)
        self._s1 = d * self._s1 + resp.T @ x
        self._s2 = d * self._s2 + resp.T @ (x * x)
        self.n_obs += len(x)
        self.n_batches += 1
        if self.n_obs < self.cfg.min_obs:
            return
        # closed-form M-step on the decayed stats
        s0 = np.maximum(self._s0, 1e-12)
        w = s0 / s0.sum()
        mu = self._s1 / s0
        var = np.maximum(self._s2 / s0 - mu * mu, 0.0)
        std = np.maximum(np.sqrt(var), _MIN_STD_FRAC * self.span)
        drift = float(np.mean(np.abs(mu - self.gmm.means.numpy()))) / self.span
        self.drift_ewma = 0.8 * self.drift_ewma + 0.2 * drift
        self.gmm = GMMState(
            weights=torch.from_numpy(w),
            means=torch.from_numpy(mu),
            stds=torch.from_numpy(std),
        )

    @property
    def ready(self) -> bool:
        """Enough mass observed for the forecast to outrank the prior."""
        return self.n_obs >= self.cfg.min_obs

    # -- forecast consumers ---------------------------------------------------
    def shard_mass(self, boundaries: np.ndarray) -> np.ndarray:
        """Predicted insert mass per shard of a range partition: CDF diffs
        at the S-1 boundaries, normalized to sum to 1 over the S shards."""
        b = np.asarray(boundaries, dtype=np.float64)
        if len(b) == 0:
            return np.ones(1)
        cdf = gmm_cdf_np(self.gmm, b)
        mass = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
        mass = np.maximum(mass, 0.0)
        t = mass.sum()
        return mass / t if t > 0 else np.full(len(b) + 1, 1.0 / (len(b) + 1))

    def bmat_presize(
        self, boundaries: np.ndarray, horizon_inserts: int
    ) -> int:
        """Per-shard delta-buffer capacity that absorbs the next
        ``horizon_inserts`` inserts if they land as forecast (the hottest
        shard sets the size: capacities are shared across the shards)."""
        mass = self.shard_mass(boundaries)
        return int(np.ceil(float(mass.max()) * horizon_inserts))

    def hottest_shard(self, boundaries: np.ndarray) -> int:
        return int(np.argmax(self.shard_mass(boundaries)))

    def imbalance(self, boundaries: np.ndarray) -> float:
        """max/mean predicted shard mass — ≥ ~2 means the partition no
        longer matches where inserts are going."""
        mass = self.shard_mass(boundaries)
        return float(mass.max() * len(mass))

    def gap_sizes(
        self, keys: np.ndarray, *, alpha_target: float, d_max: int
    ) -> np.ndarray:
        """Eq. 6 Nullifier gap counts under the *forecast* D_update."""
        return gap_sizes(keys, self.gmm, alpha_target=alpha_target,
                         d_max=d_max)
