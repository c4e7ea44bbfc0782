"""Baseline index structures (paper Section 5.1; port of
``repro/baselines/indexes.py``).

Design-point mapping (each is the paper baseline's mechanism expressed on
the shared gapped-array substrate):

  BTreeLike  — classical B+Tree: no learned model. Lookup = a full binary
               search over the whole slot array (the ``binsearch`` locate,
               so the fused locate kernel does not run for it); uniform
               slack per node (gaps).
  AlexLike   — in-place learned index (ALEX): model-guided lookup, uniform
               gap placement, no delta buffer — conflicts trigger
               node-split-style rebuilds.
  LIPPLike   — delta-buffer learned index (LIPP): exact-position model with
               no gaps; every conflicting insert goes to the buffer.
  DILILike   — hybrid (DILI): uniform gaps + delta buffer + threshold
               retrain, but no distribution-aware placeholders and no
               self-tuning agent.

Each takes ``device=`` as ``UpLIF`` does (``cuda`` unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.gmm import init_gmm_uniform
from repro_torch.core.state import LOCATE_BINSEARCH
from repro_torch.core.uplif import UpLIF, UpLIFConfig


def _uniform_prior(keys, n_components: int):
    return init_gmm_uniform(
        float(np.min(keys)) if len(keys) else 0.0,
        float(np.max(keys)) if len(keys) else 1.0,
        n_components,
    )


class BTreeLike(UpLIF):
    """STX-B+Tree stand-in: no learned model, uniform node slack. The
    model-free traversal (a bisect over the whole slot array) is selected
    through the ``LOCATE`` class override."""

    LOCATE = LOCATE_BINSEARCH

    def __init__(self, keys, vals=None, config: UpLIFConfig = UpLIFConfig(),
                 device=None):
        super().__init__(keys, vals, config,
                         gmm=_uniform_prior(keys, config.gmm_components),
                         device=device)

    def refreshed_gmm(self):
        # a B+Tree does not model the update distribution
        return self.gmm

    def index_bytes(self, modeled: bool = False) -> int:
        # inner-node overhead instead of a learned model: fences over slots
        fanout = self.cfg.bmat_fanout
        inner = 0
        n = max(self.capacity, 1)
        while n > 1:
            n = (n + fanout - 1) // fanout
            inner += n
        return inner * 16 + self.bmat.memory_bytes(modeled)


class AlexLike(UpLIF):
    """ALEX stand-in: in-place only; conflicts trigger split-style rebuilds."""

    REBUILD_FRAC = 0.01  # overflow fraction that triggers a rebuild

    def __init__(self, keys, vals=None, config: UpLIFConfig = UpLIFConfig(),
                 device=None):
        super().__init__(keys, vals, config,
                         gmm=_uniform_prior(keys, config.gmm_components),
                         device=device)

    def refreshed_gmm(self):
        # uniform placeholders — ALEX does not learn where updates will land
        return self.gmm

    def insert(self, keys, vals=None):
        ov = super().insert(keys, vals)
        # no delta buffer: overflow forces an immediate node-split rebuild
        if self.bmat.size > max(64, self.REBUILD_FRAC * self.n_keys):
            self.retrain_full()
        return ov

    def retrain_full(self):
        # keep the uniform prior (no D_update learning) across rebuilds
        reservoir = self._reservoir
        self._reservoir = np.zeros(0, dtype=np.int64)
        super().retrain_full()
        self._reservoir = reservoir


class LIPPLike(UpLIF):
    """LIPP stand-in: exact-position model (no gaps) + per-conflict buffer."""

    def __init__(self, keys, vals=None, config: UpLIFConfig = UpLIFConfig(),
                 device=None):
        cfg = UpLIFConfig(
            max_error=config.max_error,
            window=config.window,
            movement_k=0,            # LIPP never shifts
            d_max=1,
            alpha_target=0.02,       # essentially no placeholders
            radix_bits=config.radix_bits,
            insert_rounds=1,
            batch_bucket=config.batch_bucket,
            gmm_components=config.gmm_components,
            reservoir=config.reservoir,
            bmat_type=config.bmat_type,
            bmat_fanout=config.bmat_fanout,
        )
        super().__init__(keys, vals, cfg,
                         gmm=_uniform_prior(keys, cfg.gmm_components),
                         device=device)

    def refreshed_gmm(self):
        return self.gmm


class DILILike(UpLIF):
    """DILI stand-in: hybrid gaps+buffer with threshold retrain, but uniform
    (distribution-unaware) placeholders and no self-tuning agent."""

    RETRAIN_FRAC = 0.08

    def __init__(self, keys, vals=None, config: UpLIFConfig = UpLIFConfig(),
                 device=None):
        super().__init__(keys, vals, config,
                         gmm=_uniform_prior(keys, config.gmm_components),
                         device=device)

    def refreshed_gmm(self):
        return self.gmm

    def insert(self, keys, vals=None):
        ov = super().insert(keys, vals)
        if self.bmat.size > max(256, self.RETRAIN_FRAC * self.n_keys):
            self.retrain_full()
        return ov
