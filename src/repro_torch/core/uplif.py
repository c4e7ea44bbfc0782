"""UpLIF — the updatable learned index (port of ``repro/core/uplif.py``).

A thin stateful shell: the whole index lives in one ``UpLIFState`` on one
device, and every operation forwards to ``repro_torch.core.fops``. The
shell owns only host concerns: the host-side bulk load, batch padding,
BMAT capacity growth and the D_update reservoir.

The index runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request, construction raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import fops, shapes
from repro_torch.core.bmat import BMAT, BPMAT
from repro_torch.core.gmm import fit_gmm, gmm_memory_bytes, init_gmm_uniform
from repro_torch.core.nullifier import nullify
from repro_torch.core.radix_spline import build_radix_spline, rs_memory_bytes
from repro_torch.core.state import (
    LOCATE_AUTO,
    LOCATE_BINSEARCH,
    LOCATE_STRATEGIES,
    UpLIFState,
    UpLIFStatic,
    init_counters,
    resolve_locate,
)
from repro_torch.core.types import GMMState, KEY_MAX, TOMBSTONE
from repro_torch.kernels.ops import native_kernels, resolve_device


@dataclasses.dataclass(frozen=True)
class UpLIFConfig:
    """Static knobs (the JAX package's fields and defaults)."""

    max_error: int = 24          # ξ — spline error bound
    window: int = 64             # W — last-mile / insert window (power of 2)
    movement_k: int = 6          # K — max elements shifted per insert
    d_max: int = 32              # max gap between continuous keys (Eq. 6 cap)
    alpha_target: float = 1.0    # target mean gap α (Eq. 7)
    radix_bits: int = 16
    insert_rounds: int = 3       # in-place retry rounds before BMAT overflow
    batch_bucket: int = 4096     # padded batch width bucket
    gmm_components: int = 4
    reservoir: int = 32768       # update-key sample for D_update estimation
    bmat_type: str = BPMAT
    bmat_fanout: int = 16
    bmat_capacity: int = 4096    # initial delta-buffer capacity (grows)
    # "auto" resolves to the fused kernels on CUDA and to the plain spline
    # path elsewhere; tests pin "spline" / "binsearch" / "fused" explicitly.
    locate: str = LOCATE_AUTO
    # Does nothing in the port: the JAX package keeps a persistent
    # (hi, lo) split of every key array because the TPU has no int64; the
    # Hopper kernels read int64 directly. Kept so configs carry over.
    persist_halves: bool = True

    def __post_init__(self):
        if self.window & (self.window - 1):
            raise ValueError("window must be a power of two")
        if 2 * (self.max_error + self.movement_k) + 4 > self.window:
            raise ValueError("window too small for max_error and movement_k")
        if self.locate not in LOCATE_STRATEGIES + (LOCATE_AUTO,):
            raise ValueError(f"unknown locate strategy {self.locate!r}")


# The shell, the shard router and the gateway bucket widths with the one
# quantization of core/shapes.py.
bucket_width = shapes.bucket_width


class UpLIF:
    """Batched updatable learned index (thin shell over fops)."""

    # a subclass pins its locate strategy here (the B+Tree baseline's
    # model-free bisect); None defers to ``cfg.locate``
    LOCATE: Optional[str] = None

    def __init__(
        self,
        keys: np.ndarray,
        vals: Optional[np.ndarray] = None,
        config: UpLIFConfig = UpLIFConfig(),
        gmm: Optional[GMMState] = None,
        device=None,
    ):
        self._init_shell(config, resolve_device(device))
        keys = np.asarray(keys, dtype=np.int64)
        order = np.argsort(keys)
        keys = keys[order]
        if vals is None:
            vals = keys.copy()
        else:
            vals = np.asarray(vals, dtype=np.int64)[order]
        uk, ui = np.unique(keys, return_index=True)
        keys, vals = uk, vals[ui]
        if not (np.all(keys >= 0) and (len(keys) == 0 or keys[-1] < KEY_MAX)):
            raise ValueError("keys must lie in [0, KEY_MAX)")
        if gmm is None:
            lo = float(keys[0]) if len(keys) else 0.0
            hi = float(keys[-1]) if len(keys) else 1.0
            gmm = init_gmm_uniform(lo, hi, config.gmm_components)
        self._bulk_load(keys, vals, gmm)

    def _init_shell(self, config: UpLIFConfig, device: torch.device):
        self.cfg = config
        self.device = device
        self.bmat = BMAT(
            config.bmat_type, config.bmat_fanout,
            capacity=config.bmat_capacity, device=device,
        )
        self._reservoir = np.zeros(0, dtype=np.int64)
        self._rng = np.random.default_rng(0)
        # the usage counter stays on the host; structural counters live in
        # the device-resident Counters
        self.n_lookups = 0
        self.n_retrains = 0
        self._counters = init_counters(device)

    @classmethod
    def from_state(
        cls, state: UpLIFState, *, rs_static, gmm: GMMState, alpha: float,
        config: UpLIFConfig, device,
    ) -> "UpLIF":
        """A shell around an existing state (see ``core/convert.py``)."""
        self = cls.__new__(cls)
        self._init_shell(config, resolve_device(device))
        self.gmm = gmm
        self.alpha = alpha
        self.slots = state.slots
        self.rs_model, self.rs_static = state.model, rs_static
        self.bmat.state = state.bmat
        self._counters = state.counters
        return self

    # -- construction --------------------------------------------------------
    def _bulk_load(
        self,
        keys: np.ndarray,
        vals: np.ndarray,
        gmm: GMMState,
        alpha_target: Optional[float] = None,
        gap_quantize: str = "ceil",
    ):
        cfg = self.cfg
        self.gmm = gmm
        res = nullify(
            keys,
            vals,
            gmm,
            alpha_target=(
                cfg.alpha_target if alpha_target is None else alpha_target
            ),
            d_max=cfg.d_max,
            tail_slack=max(64, cfg.window),
            align=cfg.window,  # grid windows require W-aligned capacity
            quantize=gap_quantize,
            device=self.device,
        )
        self.slots = res.slots
        self.alpha = res.alpha
        self.rs_model, self.rs_static = build_radix_spline(
            keys,
            res.positions,
            radix_bits=cfg.radix_bits,
            max_error=cfg.max_error,
            device=self.device,
        )
        c = self._counters
        self._counters = c._replace(
            n_keys=torch.tensor(len(keys), dtype=torch.int64, device=self.device),
            n_bmat_live=torch.tensor(
                self.bmat.live_size, dtype=torch.int64, device=self.device
            ),
        )

    # -- functional-core plumbing ---------------------------------------------
    @property
    def fstate(self) -> UpLIFState:
        """The whole index as one state (views of the arrays, no copy)."""
        return UpLIFState(
            slots=self.slots,
            model=self.rs_model,
            bmat=self.bmat.state,
            counters=self._counters,
        )

    def locate_strategy(self) -> str:
        """Concrete locate strategy: the class override, else cfg.locate,
        resolved for the device."""
        return resolve_locate(self.LOCATE or self.cfg.locate,
                              native_kernels(self.device))

    def fstatic(self) -> UpLIFStatic:
        """Host scalars for the fops suite."""
        locate = self.locate_strategy()
        return UpLIFStatic(
            window=self.cfg.window,
            movement_k=self.cfg.movement_k,
            rs_iters=(
                self.rs_static.n_search_iters
                if locate != LOCATE_BINSEARCH
                else 0
            ),
            insert_rounds=self.cfg.insert_rounds,
            fanout=self.bmat.fanout,
            bmat_kind=self.bmat.tree_type,
            locate=locate,
        )

    def _adopt(self, state: UpLIFState):
        self.slots = state.slots
        self.bmat.state = state.bmat
        self._counters = state.counters

    # -- counters (host views of the device counters) -------------------------
    @property
    def n_keys(self) -> int:
        return int(self._counters.n_keys)

    @property
    def n_inplace(self) -> int:
        return int(self._counters.n_inplace)

    @property
    def n_overflow(self) -> int:
        return int(self._counters.n_overflow)

    @property
    def min_granularity(self) -> int:
        return int(self._counters.min_granularity)

    @property
    def capacity(self) -> int:
        return int(self.slots.keys.shape[0])

    @property
    def size(self) -> int:
        """Total live keys (in-place + buffered, tombstones excluded)."""
        c = self._counters
        return int(c.n_keys + c.n_bmat_live)

    # -- helpers ---------------------------------------------------------------
    def _pad(self, arr: np.ndarray, fill) -> Tuple[torch.Tensor, int]:
        """Pad to a bucketed width (``bucket_width``) and move to
        the index's device."""
        with tracing.span("uplif.h2d"):
            n = len(arr)
            m = bucket_width(n, self.cfg.batch_bucket)
            out = arr
            if n != m:
                out = np.full(m, fill, dtype=arr.dtype)
                out[:n] = arr
            tracing.count("host_syncs")      # a copy from pageable memory
            return torch.tensor(out, device=self.device), n

    def _ensure_bmat_capacity(self, incoming: int):
        """Merges cannot grow arrays: presize for the worst case (every
        incoming key overflows) before the insert."""
        with tracing.span("bmat.reserve"):
            need = self.bmat.size + incoming
            if need > self.bmat.capacity - 1:
                self.bmat._grow(need)

    # -- queries ---------------------------------------------------------------
    def lookup(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched point lookup -> (found bool[n], values int64[n])."""
        with tracing.span("uplif.lookup"):
            queries = np.asarray(queries, dtype=np.int64)
            q, n = self._pad(queries, KEY_MAX)
            alive, vals = fops.lookup(self.fstate, q, static=self.fstatic())
            self.n_lookups += n
            with tracing.span("uplif.d2h"):
                tracing.count("host_syncs", 2)
                return alive.cpu().numpy()[:n], vals.cpu().numpy()[:n]

    def adjusted_predict(self, queries: np.ndarray) -> np.ndarray:
        """Paper Eq. 1 / Module 3: the logical position M'(k) = live
        in-place rank + r(k), the BMAT bias. Exposed for validation."""
        queries = np.asarray(queries, dtype=np.int64)
        q, n = self._pad(queries, KEY_MAX)
        rank = fops.adjusted_rank(self.fstate, q, static=self.fstatic())
        return rank.cpu().numpy()[:n]

    def range_query(self, lo: int, hi: int, max_out: int = 1024):
        """Sorted (keys, vals) with lo <= key <= hi, at most ``max_out``."""
        ks, vs = self.range_query_batch(
            np.asarray([lo], dtype=np.int64),
            np.asarray([hi], dtype=np.int64),
            max_out,
        )
        return ks[0], vs[0]

    def range_query_batch(self, lo: np.ndarray, hi: np.ndarray,
                          max_out: int = 1024):
        """Batched range extraction: one ``fops.range_scan`` over the padded
        batch (``lo`` padded with KEY_MAX, ``hi`` with 0, so padding rows
        are empty); the host only unpacks the result rows."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        ql, n = self._pad(lo, KEY_MAX)
        qh, _ = self._pad(hi, 0)
        res = fops.range_scan(self.fstate, ql, qh, static=self.fstatic(),
                              max_out=max_out)
        ks = res.keys.cpu().numpy()
        vs = res.vals.cpu().numpy()
        counts = res.count.cpu().numpy()
        return ([ks[i, :counts[i]] for i in range(n)],
                [vs[i, :counts[i]] for i in range(n)])

    # -- updates ---------------------------------------------------------------
    def insert(self, keys: np.ndarray, vals: Optional[np.ndarray] = None):
        """Batched upsert. Returns the count that went to the BMAT."""
        with tracing.span("uplif.insert"):
            keys = np.asarray(keys, dtype=np.int64)
            if vals is None:
                vals = keys.copy()
            vals = np.asarray(vals, dtype=np.int64)
            if keys.shape != vals.shape:
                raise ValueError("keys and vals must have the same shape")
            if len(keys) == 0:
                return 0
            tracing.count("insert.keys", len(keys))
            self._observe_updates(keys)
            q, _ = self._pad(keys, KEY_MAX)
            v, _ = self._pad(vals, 0)
            self._ensure_bmat_capacity(int(q.shape[0]))
            state, res = fops.insert(self.fstate, q, v, static=self.fstatic())
            self._adopt(state)
            with tracing.span("uplif.d2h"):
                tracing.count("host_syncs")
                n_over = int(res.n_overflow)
            tracing.count("insert.overflow", n_over)
            return n_over

    def delete(self, keys: np.ndarray) -> np.ndarray:
        """Batched delete (tombstones). Returns hits."""
        keys = np.asarray(keys, dtype=np.int64)
        q, n = self._pad(keys, KEY_MAX)
        state, hit = fops.delete(self.fstate, q, static=self.fstatic())
        self._adopt(state)
        return hit.cpu().numpy()[:n]

    # -- D_update estimation (Phase 2) ----------------------------------------
    def _observe_updates(self, keys: np.ndarray):
        with tracing.span("uplif.reservoir"):
            cap = self.cfg.reservoir
            take = (keys if len(keys) <= cap
                    else self._rng.choice(keys, cap, replace=False))
            self._reservoir = np.concatenate([self._reservoir, take])
            if len(self._reservoir) > cap:
                self._reservoir = self._rng.choice(self._reservoir, cap,
                                                   replace=False)

    def refreshed_gmm(self) -> GMMState:
        """D_update refit from the reservoir (the prior until 64 samples)."""
        if len(self._reservoir) >= 64:
            return fit_gmm(self._reservoir, self.cfg.gmm_components)
        return self.gmm

    # -- tuning actions (Section 4.2) ------------------------------------------
    def extract_live(self) -> Tuple[np.ndarray, np.ndarray]:
        """All live (key, value) pairs — in-place + buffered, tombstones
        dropped — sorted by key, as numpy."""
        sk = self.slots.keys.cpu().numpy()
        sv = self.slots.vals.cpu().numpy()
        so = self.slots.occ.cpu().numpy()
        live = so & (sv != TOMBSTONE)
        bk, bv = self.bmat.extract()
        keys = np.concatenate([sk[live], bk])
        vals = np.concatenate([sv[live], bv])
        o = np.argsort(keys, kind="stable")
        return keys[o], vals[o]

    def retrain_full(
        self,
        gmm: Optional[GMMState] = None,
        alpha_target: Optional[float] = None,
        gap_quantize: str = "ceil",
    ):
        """Action: full retrain — flush the BMAT, drop tombstones,
        re-nullify with ``gmm`` (an external D_update forecast) or the
        reservoir refit, rebuild the spline. ``alpha_target`` overrides the
        Eq. 7 gap budget (the router fits it to the capacity it has)."""
        keys, vals = self.extract_live()
        self.bmat = BMAT(
            self.bmat.tree_type, self.cfg.bmat_fanout,
            capacity=self.cfg.bmat_capacity, device=self.device,
        )
        self._bulk_load(
            keys, vals,
            gmm if gmm is not None else self.refreshed_gmm(),
            alpha_target=alpha_target,
            gap_quantize=gap_quantize,
        )
        self.n_retrains += 1

    def retrain_subset(self, quantiles: int = 16) -> int:
        """Action: retrain on a data subset — absorb the densest BMAT key
        range (one of ``quantiles`` equal-count bins, chosen on the host)
        back in place with one insert that neither probes nor grows the
        BMAT, then rebuild the BMAT without the absorbed keys. The rest of
        the index is untouched. Returns the number absorbed."""
        if self.bmat.size == 0:
            return 0
        bk, bv = self.bmat.extract()
        if len(bk) == 0:
            return 0
        qs = np.quantile(bk, np.linspace(0, 1, quantiles + 1)).astype(np.int64)
        counts = np.histogram(bk, bins=qs)[0]
        b = int(np.argmax(counts))
        lo, hi = int(qs[b]), int(qs[b + 1])
        m = (bk >= lo) & (bk <= hi)
        ck, cv = bk[m], bv[m]
        if len(ck) == 0:
            return 0
        q, nf = self._pad(ck, KEY_MAX)
        v, _ = self._pad(cv, 0)
        state, res = fops.insert(
            self.fstate, q, v, static=self.fstatic(),
            check_bmat=False, merge_overflow=False,
        )
        self._adopt(state)
        absorbed_mask = ~res.pending.cpu().numpy()[:nf]
        absorbed = int(absorbed_mask.sum())
        if absorbed > 0:
            keys_all, vals_all = self.bmat.extract()
            keep = ~np.isin(keys_all, ck[absorbed_mask])
            self.bmat._rebuild(keys_all[keep], vals_all[keep])
            self._counters = self._counters._replace(
                n_bmat_live=torch.tensor(int(keep.sum()), dtype=torch.int64,
                                         device=self.device)
            )
        self.n_retrains += 1
        return absorbed

    def switch_bmat_type(self):
        self.bmat.switch_type()

    # -- accounting (Sections 4.1 / 5.5) ---------------------------------------
    def memory_bytes(self, modeled: bool = False) -> int:
        slots = sum(a.numel() * a.element_size() for a in self.slots)
        return slots + self.index_bytes(modeled)

    def index_bytes(self, modeled: bool = False) -> int:
        """Index-structure-only footprint (excludes the key/value payload
        slots — the §5.5 'index memory size' the paper reports)."""
        return (
            self.bmat.memory_bytes(modeled)
            + rs_memory_bytes(self.rs_model)
            + gmm_memory_bytes(self.gmm)
        )

    def measures(self) -> dict:
        """Section 4.1 performance measures (RL state features)."""
        occ_frac = self.n_keys / max(self.capacity, 1)
        return {
            "bmat_height": self.bmat.height,
            "granularity": int(self.min_granularity),
            "error_scaling": float(self.alpha),
            "n_models": int(self.rs_static.n_spline),
            "bmat_type": self.bmat.tree_type,
            "bmat_size": self.bmat.size,
            "n_keys": self.n_keys,
            "occupancy": occ_frac,
        }
