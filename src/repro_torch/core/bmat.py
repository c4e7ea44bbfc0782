"""BMAT — Balanced Model Adjustment Tree (port of ``repro/core/bmat.py``,
Section 3.3).

The delta buffer for updates that cannot be accommodated in place. It
answers the batched bias query ``rank(k)`` (number of buffered entries with
key < k, the r(k) of Definition 1) over one packed sorted array, in one of
two traversals:

  * RBMAT — binary descent with the complete-tree BFS index schedule:
    log2(cap) dependent gathers, no auxiliary arrays;
  * B+MAT — two-level fence tree: a bisect over the fence array (every
    ``fanout``-th key), then one bounded in-node bisect.

On the index path (``fops``) with ``locate="fused"`` both kinds rank
through the K2 kernel (``repro_torch/kernels/bmat_rank.py``), which walks
the fences. The standalone ``BMAT`` (the paper's object, Fig. 4) ranks
through the two traversals above, as the reference's does.
Inserts are vectorized sorted merges of a batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.shapes import pow2_at_least
from repro_torch.core.types import BMATState, KEY_MAX, TOMBSTONE

RBMAT = "rbmat"
BPMAT = "b+mat"
_MIN_CAP = 4096


def bmat_height(size: int, tree_type: str, fanout: int) -> int:
    """Dependent-gather count of one rank query (performance measure S1)."""
    n = max(size, 2)
    if tree_type == RBMAT:
        return int(np.ceil(np.log2(n)))
    return int(np.ceil(np.log2(max(n // fanout, 2)))) + int(
        np.ceil(np.log2(fanout))
    )


def _make_fences(keys: torch.Tensor, fanout: int) -> torch.Tensor:
    tail = torch.full((1,), KEY_MAX, dtype=keys.dtype, device=keys.device)
    return torch.cat([keys[::fanout], tail])


# --------------------------------------------------------------------------
# batched rank (searchsorted-left semantics over the live prefix)
# --------------------------------------------------------------------------


def _rank_rbmat(keys: torch.Tensor, queries: torch.Tensor, levels: int):
    """Binary-tree descent over the sorted array using the complete-tree BFS
    schedule: at level l, node t inspects sorted index (2t+1)*2^(h-1-l) - 1.
    After h levels, t == searchsorted_left(keys, q)."""
    cap = keys.shape[0]
    t = torch.zeros_like(queries)
    for lvl in range(levels):
        stride = 1 << (levels - 1 - lvl)
        s = torch.clamp((2 * t + 1) * stride - 1, max=cap - 1)
        t = 2 * t + (keys[s] < queries).to(t.dtype)
    return torch.clamp(t, max=cap).to(torch.int32)


def _rank_bpmat(
    keys: torch.Tensor,
    fences: torch.Tensor,
    queries: torch.Tensor,
    fanout: int,
    fence_iters: int,
    node_iters: int,
):
    """Fence search (first fence >= q) then bounded in-node search."""
    nf = fences.shape[0]
    lo = torch.zeros_like(queries)
    hi = torch.full_like(queries, nf - 1)
    for _ in range(fence_iters):
        mid = (lo + hi) >> 1
        go = fences[torch.clamp(mid, max=nf - 1)] < queries
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    # fence index f: first fence >= q -> the answer lies in node (f-1, f]
    cap = keys.shape[0]
    nlo = torch.clamp(lo - 1, min=0) * fanout
    nhi = torch.clamp(nlo + fanout, max=cap)
    for _ in range(node_iters):
        mid = (nlo + nhi) >> 1
        go = keys[torch.clamp(mid, max=cap - 1)] < queries
        nlo, nhi = torch.where(go, mid + 1, nlo), torch.where(go, nhi, mid)
    return torch.clamp(nlo, max=cap).to(torch.int32)


def _merge(
    keys: torch.Tensor,
    vals: torch.Tensor,
    size: torch.Tensor,
    new_keys: torch.Tensor,
    new_vals: torch.Tensor,
    n_new: torch.Tensor,
):
    """Merge a sorted-unique batch (padded with KEY_MAX) into the packed
    arrays. Duplicate keys must have been routed to value updates upstream.
    Returns fresh (keys, vals, size) with the same capacity.

    Gather formulation: only the batch positions are scattered — into a
    marker and a row map, each with one spare slot that takes the rows
    outside the batch — then every output slot pulls its element with a
    cumsum and two gathers.
    """
    cap = keys.shape[0]
    q = new_keys.shape[0]
    dev = keys.device
    ar_q = torch.arange(q, dtype=torch.int64, device=dev)
    # merged position of each new entry (strictly increasing for valid rows)
    new_pos = ar_q + torch.searchsorted(keys, new_keys, right=True)
    valid_new = (ar_q < n_new) & (new_pos < cap)
    tgt = torch.where(valid_new, new_pos, cap)
    mark = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    mark[tgt] = 1
    new_at = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    new_at[tgt] = ar_q.to(torch.int32)
    mark, new_at = mark[:cap], new_at[:cap]
    nb = torch.cumsum(mark, 0)  # new entries at merged positions <= i
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    is_new = new_at >= 0
    old_idx = torch.clamp(i - nb, 0, cap - 1)
    from_old = ~is_new & ((i - nb) < size)
    src = torch.clamp(new_at, 0, q - 1).to(torch.int64)
    out_keys = torch.where(
        is_new, new_keys[src], torch.where(from_old, keys[old_idx], KEY_MAX)
    )
    out_vals = torch.where(
        is_new, new_vals[src], torch.where(from_old, vals[old_idx], 0)
    )
    return out_keys, out_vals, size + n_new.to(size.dtype)


def _bmat_probe(bmat: BMATState, ranks, queries):
    """(present, alive, value, index) of a query inside the BMAT arrays at
    its rank (the reference's ``_lookup``, with the index); KEY_MAX never
    matches."""
    cap = bmat.keys.shape[0]
    idx = torch.clamp(ranks.to(torch.int64), max=cap - 1)
    present = (bmat.keys[idx] == queries) & (queries != KEY_MAX)
    val = bmat.vals[idx]
    alive = present & (val != TOMBSTONE)
    return present, alive, torch.where(alive, val, 0), idx


class BMAT:
    """Host wrapper holding the array state + static tuning knobs.

    The batch entry points take and return numpy arrays; the state lives
    on the device given at construction."""

    def __init__(
        self,
        tree_type: str = BPMAT,
        fanout: int = 16,
        capacity: int = _MIN_CAP,
        *,
        device,
    ):
        if tree_type not in (RBMAT, BPMAT):
            raise ValueError(f"unknown BMAT type {tree_type!r}")
        if fanout < 2 or fanout & (fanout - 1):
            raise ValueError("fanout must be a power of two >= 2")
        self.tree_type = tree_type
        self.fanout = fanout
        capacity = max(pow2_at_least(capacity), _MIN_CAP)
        keys = torch.full((capacity,), KEY_MAX, dtype=torch.int64,
                          device=device)
        self.state = BMATState(
            keys=keys,
            vals=torch.zeros(capacity, dtype=torch.int64, device=device),
            fences=_make_fences(keys, fanout),
            size=torch.tensor(0, dtype=torch.int32, device=device),
        )

    # -- introspection -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.state.keys.shape[0])

    @property
    def size(self) -> int:
        tracing.count("host_syncs")      # a read of a device scalar
        return int(self.state.size)

    @property
    def live_size(self) -> int:
        """Entries excluding tombstones (exact; O(size) reduce)."""
        n = self.size
        if n == 0:
            return 0
        return int((self.state.vals[:n] != TOMBSTONE).sum())

    @property
    def height(self) -> int:
        """Dependent-gather count of one rank query (performance measure S1)."""
        return bmat_height(self.size, self.tree_type, self.fanout)

    def memory_bytes(self, modeled: bool = False) -> int:
        """Bytes of the device arrays; ``modeled=True`` gives the paper's
        CPU-side layout instead (3 pointers per node for RBMAT; node slack
        and fences for B+MAT), for Fig. 4's memory comparison."""
        if not modeled:
            return sum(a.numel() * a.element_size() for a in self.state)
        if self.tree_type == RBMAT:
            return self.size * (2 * 8 + 3 * 8 + 1)  # key+val, 3 ptrs, color
        nodes = max(self.size // self.fanout + 1, 1)
        return nodes * (self.fanout * 2 * 8 + 8) + self.capacity // self.fanout * 8

    # -- queries -------------------------------------------------------------
    # Boundary discipline: the public entry points take and return numpy
    # arrays, as the reference's do; the state stays on its device and only
    # the results come back. The reference pads every batch to a power-of-two
    # width to bound its jit cache; the port runs eagerly and needs no
    # padding (a padded row is a KEY_MAX query, whose result is dropped).
    def _queries(self, queries) -> torch.Tensor:
        q = np.ascontiguousarray(queries, dtype=np.int64)
        return torch.as_tensor(q).to(self.state.keys.device)

    def _ranks(self, q: torch.Tensor) -> torch.Tensor:
        """Ranks of ``q`` through the current tree type's traversal."""
        if self.tree_type == RBMAT:
            return _rank_rbmat(self.state.keys, q, int(np.log2(self.capacity)))
        nf = self.state.fences.shape[0]
        return _rank_bpmat(
            self.state.keys,
            self.state.fences,
            q,
            self.fanout,
            int(np.ceil(np.log2(nf + 1))),
            int(np.ceil(np.log2(self.fanout + 1))),
        )

    def rank(self, queries: np.ndarray) -> np.ndarray:
        """r(k): number of buffered entries with key < k (Phase-1 bias)."""
        return self._ranks(self._queries(queries)).cpu().numpy()

    def lookup(self, queries: np.ndarray):
        """(found, value) per query; a tombstoned key is not found."""
        q = self._queries(queries)
        _, found, vals, _ = _bmat_probe(self.state, self._ranks(q), q)
        return found.cpu().numpy(), vals.cpu().numpy()

    def range_bounds(self, lo: np.ndarray, hi: np.ndarray):
        """(rank(lo), rank(hi+1)) — the buffered slice for a range query."""
        return self.rank(lo), self.rank(np.asarray(hi) + 1)

    # -- updates -------------------------------------------------------------
    def merge(self, new_keys: np.ndarray, new_vals: np.ndarray) -> None:
        """Insert a batch. Keys already present get their value overwritten
        in place; new keys are merged (sorted, vectorized)."""
        new_keys = np.asarray(new_keys, dtype=np.int64)
        new_vals = np.asarray(new_vals, dtype=np.int64)
        if len(new_keys) == 0:
            return
        order = np.argsort(new_keys, kind="stable")
        new_keys, new_vals = new_keys[order], new_vals[order]
        # batch-internal dedup: keep the LAST occurrence (latest write wins)
        is_last = np.concatenate([new_keys[1:] != new_keys[:-1], [True]])
        new_keys, new_vals = new_keys[is_last], new_vals[is_last]
        # existing keys -> value update in place
        dev = self.state.keys.device
        kt = torch.as_tensor(new_keys).to(dev)
        vt = torch.as_tensor(new_vals).to(dev)
        idx = torch.clamp(self._ranks(kt).to(torch.int64),
                          max=self.capacity - 1)
        present = self.state.keys[idx] == kt
        if bool(present.any()):
            self._set_vals(idx, present, vt)
        fresh = ~present
        n_new = int(fresh.sum())
        if n_new == 0:
            return
        if self.size + n_new > self.capacity - 1:
            self._grow(self.size + n_new)
        keys, vals, size = _merge(
            self.state.keys,
            self.state.vals,
            self.state.size,
            kt[fresh],
            vt[fresh],
            torch.tensor(n_new, dtype=torch.int32, device=dev),
        )
        self.state = BMATState(
            keys=keys, vals=vals, fences=_make_fences(keys, self.fanout),
            size=size,
        )

    def delete(self, keys: np.ndarray) -> np.ndarray:
        """Tombstone deletes for buffered keys; returns hit mask."""
        q = self._queries(keys)
        _, found, _, idx = _bmat_probe(self.state, self._ranks(q), q)
        if bool(found.any()):
            self._set_vals(idx, found, torch.full_like(q, TOMBSTONE))
        return found.cpu().numpy()

    def compact(self) -> None:
        """Drop tombstones (host-side; used by the tuning actions)."""
        self._rebuild(*self.extract())

    def extract(self, lo: int | None = None, hi: int | None = None):
        """Live (keys, vals) in [lo, hi] as numpy (for flush/retrain)."""
        n = self.size
        keys = self.state.keys[:n].cpu().numpy()
        vals = self.state.vals[:n].cpu().numpy()
        live = vals != TOMBSTONE
        if lo is not None:
            live &= keys >= lo
        if hi is not None:
            live &= keys <= hi
        return keys[live], vals[live]

    def remove_range(self, lo: int, hi: int) -> None:
        """Remove all live entries in [lo, hi] (after they were absorbed
        in place by a subset-retrain tuning action)."""
        keys, vals = self.extract()
        keep = ~((keys >= lo) & (keys <= hi))
        self._rebuild(keys[keep], vals[keep])

    def switch_type(self) -> None:
        """Tuning action A3: RBMAT <-> B+MAT (the state is layout-agnostic)."""
        self.tree_type = BPMAT if self.tree_type == RBMAT else RBMAT

    # -- internals -----------------------------------------------------------
    def _set_vals(self, idx, mask, vals) -> None:
        """``vals[idx[mask]] = vals[mask]`` as one masked scatter (the rows
        outside the mask aim at a spare trailing row that is cut off)."""
        from repro_torch.core.fops import _scatter_drop  # fops imports bmat

        self.state = self.state._replace(
            vals=_scatter_drop(self.state.vals, idx, vals, mask))

    def _grow(self, need: int) -> None:
        new_cap = max(pow2_at_least(4 * need + 2), _MIN_CAP)
        dev = self.state.keys.device
        n = self.size
        keys = torch.full((new_cap,), KEY_MAX, dtype=torch.int64, device=dev)
        vals = torch.zeros(new_cap, dtype=torch.int64, device=dev)
        keys[:n] = self.state.keys[:n]
        vals[:n] = self.state.vals[:n]
        self.state = BMATState(
            keys=keys,
            vals=vals,
            fences=_make_fences(keys, self.fanout),
            size=self.state.size,
        )

    def _rebuild(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Fresh arrays holding exactly the sorted (keys, vals)."""
        cap = max(pow2_at_least(len(keys) + 1), _MIN_CAP)
        k = np.full(cap, KEY_MAX, dtype=np.int64)
        v = np.zeros(cap, dtype=np.int64)
        k[: len(keys)] = keys
        v[: len(keys)] = vals
        dev = self.state.keys.device
        kt = torch.tensor(k, device=dev)
        self.state = BMATState(
            keys=kt,
            vals=torch.tensor(v, device=dev),
            fences=_make_fences(kt, self.fanout),
            size=torch.tensor(len(keys), dtype=torch.int32, device=dev),
        )
