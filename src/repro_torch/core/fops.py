"""Batched point operations over one ``UpLIFState`` (port of the
single-index part of ``repro/core/fops.py``).

  * ``lookup(state, q)``          — batched point lookup
  * ``insert(state, k, v)``       — batched upsert incl. BMAT overflow
  * ``delete(state, q)``          — batched tombstone delete
  * ``range_scan(state, lo, hi)`` — batched range extraction
  * ``adjusted_rank(state, q)``   — logical rank M'(k) (paper Eq. 1)

Batches arrive padded with KEY_MAX; ``UpLIFStatic`` carries the host
scalars. The slot capacity must be a multiple of ``static.window``, which
keeps every grid window in bounds.

The insert path is the JAX package's grid-segment formulation: windows are
aligned to a fixed W-grid, so the greedy non-overlapping window choice
collapses to "first pending key per grid segment", and all accepted windows
run through one bounded shift and fill-forward repair. Each round of it is
K7 (``kernels/window_insert.py``): two launches on CUDA, the reference's
stable sort and vectorized round on the CPU.

Aliasing: no op writes into a tensor it was given. ``insert`` copies the
three slot arrays once (with one spare W-row) and then updates its own
copies in place; ``delete`` and the BMAT updates build fresh tensors. The
result state shares only the arrays an op left unchanged (the model, and
for ``delete`` the keys), so a state a caller still holds never changes.

JAX's ``.at[...].set(..., mode="drop")`` scatters become writes whose
masked-out rows are aimed at one spare trailing element or row that is cut
off afterwards; the rows kept are distinct, so the result is exact and the
same on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.bmat import (
    RBMAT,
    _bmat_probe,
    _make_fences,
    _merge,
    _rank_bpmat,
    _rank_rbmat,
)
from repro_torch.core.radix_spline import _rs_predict_impl
from repro_torch.core.state import (
    LOCATE_BINSEARCH,
    LOCATE_FUSED,
    Counters,
    UpLIFState,
    UpLIFStatic,
)
from repro_torch.core.types import BMATState, KEY_MAX, TOMBSTONE, SlotsState
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bmat_rank import bmat_rank as k2_rank
from repro_torch.kernels.window_insert import window_insert

_I64_MAX = int(np.iinfo(np.int64).max)


class InsertResult(NamedTuple):
    pending: torch.Tensor     # bool[n] — keys still unplaced after the rounds
    n_overflow: torch.Tensor  # int64 — count routed to the BMAT this call


class RangeResult(NamedTuple):
    keys: torch.Tensor    # int64[n, max_out] — KEY_MAX beyond ``count``
    vals: torch.Tensor    # int64[n, max_out]
    count: torch.Tensor   # int32[n]


def _scatter_drop(arr, idx, vals, mask):
    """``arr.at[where(mask, idx, OOB)].set(vals, mode="drop")`` as a fresh
    tensor: the writes outside ``mask`` land in one spare trailing element
    that is cut off. The kept writes must hit distinct indices."""
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]])
    out[torch.where(mask, idx, n)] = vals
    return out[:n]


# ---------------------------------------------------------------------------
# locate — model-guided (spline / fused kernel) or model-free (binsearch)
# ---------------------------------------------------------------------------


def _locate(static: UpLIFStatic, slot_keys, model, queries):
    """(j, ins_cap): j = index of the last slot with key <= q (-1 if below
    all keys); ins_cap = largest slot index an insert derived from this
    locate may target (cap - 1 for the exact binsearch, the end of the
    searched span for the bounded learned search)."""
    cap = slot_keys.shape[0]
    if static.locate == LOCATE_BINSEARCH:
        # B+Tree analogue: full bisect, log2(capacity) dependent probes
        n_iters = max(1, int(np.ceil(np.log2(cap + 1))))
        lo = torch.zeros_like(queries)
        hi = torch.full_like(queries, cap)
        for _ in range(n_iters):
            mid = (lo + hi) >> 1
            go = slot_keys[torch.clamp(mid, max=cap - 1)] <= queries
            lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
        return lo - 1, torch.full_like(queries, cap - 1)

    if static.locate == LOCATE_FUSED:
        # K1: radix predict + knot search + interpolation + the same 3-row
        # bounded search below, in one kernel launch at any capacity (above
        # the f32 position bound it interpolates in float64, as below)
        return kops.fused_locate(
            model.table, model.spline_keys, model.spline_pos,
            model.shift.reshape(1), slot_keys, queries,
            n_table=model.table.shape[0],
            n_knots=model.spline_keys.shape[0],
            cap=cap, window=static.window, rs_iters=static.rs_iters,
        )

    # Learned path: spline predict + bounded probes over the 3-row span
    # around the prediction. An insert places a key inside the W-aligned
    # row of its insertion point and later in-row shifts never move it
    # across a row edge, so rows {row(c)-1, row(c), row(c)+1} hold every
    # live key whatever the accumulated drift.
    window = static.window
    L = min(3 * window, cap)
    n_bisect = max(1, int(np.ceil(np.log2(L))))
    p = _rs_predict_impl(model, queries, static.rs_iters)
    c = torch.clamp(torch.round(p).to(torch.int64), 0, cap - 1)
    start = torch.clamp((c // window - 1) * window, 0, max(cap - L, 0))
    lo = start
    hi = torch.clamp(start + L - 1, max=cap - 1)
    for _ in range(n_bisect):
        mid = (lo + hi + 1) >> 1
        go = slot_keys[mid] <= queries
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    j = torch.where(slot_keys[start] <= queries, lo, start - 1)
    return j, start + (L - 1)


def _probe(slot_keys, slot_vals, slot_occ, j, queries):
    """(hit, alive, value, clipped-index) of the located slot."""
    cap = slot_keys.shape[0]
    jj = torch.clamp(j, 0, cap - 1)
    hit = (j >= 0) & (slot_keys[jj] == queries) & slot_occ[jj] & (queries != KEY_MAX)
    val = slot_vals[jj]
    alive = hit & (val != TOMBSTONE)
    return hit, alive, torch.where(alive, val, 0), jj


# ---------------------------------------------------------------------------
# BMAT primitives expressed over the state arrays
# ---------------------------------------------------------------------------


def _bmat_rank(static: UpLIFStatic, bmat: BMATState, queries):
    """searchsorted-left rank over the packed BMAT (layout per static)."""
    cap = bmat.keys.shape[0]
    nf = bmat.fences.shape[0]
    if static.locate == LOCATE_FUSED:
        # K2: Definition 1 bias query r(k). The rank is an exact integer
        # search, so it equals both plain traversals for BOTH BMAT kinds.
        return k2_rank(bmat.keys, bmat.fences, queries, cap=cap, nf=nf,
                       fanout=static.fanout)
    if static.bmat_kind == RBMAT:
        return _rank_rbmat(bmat.keys, queries, max(1, int(np.log2(cap))))
    return _rank_bpmat(
        bmat.keys,
        bmat.fences,
        queries,
        static.fanout,
        max(1, int(np.ceil(np.log2(nf + 1)))),
        max(1, int(np.ceil(np.log2(static.fanout + 1)))),
    )


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def lookup(state: UpLIFState, queries, *, static: UpLIFStatic):
    """Batched point lookup -> (found bool[n], values int64[n]). The state
    is read-only."""
    with tracing.span("fops.lookup"):
        j, _ = _locate(static, state.slots.keys, state.model, queries)
        _, alive, vals, _ = _probe(
            state.slots.keys, state.slots.vals, state.slots.occ, j, queries
        )
        ranks = _bmat_rank(static, state.bmat, queries)
        _, b_alive, b_vals, _ = _bmat_probe(state.bmat, ranks, queries)
        b_alive = b_alive & ~alive
        return alive | b_alive, torch.where(b_alive, b_vals, vals)


# ---------------------------------------------------------------------------
# insert — grid-segment accept + bounded shift + fill-forward repair
# ---------------------------------------------------------------------------


def _dedup_last_wins(keys):
    """Mask of entries that are NOT the last occurrence of their key."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    dup = torch.zeros_like(keys, dtype=torch.bool)
    dup[:-1] = ks[1:] == ks[:-1]
    out = torch.empty_like(dup)
    out[order] = dup
    return out


def _merge_pending(static, bmat: BMATState, keys, vals, pending, n_bmat_live):
    """Route the still-pending batch into the BMAT arrays (value updates for
    keys already buffered — incl. tombstone revival — sorted merge for fresh
    ones). The caller guarantees capacity >= size + |pending| + 1."""
    bcap = bmat.keys.shape[0]
    qk = torch.where(pending, keys, KEY_MAX)
    ranks = _bmat_rank(static, bmat, qk)
    idx = torch.clamp(ranks.to(torch.int64), max=bcap - 1)
    present = (bmat.keys[idx] == qk) & pending
    revived = (present & (bmat.vals[idx] == TOMBSTONE)).sum()
    new_vals = _scatter_drop(bmat.vals, idx, vals, present)
    fresh = pending & ~present
    mk = torch.where(fresh, keys, KEY_MAX)
    order = torch.argsort(mk, stable=True)
    mk = mk[order]
    mv = torch.where(fresh, vals, 0)[order]
    n_new = fresh.sum()
    keys2, vals2, size2 = _merge(
        bmat.keys, new_vals, bmat.size, mk, mv, n_new.to(torch.int32)
    )
    out = BMATState(
        keys=keys2, vals=vals2, fences=_make_fences(keys2, static.fanout),
        size=size2,
    )
    return out, n_bmat_live + revived + n_new, pending.sum()


def insert(state: UpLIFState, keys, vals, *, static: UpLIFStatic,
           check_bmat: bool = True, merge_overflow: bool = True):
    """Batched upsert. ``keys`` is KEY_MAX-padded.

    Round structure (static.insert_rounds):
      1. locate + probe: keys already in place get a value update (incl.
         tombstone revival); keys live in the BMAT get updated there
         (round 1 only — the pending set can't gain such keys mid-call);
      2. grid-segment accept (K7): each pending key maps to the W-aligned
         window holding its insertion slot; the first pending key of each
         segment is accepted, and all accepted windows run through one
         bounded shift + fill-forward repair.
    Leftovers merge into the BMAT, unless ``merge_overflow=False``: the
    subset retrain re-homes BMAT keys itself and passes both flags off
    (``check_bmat=False`` skips the BMAT value update of round 1).
    """
    W = static.window
    cap = state.slots.keys.shape[0]
    if cap % W:
        raise ValueError("slot capacity must be W-aligned (nullifier align)")
    with tracing.span("fops.insert.place"):
        # the insert's own slot copies, each with one spare W-row at the end
        sk_buf, sv_buf, so_buf = (
            torch.cat([a, a[-W:]]) for a in state.slots
        )
        sk, sv, so = sk_buf[:cap], sv_buf[:cap], so_buf[:cap]
        bmat = state.bmat
        c = state.counters

        pending = (keys != KEY_MAX) & ~_dedup_last_wins(keys)
        n_keys, n_bmat_live = c.n_keys, c.n_bmat_live
        # the rounds add their placed keys here and lower the granularity
        n_placed = torch.zeros((), dtype=torch.int64, device=keys.device)
        min_gran = c.min_granularity.clone()

        for rnd in range(max(1, static.insert_rounds)):
            tracing.count("insert.rounds")
            qk = torch.where(pending, keys, KEY_MAX)
            j, icap = _locate(static, sk, state.model, qk)
            if rnd == 0:
                # upsert keys already in the slot array (revives tombstones)
                hit, alive, _, jj = _probe(sk, sv, so, j, qk)
                n_keys = n_keys + (hit & ~alive).sum()
                sv_buf[torch.where(hit, jj, cap)] = vals
                pending = pending & ~hit
                if check_bmat:
                    # keys live in the BMAT -> value update there
                    ranks = _bmat_rank(static, bmat, qk)
                    _, b_alive, _, bidx = _bmat_probe(bmat, ranks, qk)
                    upd = b_alive & pending
                    bmat = bmat._replace(
                        vals=_scatter_drop(bmat.vals, bidx, vals, upd))
                    pending = pending & ~upd

            # K7: grid-segment accept, bounded shift and fill-forward repair
            # of the accepted windows
            ok, _ = window_insert(
                sk_buf, sv_buf, so_buf, keys, vals, j, icap, pending,
                cap=cap, total=cap, window=W, movement_k=static.movement_k,
                n_placed=n_placed, min_span=min_gran,
            )
            pending = pending & ~ok
        n_inplace = c.n_inplace + n_placed
        n_keys = n_keys + n_placed

    n_over = torch.zeros((), dtype=torch.int64, device=keys.device)
    if merge_overflow:
        with tracing.span("fops.insert.merge"):
            bmat, n_bmat_live, n_over = _merge_pending(
                static, bmat, keys, vals, pending, n_bmat_live
            )
    counters = Counters(
        n_keys=n_keys,
        n_bmat_live=n_bmat_live,
        n_inplace=n_inplace,
        n_overflow=c.n_overflow + n_over,
        min_granularity=min_gran,
    )
    new_state = UpLIFState(
        slots=SlotsState(keys=sk, vals=sv, occ=so),
        model=state.model,
        bmat=bmat,
        counters=counters,
    )
    return new_state, InsertResult(pending=pending, n_overflow=n_over)


# ---------------------------------------------------------------------------
# delete
# ---------------------------------------------------------------------------


def delete(state: UpLIFState, keys, *, static: UpLIFStatic):
    """Batched tombstone delete -> (state, hit bool[n]). Every occurrence of
    a deleted key reports a hit, but tombstones/counters apply once per
    distinct key (duplicates are masked out of the canonical set)."""
    sk, sv, so = state.slots
    bmat = state.bmat
    canonical = ~_dedup_last_wins(keys)

    j, _ = _locate(static, sk, state.model, keys)
    _, alive, _, jj = _probe(sk, sv, so, j, keys)
    once = alive & canonical
    sv = _scatter_drop(sv, jj, TOMBSTONE, once)

    ranks = _bmat_rank(static, bmat, keys)
    _, b_alive, _, bidx = _bmat_probe(bmat, ranks, keys)
    b_alive = b_alive & ~alive
    b_once = b_alive & canonical
    bvals = _scatter_drop(bmat.vals, bidx, TOMBSTONE, b_once)

    c = state.counters
    counters = c._replace(
        n_keys=c.n_keys - once.sum(),
        n_bmat_live=c.n_bmat_live - b_once.sum(),
    )
    new_state = UpLIFState(
        slots=SlotsState(keys=sk, vals=sv, occ=so),
        model=state.model,
        bmat=bmat._replace(vals=bvals),
        counters=counters,
    )
    return new_state, alive | b_alive


# ---------------------------------------------------------------------------
# range scan — fixed-width slice per query + masked merge with the BMAT
# ---------------------------------------------------------------------------


def range_scan(state: UpLIFState, lo, hi, *, static: UpLIFStatic,
               max_out: int) -> RangeResult:
    """Batched range extraction: the sorted live (key, value) pairs with
    lo <= key <= hi, at most ``max_out`` per query, as fixed-shape
    KEY_MAX-padded rows plus per-query counts.

    Each query reads ``L = min(4 * max_out, cap)`` slots from the located
    start of ``lo`` and ``M = min(max_out, bcap)`` BMAT entries from
    ``rank(lo)``; the two sorted streams merge and the ``max_out`` smallest
    keys stay. JAX's ``dynamic_slice`` is a gather at ``start + arange``
    (the starts are clipped, so every index is in range); both argsorts are
    stable, so KEY_MAX ties and a key present in both streams keep JAX's
    order."""
    sk, sv, so = state.slots
    bmat = state.bmat
    cap = sk.shape[0]
    L = min(4 * max_out, cap)
    dev = lo.device

    j, _ = _locate(static, sk, state.model, lo)
    jj = torch.clamp(j, 0, cap - 1)
    s = torch.where((j >= 0) & (sk[jj] == lo), jj, j + 1)
    s = torch.clamp(s, 0, cap - L)
    idx = s[:, None] + torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    seg_k, seg_v, seg_o = sk[idx], sv[idx], so[idx]
    ok = (seg_o & (seg_k >= lo[:, None]) & (seg_k <= hi[:, None])
          & (seg_v != TOMBSTONE))
    a_k = torch.where(ok, seg_k, KEY_MAX)
    # in-slice keys are already sorted; pushing invalids to KEY_MAX keeps
    # the valid prefix sorted under a stable argsort
    a_ord = torch.argsort(a_k, dim=1, stable=True)[:, :max_out]
    a_v = torch.take_along_dim(torch.where(ok, seg_v, 0), a_ord, dim=1)
    a_k = torch.take_along_dim(a_k, a_ord, dim=1)

    # buffered slice: [rank(lo), rank(hi + 1))
    bcap = bmat.keys.shape[0]
    M = min(max_out, bcap)
    hi_safe = torch.clamp(hi, max=KEY_MAX - 1)
    r0 = _bmat_rank(static, bmat, lo).to(torch.int64)
    r1 = _bmat_rank(static, bmat, hi_safe + 1).to(torch.int64)
    b_start = torch.clamp(r0, 0, bcap - M)
    b_abs = b_start[:, None] + torch.arange(M, dtype=torch.int64,
                                            device=dev)[None, :]
    b_k, b_v = bmat.keys[b_abs], bmat.vals[b_abs]
    b_ok = ((b_abs >= r0[:, None]) & (b_abs < r1[:, None])
            & (b_k >= lo[:, None]) & (b_k <= hi[:, None])
            & (b_v != TOMBSTONE))
    b_k = torch.where(b_ok, b_k, KEY_MAX)
    b_v = torch.where(b_ok, b_v, 0)

    # merge the two sorted streams, keep the max_out smallest
    m_k = torch.cat([a_k, b_k], dim=1)
    m_v = torch.cat([a_v, b_v], dim=1)
    m_ord = torch.argsort(m_k, dim=1, stable=True)[:, :max_out]
    out_k = torch.take_along_dim(m_k, m_ord, dim=1)
    out_v = torch.take_along_dim(m_v, m_ord, dim=1)
    count = (out_k != KEY_MAX).sum(dim=1).to(torch.int32)
    return RangeResult(keys=out_k, vals=out_v, count=count)


# ---------------------------------------------------------------------------
# logical rank (paper Eq. 1)
# ---------------------------------------------------------------------------


def _live_rank(keys, vals, occ, q):
    """Per row of ``keys`` ([S, cap], non-decreasing along each row — the
    fill-forward invariant), the count of live slots with key < q for
    every query q ([S, N] -> int64 [S, N]). Because the keys are sorted,
    the slots with key < q are the prefix up to ``searchsorted_left(q)``,
    so the count is a prefix count of live slots read there: one scan over
    the S·cap slots and O(S·N·log cap) searches, never the [N, cap]
    broadcast the reference's reduce describes. The scan runs over the
    flat [S·cap] view (a single-row scan, which torch runs as one device
    scan) and each row subtracts its own base."""
    S, cap = keys.shape
    live = (occ & (vals != TOMBSTONE)).reshape(-1)
    pref = torch.cat([live.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(live, 0, dtype=torch.int64)])
    base = torch.arange(S, device=keys.device)[:, None] * cap
    pos = torch.searchsorted(keys, q)
    return pref[base + pos] - pref[base]


def adjusted_rank(state: UpLIFState, queries, *, static: UpLIFStatic):
    """M'(k) = live in-place rank + BMAT bias r(k), exact."""
    sk, sv, so = state.slots
    arr_rank = _live_rank(sk[None], sv[None], so[None], queries[None])[0]
    return arr_rank + _bmat_rank(static, state.bmat, queries).to(torch.int64)


# ---------------------------------------------------------------------------
# stacked (sharded) op suite — S shards, one flat program
#
# The router (repro_torch/core/sharded.py) stores S shards as one stacked
# state ([S, ...] leaves, equal per-shard shapes). These variants flatten
# the shard axis: queries arrive as one padded batch with a per-query shard
# id, and every gather and scatter goes through the [S*cap] view with a
# ``sid``-derived offset, so the op count matches the single-shard program.
# The fused branches launch K1 and K2 once for all S shards, with the shard
# ids.
#
# Keys are range-partitioned across shards, so sorting a batch by key also
# groups it by shard: the grid-segment accept and the segmented BMAT merge
# both lean on that.
# ---------------------------------------------------------------------------


def _locate_stacked(static: UpLIFStatic, slot_keys, model, q, sid,
                    codes=None):
    """Shard-local (j, ins_cap) of the last slot of shard ``sid`` with
    key <= q (the ``_locate`` contract). ``slot_keys`` is [S, cap]; ``q``
    and ``sid`` are flat [N].

    When ``static.locate`` is a sorted tuple of distinct strategies,
    ``codes`` (int32[S], indices into the tuple) assigns each shard its
    strategy: every strategy runs over the full batch and each query keeps
    the (j, ins_cap) pair of its own shard's branch."""
    if isinstance(static.locate, tuple):
        sel = codes[sid]
        j = icap = None
        for i, strat in enumerate(static.locate):
            ji, ici = _locate_stacked(
                static._replace(locate=strat), slot_keys, model, q, sid
            )
            if j is None:
                j, icap = ji, ici
            else:
                m = sel == i
                j = torch.where(m, ji, j)
                icap = torch.where(m, ici, icap)
        return j, icap

    S, cap = slot_keys.shape
    flat = slot_keys.reshape(-1)
    base = sid * cap

    if static.locate == LOCATE_BINSEARCH:
        n_iters = max(1, int(np.ceil(np.log2(cap + 1))))
        lo = torch.zeros_like(q)
        hi = torch.full_like(q, cap)
        for _ in range(n_iters):
            mid = (lo + hi) >> 1
            go = flat[base + torch.clamp(mid, max=cap - 1)] <= q
            lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
        return lo - 1, torch.full_like(q, cap - 1)

    T = model.table.shape[1]
    K = model.spline_keys.shape[1]
    if static.locate == LOCATE_FUSED:
        # K1: one launch for all S shards; the arrays flatten over the
        # shard axis and each query carries its shard id
        return kops.fused_locate(
            model.table.reshape(-1), model.spline_keys.reshape(-1),
            model.spline_pos.reshape(-1), model.shift, flat, q, sid,
            n_table=T, n_knots=K, cap=cap, window=static.window,
            rs_iters=static.rs_iters,
        )

    W = static.window
    L = min(3 * W, cap)  # the 3-row span of ``_locate``
    n_bisect = max(1, int(np.ceil(np.log2(L))))
    tflat = model.table.reshape(-1)
    skflat = model.spline_keys.reshape(-1)
    spflat = model.spline_pos.reshape(-1)
    tbase = sid * T
    sbase = sid * K

    # the bounded searches run in flat coordinates
    n_buckets = T - 2
    b = torch.clamp(q >> model.shift[sid].to(q.dtype), 0, n_buckets - 1)
    lo = sbase + torch.clamp(tflat[tbase + b].to(torch.int64), min=1) - 1
    hi = sbase + torch.clamp(tflat[tbase + b + 1].to(torch.int64), 0, K - 2)
    for _ in range(static.rs_iters):
        mid = (lo + hi + 1) >> 1
        go = skflat[mid] <= q
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    seg = torch.clamp(lo - sbase, 0, K - 2) + sbase
    k0 = skflat[seg]
    k1 = skflat[seg + 1]
    p0 = spflat[seg]
    p1 = spflat[seg + 1]
    dk = (q - k0).to(torch.float64)
    span = torch.clamp((k1 - k0).to(torch.float64), min=1.0)
    t = torch.clamp(dk / span, 0.0, 1.0)
    p = p0 + t * (p1 - p0)

    c = torch.clamp(torch.round(p).to(torch.int64), 0, cap - 1)
    start = torch.clamp((c // W - 1) * W, 0, max(cap - L, 0))
    lo = base + start
    hi = base + torch.clamp(start + L - 1, max=cap - 1)
    for _ in range(n_bisect):
        mid = (lo + hi + 1) >> 1
        go = flat[mid] <= q
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    j = torch.where(flat[base + start] <= q, lo - base, start - 1)
    return j, start + (L - 1)


def _probe_stacked(slots: SlotsState, j, q, sid):
    S, cap = slots.keys.shape
    jj = torch.clamp(j, 0, cap - 1)
    g = sid * cap + jj
    kk = slots.keys.reshape(-1)[g]
    vv = slots.vals.reshape(-1)[g]
    oo = slots.occ.reshape(-1)[g]
    hit = (j >= 0) & (kk == q) & oo & (q != KEY_MAX)
    alive = hit & (vv != TOMBSTONE)
    return hit, alive, torch.where(alive, vv, 0), jj


def _bmat_rank_stacked(static: UpLIFStatic, bmat: BMATState, q, sid,
                       codes=None):
    """Shard-local searchsorted-left rank (int64); q/sid are flat [N].

    Mixed per-shard strategies need at most two passes: the plain rank
    depends only on ``bmat_kind`` (spline and binsearch shards share it),
    so only a fused-versus-plain split of the batch remains."""
    if isinstance(static.locate, tuple):
        rj = _bmat_rank_stacked(
            static._replace(locate=LOCATE_BINSEARCH), bmat, q, sid
        )
        if LOCATE_FUSED not in static.locate:
            return rj
        rf = _bmat_rank_stacked(
            static._replace(locate=LOCATE_FUSED), bmat, q, sid
        )
        sel = codes[sid]
        return torch.where(sel == static.locate.index(LOCATE_FUSED), rf, rj)

    S, cap = bmat.keys.shape
    nf = bmat.fences.shape[1]
    kflat = bmat.keys.reshape(-1)
    base = sid * cap
    if static.locate == LOCATE_FUSED:
        # K2: one launch for all S BMATs, with the shard ids
        return k2_rank(kflat, bmat.fences.reshape(-1), q, sid, cap=cap, nf=nf,
                       fanout=static.fanout)
    if static.bmat_kind == RBMAT:
        levels = max(1, int(np.log2(cap)))
        t = torch.zeros_like(q)
        for lvl in range(levels):
            stride = 1 << (levels - 1 - lvl)
            s = torch.clamp((2 * t + 1) * stride - 1, max=cap - 1)
            t = 2 * t + (kflat[base + s] < q).to(t.dtype)
        return torch.clamp(t, max=cap)

    # flat-coordinate searches; mid <= fbase + nf - 1 holds throughout, so
    # the fence gather needs no clamp
    fanout = static.fanout
    fflat = bmat.fences.reshape(-1)
    fbase = sid * nf
    lo, hi = fbase, fbase + (nf - 1)
    for _ in range(max(1, int(np.ceil(np.log2(nf + 1))))):
        mid = (lo + hi) >> 1
        go = fflat[mid] < q
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    nlo = base + torch.clamp(lo - fbase - 1, min=0) * fanout
    nhi = torch.minimum(nlo + fanout, base + cap)
    kcap = base + (cap - 1)
    for _ in range(max(1, int(np.ceil(np.log2(fanout + 1))))):
        mid = (nlo + nhi) >> 1
        go = kflat[torch.minimum(mid, kcap)] < q
        nlo, nhi = torch.where(go, mid + 1, nlo), torch.where(go, nhi, mid)
    return torch.clamp(nlo - base, max=cap)


def _bmat_probe_stacked(bmat: BMATState, ranks, q, sid):
    S, cap = bmat.keys.shape
    idx = torch.clamp(ranks, max=cap - 1)
    g = sid * cap + idx
    kk = bmat.keys.reshape(-1)[g]
    vv = bmat.vals.reshape(-1)[g]
    present = (kk == q) & (q != KEY_MAX)
    alive = present & (vv != TOMBSTONE)
    return present, alive, torch.where(alive, vv, 0), idx


def _seg_add(S: int, sid, mask):
    """Per-shard count of True entries (int64[S])."""
    return torch.bincount(torch.where(mask, sid, S), minlength=S + 1)[:S]


def _route_on_device(boundaries, q):
    """Per-query shard id from the S-1 partition boundaries."""
    return torch.searchsorted(boundaries, q, right=True)


def slookup(state: UpLIFState, q, boundaries, codes=None, *,
            static: UpLIFStatic):
    """Stacked lookup: state leaves are [S, ...]; q is flat [N]. ``codes``
    is the per-shard strategy index (None unless ``static.locate`` is a
    mixed tuple — see ``_locate_stacked``)."""
    sid = _route_on_device(boundaries, q)
    j, _ = _locate_stacked(static, state.slots.keys, state.model, q, sid,
                           codes)
    _, alive, vals, _ = _probe_stacked(state.slots, j, q, sid)
    ranks = _bmat_rank_stacked(static, state.bmat, q, sid, codes)
    _, b_alive, b_vals, _ = _bmat_probe_stacked(state.bmat, ranks, q, sid)
    b_alive = b_alive & ~alive
    return alive | b_alive, torch.where(b_alive, b_vals, vals)


def sdelete(state: UpLIFState, q, boundaries, codes=None, *,
            static: UpLIFStatic):
    """Stacked tombstone delete -> (state, hit [N])."""
    S, cap = state.slots.keys.shape
    sid = _route_on_device(boundaries, q)
    canonical = ~_dedup_last_wins(q)

    j, _ = _locate_stacked(static, state.slots.keys, state.model, q, sid,
                           codes)
    _, alive, _, jj = _probe_stacked(state.slots, j, q, sid)
    once = alive & canonical
    sv = _scatter_drop(state.slots.vals.reshape(-1), sid * cap + jj,
                       TOMBSTONE, once).reshape(S, cap)

    bcap = state.bmat.keys.shape[1]
    ranks = _bmat_rank_stacked(static, state.bmat, q, sid, codes)
    _, b_alive, _, bidx = _bmat_probe_stacked(state.bmat, ranks, q, sid)
    b_alive = b_alive & ~alive
    b_once = b_alive & canonical
    bvals = _scatter_drop(state.bmat.vals.reshape(-1), sid * bcap + bidx,
                          TOMBSTONE, b_once).reshape(S, bcap)

    c = state.counters
    counters = c._replace(
        n_keys=c.n_keys - _seg_add(S, sid, once),
        n_bmat_live=c.n_bmat_live - _seg_add(S, sid, b_once),
    )
    new_state = state._replace(
        slots=state.slots._replace(vals=sv),
        bmat=state.bmat._replace(vals=bvals),
        counters=counters,
    )
    return new_state, alive | b_alive


def srank(state: UpLIFState, q, boundaries, codes=None, *,
          static: UpLIFStatic):
    """Stacked shard-local adjusted rank. Every query is searched in every
    shard's row (S searches per query, no [N, cap] tensor) and keeps the
    count of its own shard."""
    sid = _route_on_device(boundaries, q)
    S = state.slots.keys.shape[0]
    ranks = _live_rank(*state.slots, q[None].expand(S, -1).contiguous())
    arr_rank = torch.gather(ranks, 0, sid[None])[0]
    return arr_rank + _bmat_rank_stacked(static, state.bmat, q, sid, codes)


def _merge_pending_stacked(static, bmat: BMATState, keys, vals, pending, sid,
                           n_bmat_live, codes=None):
    """Segmented (per-shard) BMAT merge over the flat [S*bcap] view; each
    scatter aims its masked-out rows at one spare trailing element."""
    S, bcap = bmat.keys.shape
    dev = keys.device
    qk = torch.where(pending, keys, KEY_MAX)
    ranks = _bmat_rank_stacked(static, bmat, qk, sid, codes)
    present, _, _, idx = _bmat_probe_stacked(bmat, ranks, qk, sid)
    present = present & pending
    bv_flat = bmat.vals.reshape(-1)
    revived = present & (bv_flat[sid * bcap + idx] == TOMBSTONE)
    new_vals = _scatter_drop(bv_flat, sid * bcap + idx, vals, present)
    fresh = pending & ~present
    cnt = _seg_add(S, sid, fresh)            # fresh keys per shard
    shard_start = torch.cumsum(cnt, 0) - cnt  # exclusive prefix

    # keys are range-partitioned, so sorting by key groups fresh entries by
    # shard while ordering them within the shard
    mk = torch.where(fresh, keys, KEY_MAX)
    order = torch.argsort(mk, stable=True)
    mk = mk[order]
    mv = torch.where(fresh, vals, 0)[order]
    fr = fresh[order]
    sid_s = torch.where(fr, sid[order], 0)
    r2 = _bmat_rank_stacked(static, bmat, mk, sid_s, codes)
    g_idx = torch.cumsum(fr, 0) - 1          # global index among fresh
    within = g_idx - shard_start[sid_s]
    new_pos = r2 + within
    tgt = torch.where(fr, sid_s * bcap + new_pos, S * bcap)

    N = mk.shape[0]
    mark = torch.zeros(S * bcap + 1, dtype=torch.int32, device=dev)
    mark[tgt] = 1
    new_at = torch.full((S * bcap + 1,), -1, dtype=torch.int32, device=dev)
    new_at[tgt] = torch.arange(N, dtype=torch.int32, device=dev)
    cum = torch.cumsum(mark[:-1], 0).reshape(S, bcap)
    seg_base = torch.cat([cum.new_zeros(1), cum[:-1, -1]])
    nb = cum - seg_base[:, None]
    i = torch.arange(bcap, dtype=torch.int64, device=dev)[None, :]
    new_at = new_at[:-1].reshape(S, bcap)
    is_new = new_at >= 0
    old_idx = torch.clamp(i - nb, 0, bcap - 1)
    from_old = ~is_new & ((i - nb) < bmat.size[:, None])
    pick = torch.clamp(new_at, 0, N - 1).to(torch.int64)
    bbase = (torch.arange(S, dtype=torch.int64, device=dev) * bcap)[:, None]
    g = bbase + old_idx
    out_keys = torch.where(
        is_new, mk[pick],
        torch.where(from_old, bmat.keys.reshape(-1)[g], KEY_MAX),
    )
    out_vals = torch.where(is_new, mv[pick],
                           torch.where(from_old, new_vals[g], 0))
    out = BMATState(
        keys=out_keys,
        vals=out_vals,
        fences=_make_fences_stacked(out_keys, static.fanout),
        size=bmat.size + cnt.to(bmat.size.dtype),
    )
    n_over = _seg_add(S, sid, pending)
    return out, n_bmat_live + _seg_add(S, sid, revived) + cnt, n_over


def _make_fences_stacked(keys, fanout: int):
    S = keys.shape[0]
    tail = torch.full((S, 1), KEY_MAX, dtype=keys.dtype, device=keys.device)
    return torch.cat([keys[:, ::fanout], tail], dim=1)


def sinsert(state: UpLIFState, keys, vals, boundaries, codes=None, *,
            static: UpLIFStatic):
    """Stacked upsert: keys/vals are flat [N]. One flat program: the grid
    windows of all shards tile the concatenated slot array (per-shard
    capacities are W-aligned), so the global grid-segment accept and the
    window writeback run as in ``insert`` on the [S*cap] view (copied once,
    with one spare W-row)."""
    W = static.window
    S, cap = state.slots.keys.shape
    if cap % W:
        raise ValueError("slot capacity must be W-aligned (nullifier align)")
    total = S * cap
    sid = _route_on_device(boundaries, keys)
    sk_buf, sv_buf, so_buf = (
        torch.cat([a.reshape(-1), a.reshape(-1)[-W:]]) for a in state.slots
    )
    sk, sv = sk_buf[:total], sv_buf[:total]
    bmat = state.bmat
    c = state.counters

    pending = (keys != KEY_MAX) & ~_dedup_last_wins(keys)
    n_keys, n_bmat_live = c.n_keys, c.n_bmat_live
    n_inplace, min_gran = c.n_inplace, c.min_granularity

    for rnd in range(max(1, static.insert_rounds)):
        tracing.count("insert.rounds")
        qk = torch.where(pending, keys, KEY_MAX)
        j, icap = _locate_stacked(static, sk.view(S, cap), state.model, qk,
                                  sid, codes)
        if rnd == 0:
            slots2 = SlotsState(keys=sk.view(S, cap), vals=sv.view(S, cap),
                                occ=so_buf[:total].view(S, cap))
            hit, alive, _, jj = _probe_stacked(slots2, j, qk, sid)
            n_keys = n_keys + _seg_add(S, sid, hit & ~alive)
            sv_buf[torch.where(hit, sid * cap + jj, total)] = vals
            ranks = _bmat_rank_stacked(static, bmat, qk, sid, codes)
            _, b_alive, _, bidx = _bmat_probe_stacked(bmat, ranks, qk, sid)
            upd = b_alive & pending
            bcap = bmat.keys.shape[1]
            bvals = _scatter_drop(bmat.vals.reshape(-1), sid * bcap + bidx,
                                  vals, upd).reshape(S, bcap)
            bmat = bmat._replace(vals=bvals)
            pending = pending & ~hit & ~upd

        # K7 over the flat view: each key's grid row is its shard's
        ok, failed_span = window_insert(
            sk_buf, sv_buf, so_buf, keys, vals, j, icap, pending, sid,
            cap=cap, total=total, window=W, movement_k=static.movement_k,
        )
        ok_per = _seg_add(S, sid, ok)
        n_inplace = n_inplace + ok_per
        n_keys = n_keys + ok_per
        span_per = torch.full((S + 1,), _I64_MAX, dtype=torch.int64,
                              device=keys.device).scatter_reduce(
            0, torch.where(failed_span < _I64_MAX, sid, S), failed_span,
            reduce="amin",
        )[:S]
        min_gran = torch.minimum(min_gran, span_per)
        pending = pending & ~ok

    bmat, n_bmat_live, n_over = _merge_pending_stacked(
        static, bmat, keys, vals, pending, sid, n_bmat_live, codes
    )
    counters = Counters(
        n_keys=n_keys,
        n_bmat_live=n_bmat_live,
        n_inplace=n_inplace,
        n_overflow=c.n_overflow + n_over,
        min_granularity=min_gran,
    )
    new_state = UpLIFState(
        slots=SlotsState(keys=sk.view(S, cap), vals=sv.view(S, cap),
                         occ=so_buf[:total].view(S, cap)),
        model=state.model,
        bmat=bmat,
        counters=counters,
    )
    return new_state, InsertResult(pending=pending, n_overflow=n_over.sum())
