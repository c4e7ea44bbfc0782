"""Batched point operations over one ``UpLIFState`` (port of the
single-index part of ``repro/core/fops.py``).

  * ``lookup(state, q)``     — batched point lookup
  * ``insert(state, k, v)``  — batched upsert incl. BMAT overflow
  * ``delete(state, q)``     — batched tombstone delete

Batches arrive padded with KEY_MAX; ``UpLIFStatic`` carries the host
scalars. The slot capacity must be a multiple of ``static.window``, which
keeps every grid window in bounds.

The insert path is the JAX package's grid-segment formulation: windows are
aligned to a fixed W-grid, so the greedy non-overlapping window choice
collapses to "first pending key per grid segment" — one stable sort and one
segment-boundary compare — and all accepted windows run through one
vectorized bounded shift and fill-forward repair.

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

from repro_torch.core.bmat import RBMAT, _make_fences, _merge, _rank_bpmat, _rank_rbmat
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

_I64_MAX = int(np.iinfo(np.int64).max)


class InsertResult(NamedTuple):
    pending: torch.Tensor     # bool[n] — keys still unplaced after the rounds
    n_overflow: torch.Tensor  # int64 — count routed to the BMAT this call


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
    if static.locate == LOCATE_FUSED and kops.rank_fusable(cap, nf):
        # K2: Definition 1 bias query r(k). The rank is an exact integer
        # search, so it equals both plain traversals for BOTH BMAT kinds.
        return kops.bmat_rank_fused(
            bmat.keys, bmat.fences, queries,
            cap=cap, nf=nf, fanout=static.fanout,
        )
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


def _bmat_probe(bmat: BMATState, ranks, queries):
    """(present, alive, value, index) of a query inside the BMAT arrays."""
    cap = bmat.keys.shape[0]
    idx = torch.clamp(ranks.to(torch.int64), max=cap - 1)
    present = (bmat.keys[idx] == queries) & (queries != KEY_MAX)
    val = bmat.vals[idx]
    alive = present & (val != TOMBSTONE)
    return present, alive, torch.where(alive, val, 0), idx


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def lookup(state: UpLIFState, queries, *, static: UpLIFStatic):
    """Batched point lookup -> (found bool[n], values int64[n]). The state
    is read-only."""
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


def _inplace_window_insert(
    sk_buf, sv_buf, so_buf, cap: int, q_keys, q_vals, starts, accept, valid,
    window: int, movement_k: int,
):
    """One vectorized round of conflict-free in-place window inserts.

    ``sk_buf``/``sv_buf``/``so_buf`` are the insert's own slot copies of
    length cap + W (the last W-row is spare); the accepted rows are written
    into them in place. ``starts`` are sorted grid-aligned window starts;
    ``accept`` marks the per-grid-segment representative (disjoint by
    construction). Returns the success mask and the key span of failed
    windows (granularity measure S2)."""
    W = window
    K = movement_k
    t_idx = torch.arange(W, dtype=torch.int64, device=q_keys.device)[None, :]
    idx = starts[:, None] + t_idx
    w_k = sk_buf[idx]
    w_v = sv_buf[idx]
    w_o = so_buf[idx]

    k_col = q_keys[:, None]
    ip = (w_k < k_col).sum(dim=1, keepdim=True)  # first slot with key >= k

    # nearest empty slot left / right of the insertion point
    left_cand = torch.where(~w_o & (t_idx < ip), t_idx, -1)
    l = left_cand.max(dim=1, keepdim=True).values
    right_cand = torch.where(~w_o & (t_idx >= ip), t_idx, 2 * W)
    r = right_cand.min(dim=1, keepdim=True).values
    ip0, l0, r0 = ip[:, 0], l[:, 0], r[:, 0]

    margin = 2
    in_bounds = (ip0 >= margin) & (ip0 <= W - margin)
    # fill-forward safety: the empty run containing the insertion point must
    # START inside the window (an occupied slot left of ip in-window, or the
    # window begins at slot 0); otherwise empties left of the window would
    # keep a stale fill key and break global sortedness.
    has_left_occ = (w_o & (t_idx < ip)).any(dim=1) | (starts == 0)
    in_bounds = in_bounds & has_left_occ
    r_ok = (r0 < W - 1) & (r0 - ip0 <= K)
    l_ok = (l0 >= 1) & (ip0 - 1 - l0 <= K)
    use_right = r_ok & (~l_ok | (r0 - ip0 <= ip0 - 1 - l0))
    use_left = l_ok & ~use_right
    can = accept & in_bounds & (use_right | use_left)

    ur = use_right[:, None]
    # gather-source schedule for the bounded shift
    src = torch.where(
        ur & (t_idx > ip) & (t_idx <= r),
        t_idx - 1,
        torch.where(~ur & (t_idx >= l) & (t_idx < ip - 1), t_idx + 1, t_idx),
    )
    src = torch.clamp(src, 0, W - 1)
    n_k = torch.gather(w_k, 1, src)
    n_v = torch.gather(w_v, 1, src)
    n_o = torch.gather(w_o, 1, src)

    place = torch.where(use_right, ip0, ip0 - 1)[:, None]
    at = t_idx == place
    n_k = torch.where(at, k_col, n_k)
    n_v = torch.where(at, q_vals[:, None], n_v)
    n_o = n_o | at

    # keep untouched windows byte-identical
    cc = can[:, None]
    n_k = torch.where(cc, n_k, w_k)
    n_v = torch.where(cc, n_v, w_v)
    n_o = torch.where(cc, n_o, w_o)

    # fill-forward repair: an empty slot's fill key = min occupied key at or
    # after it; if none in-window, the unchanged boundary fill of the last
    # slot applies. Both collapse to one reverse cummin.
    m = torch.where(n_o, n_k, KEY_MAX)
    suffix_min = torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])
    n_k = torch.minimum(suffix_min, n_k[:, W - 1:])

    # writeback: accepted windows are distinct grid rows; the rest aim at
    # the spare row
    rows = torch.where(accept, starts // W, cap // W)
    sk_buf.view(-1, W)[rows] = n_k
    sv_buf.view(-1, W)[rows] = n_v
    so_buf.view(-1, W)[rows] = n_o

    span = w_k[:, W - 1] - w_k[:, 0]
    failed_span = torch.where(accept & ~can & valid, span, _I64_MAX)
    return can, failed_span


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


def insert(state: UpLIFState, keys, vals, *, static: UpLIFStatic):
    """Batched upsert. ``keys`` is KEY_MAX-padded.

    Round structure (static.insert_rounds):
      1. locate + probe: keys already in place get a value update (incl.
         tombstone revival); keys live in the BMAT get updated there
         (round 1 only — the pending set can't gain such keys mid-call);
      2. grid-segment accept: each pending key maps to the W-aligned window
         holding its insertion slot; the first pending key of each segment
         is accepted, and all accepted windows run through one vectorized
         bounded shift + fill-forward repair.
    Leftovers merge into the BMAT.
    """
    W = static.window
    cap = state.slots.keys.shape[0]
    if cap % W:
        raise ValueError("slot capacity must be W-aligned (nullifier align)")
    nw = cap // W
    # the insert's own slot copies, each with one spare W-row at the end
    sk_buf, sv_buf, so_buf = (
        torch.cat([a, a[-W:]]) for a in state.slots
    )
    sk, sv, so = sk_buf[:cap], sv_buf[:cap], so_buf[:cap]
    bmat = state.bmat
    c = state.counters

    pending = (keys != KEY_MAX) & ~_dedup_last_wins(keys)
    n_keys, n_bmat_live = c.n_keys, c.n_bmat_live
    n_inplace, min_gran = c.n_inplace, c.min_granularity

    for rnd in range(max(1, static.insert_rounds)):
        qk = torch.where(pending, keys, KEY_MAX)
        j, icap = _locate(static, sk, state.model, qk)
        if rnd == 0:
            # upsert keys already in the slot array (revives tombstones)
            hit, alive, _, jj = _probe(sk, sv, so, j, qk)
            n_keys = n_keys + (hit & ~alive).sum()
            sv_buf[torch.where(hit, jj, cap)] = vals
            pending = pending & ~hit
            # keys live in the BMAT -> value update there
            ranks = _bmat_rank(static, bmat, qk)
            _, b_alive, _, bidx = _bmat_probe(bmat, ranks, qk)
            upd = b_alive & pending
            bmat = bmat._replace(vals=_scatter_drop(bmat.vals, bidx, vals, upd))
            pending = pending & ~upd
            qk = torch.where(pending, keys, KEY_MAX)
            j = torch.where(pending, j, cap - 1)

        # grid-segment accept; clamp to the locate span so a boundary the
        # bounded search could not prove lands in the BMAT, never outside
        # the searched rows
        ins_slot = torch.clamp(torch.minimum(j + 1, icap), 0, cap - 1)
        bucket = torch.where(pending, ins_slot // W, nw + 1)
        order = torch.argsort(bucket, stable=True)  # ties keep key order
        qs = qk[order]
        vs = vals[order]
        bs = bucket[order]
        pend_s = pending[order]
        first = torch.ones_like(pend_s)
        first[1:] = bs[1:] != bs[:-1]
        accept = pend_s & first
        starts = torch.clamp(bs * W, 0, cap - W)
        can, failed_span = _inplace_window_insert(
            sk_buf, sv_buf, so_buf, cap, qs, vs, starts, accept, pend_s,
            W, static.movement_k,
        )
        ok = can & pend_s
        n_ok = ok.sum()
        n_inplace = n_inplace + n_ok
        n_keys = n_keys + n_ok
        min_gran = torch.minimum(min_gran, failed_span.min())
        placed = torch.empty_like(ok)
        placed[order] = ok
        pending = pending & ~placed

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
