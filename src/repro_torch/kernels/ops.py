"""Adapters between the index ops and the kernels, and the kernel-level
predict/search/rank API (port of ``repro/kernels/ops.py``).

The JAX adapters split int64 keys into (hi, lo) halves, pad batches to the
Pallas block sizes and pick interpret mode off the TPU. The port needs none
of that: the kernels read int64 directly and mask their own ragged edge.
What remains is the shard-id signature (the stacked ops of the router pass
a shard id per query), the shape guards, the float32 casts of the E-step
and the platform gate. The stacked and single-index ranks call K2
(``kernels.bmat_rank.bmat_rank``) directly: it takes any BMAT size.

The kernel-level API keeps the reference's names and contracts:
``spline_lookup`` (K5, the batched predict), ``route_and_search`` (K4 over
the tile of each query's predicted position) and ``bmat_rank`` (K2, or the
two-level composition over K4 above ``TILED_RANK_ABOVE`` keys, as the
reference routes it). ``TILE`` and ``Q_BLK`` are part of that contract:
which queries come back ``ok`` and how many passes a duplicated batch takes
depend on them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bmat_rank as _rank
from repro_torch.kernels import gmm_estep as _estep
from repro_torch.kernels import ragged_dot as _ragged
from repro_torch.kernels import spline_corridor as _corridor
from repro_torch.kernels import spline_lookup as _locate
from repro_torch.kernels import tile_search as _tiles
from repro_torch.kernels import window_insert as _window
from repro_torch.kernels.tile_search import Q_BLK, TILE

MAX_F32_POSITIONS = 1 << 24  # f32 slot positions are exact below this
# The buffer size above which the reference's ``bmat_rank`` leaves its rank
# kernel for the tiled composition (its VMEM budget, ``MAX_VMEM_KEYS``).
# The port's K2 takes any size; the switch is kept so that the port's entry
# takes the same route as the reference on the same input.
TILED_RANK_ABOVE = 131072


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller passes
    another device. Raises when CUDA is asked for (or defaulted to) and
    absent — nothing quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev


def native_kernels(device) -> bool:
    """True where the hand-written kernels run natively (a CUDA device)."""
    return torch.device(device).type == "cuda"


def locate_fusable(cap: int, n_knots: int) -> bool:
    """Whether the fused locate computes the TPU kernel's float32
    interpolation exactly: the per-shard capacity stays within the f32
    position bound and the model has at least one real spline segment.
    (The TPU's VMEM residency budgets do not apply: the CUDA kernel reads
    its arrays from HBM.) Above the bound the JAX package falls back to its
    float64 spline path, and ``fused_locate`` asks K1 for that path's
    float64 interpolation instead."""
    return cap <= MAX_F32_POSITIONS and n_knots >= 2


def fused_locate(
    table, spline_keys, spline_pos, shift, slot_keys, queries, sid=None,
    *, n_table: int, n_knots: int, cap: int, window: int, rs_iters: int,
):
    """K1 adapter: flat-over-shards arrays (float64 ``spline_pos``, read
    as stored), per-shard int32 ``shift`` [S], shard id ``sid`` per query
    (None for a single shard). Returns int64 ``(j, icap)`` with the
    ``fops._locate`` contract. Interpolates in float32 where
    ``locate_fusable`` holds, else in float64."""
    j, start = _locate.fused_locate(
        table, spline_keys, spline_pos, shift, slot_keys, queries, sid,
        n_table=n_table, n_knots=n_knots, cap=cap, window=window,
        rs_iters=rs_iters, interp64=not locate_fusable(cap, n_knots),
    )
    return j, start + (_locate.span_length(window, cap) - 1)


def gmm_estep(x, weights, means, stds):
    """K3 adapter: float32 responsibilities [N, K] of the mixture
    (``weights``, ``means``, ``stds``) at the samples ``x``, with the JAX
    adapter's float32 casts. No padding: the kernel masks its ragged
    edge."""
    f32 = torch.float32
    return _estep.gmm_estep(x.to(f32), weights.to(f32), means.to(f32),
                            stds.to(f32))


# -- the kernel-level predict / search / rank API ----------------------------


def spline_lookup(table, spline_keys, spline_pos, shift, queries, n_iters):
    """Batched learned-index predict: float32 positions (K5). On CUDA the
    kernel runs in both shift regimes; the reference leaves shifts below
    32 to a plain path, whose rounding K5 reproduces there."""
    return _locate.spline_lookup(table, spline_keys, spline_pos, queries,
                                 shift=int(shift), n_iters=int(n_iters))


def _tile_buckets(tile_id, block: int):
    """Sort-based per-tile query bucketing. Returns (order, t_sorted, flat,
    ok): the queries' stable sort by tile, their tiles in that order, their
    slot in the reference's (n_tiles, block) query buffer, and the capacity
    mask (entries beyond ``block`` per tile are not ``ok``)."""
    order = torch.argsort(tile_id, stable=True)
    t_sorted = tile_id[order]
    within = (torch.arange(t_sorted.shape[0], device=t_sorted.device)
              - torch.searchsorted(t_sorted, t_sorted))
    ok = within < block
    flat = t_sorted * block + torch.clamp(within, max=block - 1)
    return order, t_sorted, flat, ok


def _segments(t_sorted, n_tiles: int):
    """K4's segment arrays for tile-sorted queries: ``seg_tile`` [G] and
    ``seg_start`` [G + 1] with G = min(n, n_tiles) (unused trailing
    segments start at n). Built on the device, with no host sync;
    masked-out writes go to one spare trailing entry that is cut off."""
    n = t_sorted.shape[0]
    dev = t_sorted.device
    G = max(1, min(n, n_tiles))
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = t_sorted[1:] != t_sorted[:-1]
    seg = torch.cumsum(first, 0) - 1
    seg_start = torch.full((G + 2,), n, dtype=torch.int64, device=dev)
    seg_start[torch.where(first, seg, G + 1)] = torch.arange(n, device=dev)
    seg_start = seg_start[:G + 1]
    seg_tile = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    seg_tile[torch.where(first, seg, G)] = t_sorted
    return seg_tile[:G], seg_start


def _n_tiles(cap: int) -> int:
    return (cap + TILE - 1) // TILE


def _route_tiles(slot_keys, queries, pred_pos):
    """``route_and_search``'s bucketing: (order, t_sorted, ok) of
    ``_tile_buckets`` and K4's inputs (tile-sorted queries, ``seg_tile``,
    ``seg_start``)."""
    n_tiles = _n_tiles(slot_keys.shape[0])
    tile_id = torch.clamp(pred_pos.to(torch.int64) // TILE, 0, n_tiles - 1)
    order, t_sorted, _, ok = _tile_buckets(tile_id, Q_BLK)
    seg_tile, seg_start = _segments(t_sorted, n_tiles)
    return order, t_sorted, ok, (queries[order], seg_tile, seg_start)


def route_and_search(slot_keys, queries, pred_pos):
    """Route each query to the ``TILE``-slot tile of its predicted position
    (float ``pred_pos``, truncated to an integer) and search that tile
    (K4). Returns ``(j, ok)``: ``ok`` is False for the queries beyond the
    first ``Q_BLK`` routed to one tile (in batch order), as in the
    reference; where ``ok`` holds, ``j`` is the index of the last slot key
    <= q within the predicted tile (tile start - 1 when none is), and where
    it does not, ``j`` is -1. Only the ``ok`` entries are searched and
    written, so an overflowing tile never disturbs its first ``Q_BLK``
    queries (the reference's scatter does; ROADMAP §3)."""
    order, t_sorted, ok, k4_in = _route_tiles(slot_keys, queries, pred_pos)
    local = _tiles.tile_search(slot_keys, *k4_in, pass_idx=0)
    j_sorted = torch.where(ok, t_sorted * TILE + local.to(torch.int64), -1)
    j = torch.empty_like(j_sorted)
    j[order] = j_sorted
    ok_out = torch.empty_like(ok)
    ok_out[order] = ok
    return j, ok_out


def _rank_tiles(keys, queries):
    """``_bmat_rank_tiled``'s routing: (order, t_sorted) and K4's inputs
    (the tile-sorted ``q - 1``, ``seg_tile``, ``seg_start``)."""
    n_tiles = _n_tiles(keys.shape[0])
    qm1 = queries - 1  # keys are non-negative: q - 1 >= -1 orders below all
    firsts = keys[::TILE].contiguous()
    tile_id = torch.clamp(
        torch.searchsorted(firsts, qm1, right=True) - 1, 0, n_tiles - 1)
    order, t_sorted, _, _ = _tile_buckets(tile_id, Q_BLK)
    seg_tile, seg_start = _segments(t_sorted, n_tiles)
    return order, t_sorted, (qm1[order], seg_tile, seg_start)


def _bmat_rank_tiled(keys, queries):
    """Two-level composition over K4 for sorted buffers above
    ``TILED_RANK_ABOVE`` keys. Level 1 routes each query exactly: the rank
    of ``q`` lies in the last tile whose first key is <= q - 1. Level 2
    runs K4 on ``q - 1`` (searchsorted-left rank = 1 + index of the last
    key <= q - 1). As in the reference, one pass takes at most ``Q_BLK``
    queries per tile, so a batch that piles more onto one tile runs further
    passes. One K4 launch runs them all: no segment holds more than ``n``
    queries, so ``ceil(n / Q_BLK)`` passes bound every segment, and no host
    read of the pass count is needed. Returns the int32 rank, at most
    ``cap``."""
    n = queries.shape[0]
    order, t_sorted, k4_in = _rank_tiles(keys, queries)
    local = _tiles.tile_search(keys, *k4_in, pass_idx=0,
                               pass_hi=max(1, -(-n // Q_BLK)))
    r_sorted = torch.clamp(t_sorted * TILE + local + 1, max=keys.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=queries.device)
    out[order] = r_sorted.to(torch.int32)
    return out


def bmat_rank(keys, fences, queries, fanout: int):
    """int32 searchsorted-left rank of each query over one sorted buffer
    (``keys`` with KEY_MAX padding, ``fences`` every ``fanout``-th key plus
    a trailing KEY_MAX), routed as the reference routes it: the tiled K4
    composition above ``TILED_RANK_ABOVE`` keys (the fences are implicit in
    the tile-first keys), K2 below."""
    if keys.shape[0] > TILED_RANK_ABOVE:
        return _bmat_rank_tiled(keys, queries)
    return _rank.bmat_rank(keys, fences, queries, cap=keys.shape[0],
                           nf=fences.shape[0], fanout=fanout).to(torch.int32)


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {
        "fused_locate": _locate.fused_locate.launches,
        "bmat_rank": _rank.bmat_rank.launches,
        "gmm_estep": _estep.gmm_estep.launches,
        "tile_search": _tiles.tile_search.launches,
        "spline_lookup": _locate.spline_lookup.launches,
        "ragged_dot": _ragged.ragged_dot.launches,
        "ragged_dot_wgrad": _ragged.ragged_dot_wgrad.launches,
        "window_insert": _window.window_insert.launches,
        "spline_corridor": _corridor.spline_corridor.launches,
    }


def reset_launch_counts() -> None:
    _locate.fused_locate.launches = 0
    _rank.bmat_rank.launches = 0
    _estep.gmm_estep.launches = 0
    _tiles.tile_search.launches = 0
    _locate.spline_lookup.launches = 0
    _ragged.ragged_dot.launches = 0
    _ragged.ragged_dot_wgrad.launches = 0
    _window.window_insert.launches = 0
    _corridor.spline_corridor.launches = 0
    for wrapper in (_ragged.ragged_dot, _ragged.ragged_dot_wgrad):
        for p in wrapper.launches_by_path:
            wrapper.launches_by_path[p] = 0
