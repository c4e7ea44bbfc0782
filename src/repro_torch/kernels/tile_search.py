"""K4 — the tile search kernel and its plain torch version.

Replaces the TPU kernel ``tile_search_pallas``
(``src/repro/kernels/tile_search.py``): for each query routed to a
``TILE``-key tile of a slot array, the count of the tile's keys that are
<= q, minus one (-1 when there is none), by compare-count. The last,
partial tile counts as padded with int64 max, as the JAX adapters pad it.

The Pallas kernel takes a dense ``(n_tiles, Q_BLK)`` buffer of routed
queries. Here the queries arrive sorted by tile, with one segment per tile
that holds a query: ``seg_tile[g]`` is the tile of segment ``g`` and
``seg_start[g]..seg_start[g + 1]`` its queries (unused trailing segments
start and end at ``n``). Pass ``p`` handles a segment's queries
``p * Q_BLK`` to ``p * Q_BLK + Q_BLK - 1``: one pass is one Pallas launch's
worth of queries per tile. A call runs the passes ``pass_idx`` to
``pass_hi - 1`` (by default the one pass ``pass_idx``) and writes only
their entries to ``out``; the result equals those passes run in order.

The CUDA source is ``csrc/tile_search.cu``; its header says what bounds it
on the H100 and what its design (CTAs that each take an equal share of
the queries, two-stage TMA bulk copies of the tiles, a warp per query) does
about it.
``tile_search`` below launches it for CUDA tensors and runs
``tile_search_plain`` for CPU tensors; ``tile_search.launches`` counts the
CUDA launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE = 2048   # keys per tile
Q_BLK = 512   # queries of one tile per pass
_KEY_MAX = torch.iinfo(torch.int64).max
_CHUNK = 1024  # plain version: queries per compare block (2M compares)


def _pass_range(pass_idx: int, pass_hi):
    """The passes ``[pass_idx, pass_hi)`` of a call (``pass_hi`` None: the
    one pass ``pass_idx``); raises on an empty or negative range."""
    hi = pass_idx + 1 if pass_hi is None else int(pass_hi)
    if not 0 <= pass_idx < hi:
        raise ValueError(f"need 0 <= pass_idx < pass_hi, got {pass_idx}, {hi}")
    return pass_idx, hi


def tile_search_plain(slot_keys, queries, seg_tile, seg_start, *,
                      pass_idx: int = 0, pass_hi=None, out=None):
    """Plain torch version of K4 (same inputs and outputs as the kernel):
    ``slot_keys`` int64 [cap]; ``queries`` int64 [n] sorted by tile;
    ``seg_tile`` int64 [G]; ``seg_start`` int64 [G + 1]. Returns ``out``
    (int32 [n], -1 where not written; allocated when None) with the
    entries of the passes ``pass_idx`` .. ``pass_hi - 1`` written. The
    compare-count runs in blocks of ``_CHUNK`` queries, so no more than 2M
    comparisons exist at once."""
    p_lo, p_hi = _pass_range(pass_idx, pass_hi)
    n = queries.shape[0]
    cap = slot_keys.shape[0]
    dev = queries.device
    if out is None:
        out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    i = torch.arange(n, device=dev)
    g = torch.searchsorted(seg_start, i, right=True) - 1
    within = i - seg_start[g]
    sel = torch.nonzero((within >= p_lo * Q_BLK)
                        & (within < p_hi * Q_BLK)).reshape(-1)
    k = torch.arange(TILE, device=dev)
    for c in torch.split(sel, _CHUNK):
        pos = seg_tile[g[c]][:, None] * TILE + k[None, :]
        keys = torch.where(pos < cap, slot_keys[torch.clamp(pos, max=cap - 1)],
                           _KEY_MAX)
        cnt = (keys <= queries[c][:, None]).sum(dim=1)
        out[c] = (cnt - 1).to(torch.int32)
    return out


def tile_search(slot_keys, queries, seg_tile, seg_start, *,
                pass_idx: int = 0, pass_hi=None, out=None):
    """K4: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Same contract as ``tile_search_plain``; one launch runs every
    pass of the range."""
    p_lo, p_hi = _pass_range(pass_idx, pass_hi)
    if queries.device.type == "cpu":
        return tile_search_plain(slot_keys, queries, seg_tile, seg_start,
                                 pass_idx=p_lo, pass_hi=p_hi, out=out)
    if queries.device.type != "cuda":
        raise ValueError(f"no tile search kernel for {queries.device}")
    for name, x in (("slot_keys", slot_keys), ("queries", queries),
                    ("seg_tile", seg_tile), ("seg_start", seg_start)):
        if x.device != queries.device or x.dtype != torch.int64:
            raise ValueError(f"{name} must be int64 on {queries.device}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    n_seg = seg_tile.shape[0]
    if seg_start.shape[0] != n_seg + 1:
        raise ValueError("seg_start must have one entry more than seg_tile")
    n = queries.shape[0]
    if out is None:
        out = torch.full((n,), -1, dtype=torch.int32, device=queries.device)
    elif (out.device != queries.device or out.dtype != torch.int32
          or out.shape != (n,) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 [{n}] tensor on "
                         f"{queries.device}")
    if n == 0:
        return out
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = build.library().tile_search_launch(
        slot_keys.data_ptr(), queries.data_ptr(), seg_tile.data_ptr(),
        seg_start.data_ptr(), out.data_ptr(), n_seg, n, slot_keys.shape[0],
        p_lo, p_hi, stream,
    )
    build.check(err, "tile_search")
    build.count_launch(tile_search)
    return out


tile_search.launches = 0
