"""K1 — the fused locate kernel, K5 — the spline lookup kernel, and their
plain torch versions.

Replaces the TPU kernel ``fused_locate_pallas``
(``src/repro/kernels/spline_lookup.py``). Per query: radix bucket, a
bounded knot bisect, float32 interpolation, a 3-row span start and a
bounded bisect over the slot keys, returning the shard-local ``(j, start)``
pair (``j`` = last slot with key <= q inside the span, ``start - 1`` when
there is none).

The CUDA source is ``csrc/fused_locate.cu``; its header says what bounds it
on the H100 (a chain of dependent reads, i.e. latency, and the launch) and
what its design does about it: a warp per query, the knot bisect as one
32-lane round that counts the knots <= q in the bucket's range, and the
span bisect as two rounds that count the span's slot keys <= q (one probe
per 32-key chunk, then the one chunk where the keys pass q). Counting gives
the bisects' answer because knots and slot keys are sorted within a shard
(the slot keys by the fill-forward invariant); a knot range too wide for
``rs_iters`` steps to converge runs the reference's bisect in the kernel.
``fused_locate`` below launches it for CUDA tensors and runs
``fused_locate_plain``, which keeps the reference's bisects step by step,
for CPU tensors; ``fused_locate.launches`` counts the CUDA launches.

Arithmetic note: the TPU kernel's reference run (XLA) contracts the lerp
``p0 + t * (p1 - p0)`` into a fused multiply-add. The CUDA kernel writes
the FMA; the plain version computes it with ``ref.fma_f32`` (an exact
float64 product, one float32 rounding), which gives the FMA's result.

Float32 positions are exact only up to 2^24 slots; above that the JAX
package leaves the TPU kernel for its float64 spline path. With
``interp64=True`` both versions interpolate as that path does (the port's
``radix_spline._rs_predict_impl``), so the kernel serves any capacity.

K5 replaces the TPU kernel ``spline_lookup_pallas`` (same file of the JAX
package): K1's first three steps alone, returning the float32 predicted
position. Its JAX adapter takes the Pallas kernel only for radix shifts of
32 and above and the plain ``ref.spline_lookup_ref`` below, and the two
round differently; the CUDA source ``csrc/spline_lookup.cu`` has both
roundings behind a mode flag that ``spline_lookup`` sets from the shift, so
a CUDA tensor always launches the kernel. It gives a query a warp, finds
the knot segment in one 32-lane round where that is the bisect's answer,
and runs the reference's bisect five steps per round of reads everywhere
else; ``spline_lookup_paths`` says which queries take which path.
``spline_lookup.launches`` counts its CUDA launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fma_f32, key_leq

_TWO32 = 4294967296.0


def _split_delta_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a_hi - b_hi) * 2^32 + (a_lo - b_lo), each term rounded to float32
    as the TPU kernel computes it from (hi, lo)-split keys."""
    mask = 0xFFFFFFFF
    hi = ((a >> 32) - (b >> 32)).to(torch.float32)
    lo = (a & mask).to(torch.float32) - (b & mask).to(torch.float32)
    return hi * _TWO32 + lo


def span_length(window: int, cap: int) -> int:
    """L = min(3W, cap), the 3-row span the bounded bisect searches."""
    return min(3 * window, cap)


def knot_segment_plain(table, spline_keys, shift, queries, sid=None, *,
                       n_table: int, n_knots: int, rs_iters: int):
    """K1's steps 1 and 2 as the plain version computes them: the radix
    bucket and ``rs_iters`` steps of knot bisect. Returns the flat index
    (over the shard axis) of each query's spline segment, int64."""
    if sid is None:
        tb = sb = 0
        sh = shift[:1].to(torch.int64)
    else:
        sid = sid.to(torch.int64)
        tb = sid * n_table
        sb = sid * n_knots
        sh = shift.to(torch.int64)[sid]
    b = torch.clamp(queries >> sh, 0, n_table - 3)

    lo = sb + torch.clamp(table[tb + b].to(torch.int64), min=1) - 1
    hi = sb + torch.clamp(table[tb + b + 1].to(torch.int64), 0, n_knots - 2)
    for _ in range(rs_iters):
        mid = (lo + hi + 1) >> 1
        go = key_leq(spline_keys[mid], queries)
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    return torch.clamp(lo - sb, 0, n_knots - 2) + sb


def fused_locate_plain(
    table, spline_keys, spline_pos, shift, slot_keys, queries, sid=None,
    *, n_table: int, n_knots: int, cap: int, window: int, rs_iters: int,
    interp64: bool = False,
):
    """Plain torch version of K1 (same inputs and outputs as the kernel).

    ``table``/``spline_keys``/``spline_pos``/``slot_keys`` are flat over
    the shard axis ([S*T], [S*K], [S*K], [S*cap]); ``spline_pos`` is
    float64; ``shift`` is the per-shard int32 [S] radix shift; ``sid`` the
    int64 shard id per query, or None for a single shard.
    ``n_table``/``n_knots``/``cap`` are per-shard sizes. Returns int64
    ``(j, start)``."""
    L = span_length(window, cap)
    n_bisect = max(1, int(np.ceil(np.log2(L))))
    s = knot_segment_plain(table, spline_keys, shift, queries, sid,
                           n_table=n_table, n_knots=n_knots,
                           rs_iters=rs_iters)
    slb = 0 if sid is None else sid.to(torch.int64) * cap

    k0 = spline_keys[s]
    k1 = spline_keys[s + 1]
    p0 = spline_pos[s]
    p1 = spline_pos[s + 1]
    if interp64:
        dk = (queries - k0).to(torch.float64)
        seg = torch.clamp((k1 - k0).to(torch.float64), min=1.0)
        t = torch.clamp(dk / seg, 0.0, 1.0)
        p = p0 + t * (p1 - p0)
    else:
        dk = _split_delta_f32(queries, k0)
        seg = _split_delta_f32(k1, k0)
        t = torch.clamp(dk / torch.clamp(seg, min=1.0), 0.0, 1.0)
        p0 = p0.to(torch.float32)
        p = fma_f32(t, p1.to(torch.float32) - p0, p0)

    c = torch.clamp(torch.round(p).to(torch.int64), 0, cap - 1)
    start = torch.clamp((c // window - 1) * window, 0, max(cap - L, 0))
    glo = slb + start
    wlo, whi = glo, glo + (L - 1)
    for _ in range(n_bisect):
        mid = (wlo + whi + 1) >> 1
        go = key_leq(slot_keys[mid], queries)
        wlo, whi = torch.where(go, mid, wlo), torch.where(go, whi, mid - 1)
    below = key_leq(slot_keys[glo], queries)
    return torch.where(below, wlo - slb, start - 1), start


_DTYPES = {
    "table": torch.int32, "spline_keys": torch.int64,
    "spline_pos": torch.float64, "shift": torch.int32,
    "slot_keys": torch.int64, "queries": torch.int64, "sid": torch.int64,
}


def _check_inputs(device, **arrays) -> None:
    for name, x in arrays.items():
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != _DTYPES[name]:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {_DTYPES[name]}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")


def fused_locate(
    table, spline_keys, spline_pos, shift, slot_keys, queries, sid=None,
    *, n_table: int, n_knots: int, cap: int, window: int, rs_iters: int,
    interp64: bool = False,
):
    """K1: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Same contract as ``fused_locate_plain``, on what every index
    holds: knots and slot keys non-decreasing within each shard (the
    kernel counts keys <= q where the plain version bisects)."""
    kw = dict(n_table=n_table, n_knots=n_knots, cap=cap, window=window,
              rs_iters=rs_iters, interp64=interp64)
    if queries.device.type == "cpu":
        return fused_locate_plain(table, spline_keys, spline_pos, shift,
                                  slot_keys, queries, sid, **kw)
    if queries.device.type != "cuda":
        raise ValueError(f"no fused locate kernel for {queries.device}")
    if n_knots < 2:
        raise ValueError("the fused locate needs a model with at least one "
                         "spline segment (n_knots >= 2)")
    _check_inputs(queries.device, table=table, spline_keys=spline_keys,
                  spline_pos=spline_pos, shift=shift,
                  slot_keys=slot_keys, queries=queries, sid=sid)
    n = queries.shape[0]
    j = torch.empty(n, dtype=torch.int64, device=queries.device)
    start = torch.empty(n, dtype=torch.int64, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = build.library().fused_locate_launch(
        table.data_ptr(), spline_keys.data_ptr(), spline_pos.data_ptr(),
        shift.data_ptr(), slot_keys.data_ptr(), queries.data_ptr(),
        None if sid is None else sid.data_ptr(), j.data_ptr(),
        start.data_ptr(), n, n_table, n_knots, cap, window, rs_iters,
        int(interp64), stream,
    )
    build.check(err, "fused_locate")
    build.count_launch(fused_locate)
    return j, start


fused_locate.launches = 0


# ---------------------------------------------------------------------------
# K5 — the spline lookup (batched learned predict)
# ---------------------------------------------------------------------------


def _bucket_range(table, n_knots: int, queries, shift: int):
    """K5's radix bucket and the bisect's knot range ``[lo, hi]`` per
    query, int64."""
    n_buckets = table.shape[0] - 2
    if shift >= 32:
        b = (queries >> 32) >> (shift - 32)
    else:
        b = (queries >> shift) & 0xFFFFFFFF
        b = torch.where(b >= 1 << 31, b - (1 << 32), b)  # int32 wrap
    b = torch.clamp(b, 0, n_buckets - 1)
    lo = torch.clamp(table[b].to(torch.int64), min=1) - 1
    hi = torch.clamp(table[b + 1].to(torch.int64), 0, n_knots - 2)
    return lo, hi


K5_ROUND_KNOTS = 31  # the widest knot range of K5's one round
K5_TREE_DEPTH = 5    # bisect steps per round of reads in K5's bisect path


def _one_round(spline_keys, queries, lo, hi, left):
    """Where K5's kernel takes its one round from the bisect state
    ``(lo, hi)`` with ``left`` steps to go: the range holds 1 to
    ``K5_ROUND_KNOTS`` knots, the steps converge on it, and the knots
    <= q come first in it (as the round's ballot sees them)."""
    n_knots = spline_keys.shape[0]
    width = hi - lo + 1
    converges = torch.where(left >= K5_TREE_DEPTH, 32,
                            1 << torch.clamp(left, 0, K5_TREE_DEPTH))
    lanes = torch.arange(1, K5_ROUND_KNOTS, device=queries.device)
    idx = torch.clamp(lo[:, None] + lanes, 0, n_knots - 1)
    le = (lanes < width[:, None]) & key_leq(spline_keys[idx], queries[:, None])
    first = (le.to(torch.int64).cummin(dim=1).values == le).all(dim=1)
    return ((width >= 1) & (width <= K5_ROUND_KNOTS) & (width <= converges)
            & first)


def spline_lookup_paths(table, spline_keys, queries, *, shift: int,
                        n_iters: int):
    """Which path each query takes through the K5 kernel, as the kernel
    decides it, and how many bisect rounds of reads it makes.

    Returns ``(path, rounds)``, int64 [N] each. ``path`` is 0 where the
    kernel's first look finds a range of 1 to ``K5_ROUND_KNOTS`` knots
    that ``n_iters`` steps converge on, with the knots <= q first in it
    (one round, no bisect round); 1 where the range converges but is wider
    than one round; 2 for every other case (``n_iters`` too small to
    converge, lo > hi, knots <= q not first). Off path 0 the kernel runs
    the bisect, ``K5_TREE_DEPTH`` steps per round, until the rest of the
    range fits one round, the bisect has converged or ``n_iters`` steps
    are done; ``rounds`` counts those rounds."""
    n_knots = spline_keys.shape[0]
    lo, hi = _bucket_range(table, n_knots, queries, shift)
    left = torch.full_like(lo, n_iters)
    first = _one_round(spline_keys, queries, lo, hi, left)
    width = hi - lo + 1
    converges = (width >= 1) & (width <= 1 << max(0, min(n_iters, 40)))
    path = torch.where(first, 0, torch.where(
        converges & (width > K5_ROUND_KNOTS), 1, 2))
    rounds = torch.zeros_like(lo)
    live = ~first
    while bool(live.any()):
        live &= (left > 0) & ~((hi <= lo) & (lo <= hi + 1))
        d = torch.clamp(left, max=K5_TREE_DEPTH)
        rounds += live
        for step in range(K5_TREE_DEPTH):
            on = live & (step < d)
            mid = (lo + hi + 1) >> 1
            go = key_leq(spline_keys[torch.clamp(mid, 0, n_knots - 1)],
                         queries)
            lo = torch.where(on & go, mid, lo)
            hi = torch.where(on & ~go, mid - 1, hi)
        left = torch.where(live, left - d, left)
        live &= ~_one_round(spline_keys, queries, lo, hi, left)
    return path, rounds


def spline_lookup_plain(table, spline_keys, spline_pos, queries, *,
                        shift: int, n_iters: int):
    """Plain torch version of K5: the float32 predicted position of each
    int64 query under one radix spline (``table`` int32 [T],
    ``spline_keys`` int64 [K], float64 ``spline_pos`` [K]).

    ``shift >= 32`` is the Pallas kernel's arithmetic: the bucket from the
    high half of the key, (hi, lo)-split float32 deltas and a fused
    multiply-add lerp. ``shift < 32`` is the reference's plain fallback:
    the bucket ``int32(q >> shift)`` (wrapped before the clip), each int64
    delta rounded to float32 once, and a separate multiply and add."""
    n_knots = spline_keys.shape[0]
    split = shift >= 32
    lo, hi = _bucket_range(table, n_knots, queries, shift)
    for _ in range(n_iters):
        mid = (lo + hi + 1) >> 1
        go = key_leq(spline_keys[mid], queries)
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    s = torch.clamp(lo, 0, n_knots - 2)
    k0 = spline_keys[s]
    k1 = spline_keys[s + 1]
    p0 = spline_pos[s].to(torch.float32)
    p1 = spline_pos[s + 1].to(torch.float32)
    if split:
        dk = _split_delta_f32(queries, k0)
        seg = _split_delta_f32(k1, k0)
    else:
        dk = (queries - k0).to(torch.float32)
        seg = (k1 - k0).to(torch.float32)
    t = torch.clamp(dk / torch.clamp(seg, min=1.0), 0.0, 1.0)
    if split:
        return fma_f32(t, p1 - p0, p0)
    return p0 + t * (p1 - p0)


def spline_lookup(table, spline_keys, spline_pos, queries, *, shift: int,
                  n_iters: int):
    """K5: the CUDA kernel for CUDA tensors (in both shift regimes), the
    plain version for CPU tensors. Same contract as
    ``spline_lookup_plain``."""
    if queries.device.type == "cpu":
        return spline_lookup_plain(table, spline_keys, spline_pos, queries,
                                   shift=shift, n_iters=n_iters)
    if queries.device.type != "cuda":
        raise ValueError(f"no spline lookup kernel for {queries.device}")
    if not 0 <= shift <= 63:
        raise ValueError(f"radix shift {shift} outside [0, 63]")
    if spline_keys.shape[0] < 2 or table.shape[0] < 3:
        raise ValueError("the spline lookup needs at least two knots and "
                         "one radix bucket")
    _check_inputs(queries.device, table=table, spline_keys=spline_keys,
                  spline_pos=spline_pos, queries=queries)
    n = queries.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = build.library().spline_lookup_launch(
        table.data_ptr(), spline_keys.data_ptr(), spline_pos.data_ptr(),
        queries.data_ptr(), out.data_ptr(), n, table.shape[0],
        spline_keys.shape[0], shift, n_iters, int(shift >= 32), stream,
    )
    build.check(err, "spline_lookup")
    build.count_launch(spline_lookup)
    return out


spline_lookup.launches = 0
