"""K7 — the window insert: one Movement round of the insert's in-place
placement, as a CUDA kernel pair, and its plain torch version.

Replaces no TPU kernel. The JAX package runs the round as jnp code
(``src/repro/core/fops.py``: the grid-segment accept of ``insert`` and
``sinsert`` and ``_inplace_window_insert``), which XLA compiles into a few
fused programs; run eagerly, the same code is about 150 PyTorch launches a
round. The CUDA source is ``csrc/window_insert.cu``; its header says what
bounds the round on the H100 (the launches, and a short chain of dependent
reads) and what the design does about it (a claim launch that keeps each
grid row's lowest-indexed pending key, then a warp per key that shifts and
repairs the row it owns).

Both versions take the same arguments and give the same bytes:

* ``sk_buf``, ``sv_buf``, ``so_buf`` — the insert's own slot copies (int64
  keys, int64 values, bool occupancy), ``total + W`` slots each: the slot
  view of ``total`` slots (``cap`` for one index, ``S * cap`` for stacked
  shards) and one scratch W-row after it. The accepted rows are written in
  place; the plain version also writes the scratch row.
* ``keys``, ``vals`` — the batch; ``j``, ``icap`` — each key's shard-local
  locate (``fops._locate``'s contract); ``pending`` — the keys still to
  place; ``sid`` — each key's shard (None: shard 0 for every key).
* ``n_placed``, ``min_span`` — optional int64 scalars, given together: the
  round adds its placed keys to ``n_placed`` and lowers ``min_span`` to
  its least failed span.

It returns ``(ok, failed_span)`` in batch order: whether each key was
placed, and the key span of each accepted window that could not place its
key (int64 max elsewhere).

``window_insert`` launches the kernels for CUDA tensors (or raises) and runs
``window_insert_plain`` for CPU tensors; ``window_insert.launches`` counts
the CUDA launches, two a call. It makes no host sync, and the claim array
it allocates (int32, a cell per grid row) is freed when the call returns.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import build

_I64_MAX = torch.iinfo(torch.int64).max
_I32_MAX = torch.iinfo(torch.int32).max
MAX_WINDOW = 256  # the apply kernel holds at most 8 slots a lane


def _inplace_window_insert(
    sk_buf, sv_buf, so_buf, total: int, q_keys, q_vals, starts, accept,
    valid, window: int, movement_k: int,
):
    """One vectorized round of conflict-free in-place window inserts.

    ``starts`` are sorted grid-aligned window starts; ``accept`` marks the
    per-grid-segment representative (disjoint by construction). The
    accepted rows are written into the buffers in place, the rest into the
    scratch row. Returns the success mask and the key span of failed
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
    m = torch.where(n_o, n_k, _I64_MAX)
    suffix_min = torch.flip(torch.cummin(torch.flip(m, [1]), dim=1).values, [1])
    n_k = torch.minimum(suffix_min, n_k[:, W - 1:])

    # writeback: accepted windows are distinct grid rows; the rest aim at
    # the scratch row
    rows = torch.where(accept, starts // W, total // W)
    sk_buf.view(-1, W)[rows] = n_k
    sv_buf.view(-1, W)[rows] = n_v
    so_buf.view(-1, W)[rows] = n_o

    span = w_k[:, W - 1] - w_k[:, 0]
    failed_span = torch.where(accept & ~can & valid, span, _I64_MAX)
    return can, failed_span


def window_insert_plain(sk_buf, sv_buf, so_buf, keys, vals, j, icap,
                        pending, sid=None, *, cap: int, total: int,
                        window: int, movement_k: int, n_placed=None,
                        min_span=None):
    """Plain torch version of K7 (the module's contract): the reference's
    grid-segment accept — a stable sort of the pending keys by grid row,
    the first of each row accepted — and ``_inplace_window_insert``."""
    W = window
    # clamp to the locate span, so that a boundary the bounded search could
    # not prove lands in the BMAT, never outside the searched rows
    row = torch.clamp(torch.minimum(j + 1, icap), 0, cap - 1) // W
    if sid is not None:
        row = sid * (cap // W) + row
    bucket = torch.where(pending, row, total // W + 1)
    order = torch.argsort(bucket, stable=True)  # ties keep batch order
    bs = bucket[order]
    ps = pending[order]
    first = torch.ones_like(ps)
    first[1:] = bs[1:] != bs[:-1]
    accept = ps & first
    starts = torch.clamp(bs * W, 0, total - W)
    can, span_s = _inplace_window_insert(
        sk_buf, sv_buf, so_buf, total, keys[order], vals[order], starts,
        accept, ps, W, movement_k,
    )
    ok_s = can & ps
    if n_placed is not None:
        n_placed.add_(ok_s.sum())
        torch.minimum(min_span, span_s.min(), out=min_span)
    ok = torch.empty_like(ok_s)
    ok[order] = ok_s
    failed_span = torch.empty_like(span_s)
    failed_span[order] = span_s
    return ok, failed_span


def _check(sk_buf, sv_buf, so_buf, keys, vals, j, icap, pending, sid, *,
           cap, total, window, n_placed, min_span):
    if window < 1 or window & (window - 1) or window > MAX_WINDOW:
        raise ValueError(f"K7 takes a power-of-two window up to {MAX_WINDOW},"
                         f" got {window}")
    if cap < window or cap % window or total % cap:
        raise ValueError(f"K7 needs W-aligned cap and total, got W {window},"
                         f" cap {cap}, total {total}")
    if (n_placed is None) != (min_span is None):
        raise ValueError("pass n_placed and min_span together")
    dev = keys.device
    n = keys.shape[0]
    for name, x, dtype, size in (
        ("sk_buf", sk_buf, torch.int64, total + window),
        ("sv_buf", sv_buf, torch.int64, total + window),
        ("so_buf", so_buf, torch.bool, total + window),
        ("keys", keys, torch.int64, n), ("vals", vals, torch.int64, n),
        ("j", j, torch.int64, n), ("icap", icap, torch.int64, n),
        ("pending", pending, torch.bool, n), ("sid", sid, torch.int64, n),
        ("n_placed", n_placed, torch.int64, 1),
        ("min_span", min_span, torch.int64, 1),
    ):
        if x is None:
            continue
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}")
        if x.numel() != size or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous with {size} "
                             f"elements, got {tuple(x.shape)}")


def window_insert(sk_buf, sv_buf, so_buf, keys, vals, j, icap, pending,
                  sid=None, *, cap: int, total: int, window: int,
                  movement_k: int, n_placed=None, min_span=None):
    """K7: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors (the module's contract)."""
    args = (sk_buf, sv_buf, so_buf, keys, vals, j, icap, pending, sid)
    kw = dict(cap=cap, total=total, window=window)
    _check(*args, **kw, n_placed=n_placed, min_span=min_span)
    n = keys.shape[0]
    if n == 0:
        return pending.clone(), torch.empty_like(keys)
    if keys.device.type == "cpu":
        return window_insert_plain(*args, **kw, movement_k=movement_k,
                                   n_placed=n_placed, min_span=min_span)
    if keys.device.type != "cuda":
        raise ValueError(f"no window insert kernel for {keys.device}")
    tracing.count("insert.rounds_kernel")
    dev = keys.device
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    failed_span = torch.empty(n, dtype=torch.int64, device=dev)
    n_rows = total // window
    claim = torch.full((n_rows,), _I32_MAX, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.library()
    sid_p = None if sid is None else sid.data_ptr()
    err = lib.window_insert_claim_launch(
        j.data_ptr(), icap.data_ptr(), sid_p, pending.data_ptr(),
        claim.data_ptr(), n, cap, window, n_rows, stream,
    )
    build.check(err, "window_insert_claim")
    build.count_launch(window_insert)
    err = lib.window_insert_apply_launch(
        sk_buf.data_ptr(), sv_buf.data_ptr(), so_buf.data_ptr(),
        keys.data_ptr(), vals.data_ptr(), j.data_ptr(), icap.data_ptr(),
        sid_p, pending.data_ptr(), claim.data_ptr(), ok.data_ptr(),
        failed_span.data_ptr(),
        None if n_placed is None else n_placed.data_ptr(),
        None if min_span is None else min_span.data_ptr(),
        n, cap, n_rows, window, movement_k, stream,
    )
    build.check(err, "window_insert_apply")
    build.count_launch(window_insert)
    return ok, failed_span


window_insert.launches = 0
