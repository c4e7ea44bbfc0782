"""K1, the fused locate (``csrc/fused_locate.cu``): its bytes per launch.

A frozen plain copy of the port's ``fused_locate_plain``
(``repro_torch/kernels/spline_lookup.py``) that also returns the element
indices it reads from each array. The bytes a launch needs are counted
from them as the least traffic the launch must move: each input byte read
once (the distinct elements of the radix table, the knots, their
positions, the shift and the slot keys that these queries reach), every
query and shard id read once, and both int64 outputs written once. The
copy interpolates as the launch was asked to (``interp64``): the caller
chooses float32 or float64, and the count follows its choice.
"""
from __future__ import annotations

import numpy as np
import torch

NAME = "k1"
KERNEL = "fused_locate"                       # device kernel name, launch key
#: the call to observe: the kernel's wrapper, which ``ops.fused_locate``
#: calls through its module with the interpolation it chose
ENTRY = ("repro_torch.kernels.spline_lookup", "fused_locate")
_TWO32 = 4294967296.0


def _split_delta_f32(a, b):
    mask = 0xFFFFFFFF
    hi = ((a >> 32) - (b >> 32)).to(torch.float32)
    lo = (a & mask).to(torch.float32) - (b & mask).to(torch.float32)
    return hi * _TWO32 + lo


def _fma_f32(a, b, c):
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    r = p + cd
    bv = r - p
    err = (p - (r - bv)) + (cd - bv)
    f = r.to(torch.float32)
    fd = f.to(torch.float64)
    inf = torch.full_like(f, float("inf"))
    g = torch.nextafter(f, torch.where(r > fd, inf, -inf))
    tie = (r != fd) & (r == (fd + g.to(torch.float64)) * 0.5) & (err != 0)
    return torch.where(tie & ((err > 0) == (g > f)), g, f)


def plain(table, spline_keys, spline_pos, shift, slot_keys, queries,
          sid=None, *, n_table, n_knots, cap, window, rs_iters,
          interp64=False, reads=None):
    """(j, start) as the kernel computes them; appends the indices read
    from each array to ``reads[name]`` when given."""
    def get(name, arr, idx):
        if reads is not None:
            reads.setdefault(name, []).append(idx.reshape(-1))
        return arr[idx]

    L = min(3 * window, cap)
    n_bisect = max(1, int(np.ceil(np.log2(L))))
    if sid is None:
        tb = sb = slb = 0
        sh = get("shift", shift, torch.zeros_like(queries)).to(torch.int64)
    else:
        sid = sid.to(torch.int64)
        tb, sb, slb = sid * n_table, sid * n_knots, sid * cap
        sh = get("shift", shift, sid).to(torch.int64)
    b = torch.clamp(queries >> sh, 0, n_table - 3)
    lo = sb + torch.clamp(get("table", table, tb + b).to(torch.int64),
                          min=1) - 1
    hi = sb + torch.clamp(get("table", table, tb + b + 1).to(torch.int64),
                          0, n_knots - 2)
    for _ in range(rs_iters):
        mid = (lo + hi + 1) >> 1
        go = get("spline_keys", spline_keys, mid) <= queries
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    s = torch.clamp(lo - sb, 0, n_knots - 2) + sb
    k0 = get("spline_keys", spline_keys, s)
    k1 = get("spline_keys", spline_keys, s + 1)
    p0 = get("spline_pos", spline_pos, s)
    p1 = get("spline_pos", spline_pos, s + 1)
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
        p = _fma_f32(t, p1.to(torch.float32) - p0, p0)
    c = torch.clamp(torch.round(p).to(torch.int64), 0, cap - 1)
    start = torch.clamp((c // window - 1) * window, 0, max(cap - L, 0))
    glo = slb + start
    wlo, whi = glo, glo + (L - 1)
    for _ in range(n_bisect):
        mid = (wlo + whi + 1) >> 1
        go = get("slot_keys", slot_keys, mid) <= queries
        wlo, whi = torch.where(go, mid, wlo), torch.where(go, whi, mid - 1)
    below = get("slot_keys", slot_keys, glo) <= queries
    return torch.where(below, wlo - slb, start - 1), start


ARRAYS = ("table", "spline_keys", "spline_pos", "shift", "slot_keys")


def bytes_of(args, kwargs) -> int:
    """Bytes one launch with these inputs needs."""
    table, spline_keys, spline_pos, shift, slot_keys, queries = args[:6]
    sid = args[6] if len(args) > 6 else kwargs.get("sid")
    kw = {k: kwargs[k] for k in ("n_table", "n_knots", "cap", "window",
                                 "rs_iters")}
    kw["interp64"] = bool(kwargs.get("interp64", False))
    reads = {}
    plain(table, spline_keys, spline_pos, shift, slot_keys, queries, sid,
          reads=reads, **kw)
    arrays = dict(zip(ARRAYS, (table, spline_keys, spline_pos, shift,
                               slot_keys)))
    n = int(queries.shape[0])
    total = n * queries.element_size() + 2 * n * 8     # queries, (j, start)
    if sid is not None:
        total += n * sid.element_size()
    for name, idx in reads.items():
        total += (int(torch.unique(torch.cat(idx)).numel())
                  * arrays[name].element_size())
    return total
