"""K2 — the BMAT rank kernel and its plain torch version.

Replaces the TPU kernel ``bmat_rank_offset_pallas``
(``src/repro/kernels/bmat_rank.py``): the bias query r(k) of Definition 1,
a searchsorted-left rank through the two-level fence tree — a bisect over
the fences, then a bisect inside one node — returning the shard-local rank
in ``[0, cap]``.

The CUDA source is ``csrc/bmat_rank.cu``; its header says what bounds it on
the H100 (dependent reads from L2, then the launch) and what its design (a
warp per query, a 32-ary fence search, one ballot over a node of up to 64
keys and a 32-ary count over a wider one) does about it. It takes any
fanout, as the reference does. ``bmat_rank`` below launches it for CUDA
tensors and runs ``bmat_rank_plain`` for CPU tensors;
``bmat_rank.launches`` counts the CUDA launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import key_lt


def bmat_rank_plain(keys, fences, queries, sid=None, *, cap: int, nf: int,
                    fanout: int):
    """Plain torch version of K2. ``keys``/``fences`` are flat over the
    shard axis ([S*cap], [S*nf]); ``sid`` is the int64 shard id per query,
    or None for a single BMAT. Returns the int64 shard-local rank."""
    fence_iters = int(np.ceil(np.log2(nf + 1)))
    node_iters = int(np.ceil(np.log2(fanout + 1)))
    if sid is None:
        kbase = fbase = torch.zeros_like(queries)
    else:
        sid = sid.to(torch.int64)
        kbase = sid * cap
        fbase = sid * nf
    lo, hi = fbase, fbase + (nf - 1)
    for _ in range(fence_iters):
        mid = (lo + hi) >> 1
        go = key_lt(fences[mid], queries)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    nlo = kbase + torch.clamp(lo - fbase - 1, min=0) * fanout
    nhi = torch.minimum(nlo + fanout, kbase + cap)
    kcap = kbase + (cap - 1)
    for _ in range(node_iters):
        mid = (nlo + nhi) >> 1
        go = key_lt(keys[torch.minimum(mid, kcap)], queries)
        nlo, nhi = torch.where(go, mid + 1, nlo), torch.where(go, nhi, mid)
    return torch.clamp(nlo - kbase, max=cap)


def bmat_rank(keys, fences, queries, sid=None, *, cap: int, nf: int,
              fanout: int):
    """K2: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Same contract as ``bmat_rank_plain``, for any fanout, fence
    count and capacity of at least 1."""
    if min(fanout, nf, cap) < 1:
        raise ValueError(f"K2 needs fanout, nf and cap >= 1, got {fanout}, "
                         f"{nf}, {cap}")
    if queries.device.type == "cpu":
        return bmat_rank_plain(keys, fences, queries, sid, cap=cap, nf=nf,
                               fanout=fanout)
    if queries.device.type != "cuda":
        raise ValueError(f"no BMAT rank kernel for {queries.device}")
    for name, x in (("keys", keys), ("fences", fences),
                    ("queries", queries), ("sid", sid)):
        if x is None:
            continue
        if x.device != queries.device or x.dtype != torch.int64:
            raise ValueError(f"{name} must be int64 on {queries.device}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    n = queries.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = build.library().bmat_rank_launch(
        keys.data_ptr(), fences.data_ptr(), queries.data_ptr(),
        None if sid is None else sid.data_ptr(), out.data_ptr(), n, cap, nf,
        fanout, stream,
    )
    build.check(err, "bmat_rank")
    build.count_launch(bmat_rank)
    return out


bmat_rank.launches = 0
