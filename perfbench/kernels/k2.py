"""K2, the BMAT rank (``csrc/bmat_rank.cu``): its bytes per launch.

A frozen plain copy of the port's ``bmat_rank_plain``
(``repro_torch/kernels/bmat_rank.py``) that also returns the element
indices it reads. Bytes per launch: the distinct fences and node keys
these queries reach, each read once, every query and shard id read once,
and the int64 rank written once.
"""
from __future__ import annotations

import numpy as np
import torch

NAME = "k2"
KERNEL = "bmat_rank"                          # device kernel name, launch key
ENTRY = ("repro_torch.core.fops", "k2_rank")  # the call to observe


def plain(keys, fences, queries, sid=None, *, cap, nf, fanout, reads=None):
    """The shard-local rank as the kernel computes it; appends the indices
    read from ``keys`` and ``fences`` to ``reads[name]`` when given."""
    def get(name, arr, idx):
        if reads is not None:
            reads.setdefault(name, []).append(idx.reshape(-1))
        return arr[idx]

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
        go = get("fences", fences, mid) < queries
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    nlo = kbase + torch.clamp(lo - fbase - 1, min=0) * fanout
    nhi = torch.minimum(nlo + fanout, kbase + cap)
    kcap = kbase + (cap - 1)
    for _ in range(node_iters):
        mid = (nlo + nhi) >> 1
        go = get("keys", keys, torch.minimum(mid, kcap)) < queries
        nlo, nhi = torch.where(go, mid + 1, nlo), torch.where(go, nhi, mid)
    return torch.clamp(nlo - kbase, max=cap)


def bytes_of(args, kwargs) -> int:
    """Bytes one launch with these inputs needs."""
    keys, fences, queries = args[:3]
    sid = args[3] if len(args) > 3 else kwargs.get("sid")
    reads = {}
    plain(keys, fences, queries, sid, cap=kwargs["cap"], nf=kwargs["nf"],
          fanout=kwargs["fanout"], reads=reads)
    arrays = {"keys": keys, "fences": fences}
    n = int(queries.shape[0])
    total = n * queries.element_size() + n * 8            # queries, rank
    if sid is not None:
        total += n * sid.element_size()
    for name, idx in reads.items():
        total += (int(torch.unique(torch.cat(idx)).numel())
                  * arrays[name].element_size())
    return total
