"""Adapters between the index ops and the kernels (port of
``repro/kernels/ops.py``).

The JAX adapters split int64 keys into (hi, lo) halves, pad batches to the
Pallas block sizes and pick interpret mode off the TPU. The port needs none
of that: the kernels read int64 directly and mask their own ragged edge.
What remains is the shard-id signature (so the stacked ops of the router
reuse these unchanged), the shape guards, and the platform gate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bmat_rank as _rank
from repro_torch.kernels import spline_lookup as _locate

MAX_F32_POSITIONS = 1 << 24  # f32 slot positions are exact below this


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


def rank_fusable(n_keys: int, n_fences: int) -> bool:
    """The rank kernel takes any BMAT size on CUDA (no VMEM budget)."""
    return True


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


def bmat_rank_fused(keys, fences, queries, sid=None, *, cap: int, nf: int,
                    fanout: int):
    """K2 adapter: shard-local searchsorted-left rank (int64); ``keys`` and
    ``fences`` flat over the shard axis, ``sid`` per query (None for a
    single BMAT)."""
    return _rank.bmat_rank(keys, fences, queries, sid, cap=cap, nf=nf,
                           fanout=fanout)


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {
        "fused_locate": _locate.fused_locate.launches,
        "bmat_rank": _rank.bmat_rank.launches,
    }


def reset_launch_counts() -> None:
    _locate.fused_locate.launches = 0
    _rank.bmat_rank.launches = 0
