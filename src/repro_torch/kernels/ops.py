"""Adapters between the index ops and the kernels (port of
``repro/kernels/ops.py``).

The JAX adapters split int64 keys into (hi, lo) halves, pad batches to the
Pallas block sizes and pick interpret mode off the TPU. The port needs none
of that: the kernels read int64 directly and mask their own ragged edge.
What remains is the shard-id signature (the stacked ops of the router pass
a shard id per query), the shape guards, the float32 casts of the E-step
and the platform gate. The stacked and single-index ranks call K2
(``kernels.bmat_rank.bmat_rank``) directly: it takes any BMAT size.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bmat_rank as _rank
from repro_torch.kernels import gmm_estep as _estep
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


def launch_counts() -> dict:
    """CUDA launches of each kernel since the last reset."""
    return {
        "fused_locate": _locate.fused_locate.launches,
        "bmat_rank": _rank.bmat_rank.launches,
        "gmm_estep": _estep.gmm_estep.launches,
    }


def reset_launch_counts() -> None:
    _locate.fused_locate.launches = 0
    _rank.bmat_rank.launches = 0
    _estep.gmm_estep.launches = 0
