"""Device-resident state of one UpLIF index (port of ``repro/core/state.py``).

``UpLIFState`` bundles everything an index operation needs: the gapped slot
array, the spline model, the BMAT delta-buffer arrays and the structural
counters, all tensors on one device. The ops in ``repro_torch.core.fops``
are functions ``(UpLIFState, batch) -> (UpLIFState, result)``.

The JAX package also carries a persistent (hi:int32, lo:uint32) split of
every key array (``KeyHalves``), because the TPU vector unit has no int64.
The port drops it: the Hopper kernels read the int64 arrays directly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import BMATState, RadixSplineModel, SlotsState

_I64_MAX = int(np.iinfo(np.int64).max)

LOCATE_SPLINE = "spline"        # radix-spline predict + bounded window bisect
LOCATE_BINSEARCH = "binsearch"  # model-free full bisect (B+Tree baseline)
LOCATE_FUSED = "fused"          # fused locate + rank kernels (hot path)
LOCATE_AUTO = "auto"            # fused where native kernels exist (CUDA)

LOCATE_STRATEGIES = (LOCATE_SPLINE, LOCATE_BINSEARCH, LOCATE_FUSED)


def resolve_locate(requested: str, native: bool) -> str:
    """Map a configured locate strategy to a concrete one.

    ``LOCATE_AUTO`` picks the fused kernels where they run natively (a CUDA
    device) and the plain torch spline path elsewhere: on the CPU the fused
    strategy runs the kernels' plain versions, a correctness proxy rather
    than a speedup. Explicit strategies pass through validated, so tests
    can pin ``"fused"`` on the CPU."""
    if requested == LOCATE_AUTO:
        return LOCATE_FUSED if native else LOCATE_SPLINE
    if requested not in LOCATE_STRATEGIES:
        raise ValueError(
            f"unknown locate strategy {requested!r}; "
            f"expected one of {LOCATE_STRATEGIES + (LOCATE_AUTO,)}"
        )
    return requested


class Counters(NamedTuple):
    """Structural counters kept on the device by the ops (0-d int64)."""

    n_keys: torch.Tensor           # live keys in the slot array
    n_bmat_live: torch.Tensor      # live (non-tombstone) BMAT entries
    n_inplace: torch.Tensor        # accepted in-place inserts
    n_overflow: torch.Tensor       # inserts routed to the BMAT
    min_granularity: torch.Tensor  # smallest failed-window key span


class UpLIFState(NamedTuple):
    """The whole index (slots + model + BMAT + counters)."""

    slots: SlotsState
    model: RadixSplineModel
    bmat: BMATState
    counters: Counters


class UpLIFStatic(NamedTuple):
    """Host scalars of the op suite (hashable)."""

    window: int         # W — insert/last-mile window (power of two)
    movement_k: int     # K — max elements shifted per in-place insert
    rs_iters: int       # bounded knot-search depth of the spline model
    insert_rounds: int  # in-place retry rounds before BMAT overflow
    fanout: int         # B+MAT fence fanout
    bmat_kind: str      # 'rbmat' | 'b+mat'
    locate: str         # LOCATE_SPLINE | LOCATE_BINSEARCH | LOCATE_FUSED


def init_counters(
    device,
    n_keys: int = 0,
    n_bmat_live: int = 0,
    n_inplace: int = 0,
    n_overflow: int = 0,
    min_granularity: int = _I64_MAX,
) -> Counters:
    """Counters on ``device`` holding the given starting counts; by default
    zero counts and the granularity at int64 max (no failed window)."""
    def t(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    return Counters(
        n_keys=t(n_keys),
        n_bmat_live=t(n_bmat_live),
        n_inplace=t(n_inplace),
        n_overflow=t(n_overflow),
        min_granularity=t(min_granularity),
    )


def state_memory_bytes(state: UpLIFState) -> int:
    """Total live bytes of the device-resident state (counters excluded)."""
    return sum(
        a.numel() * a.element_size()
        for arrs in (state.slots, state.model, state.bmat)
        for a in arrs
    )
