"""Build the port's index or router from numpy copies of another index's
arrays.

The arrays arrive as numpy (for example ``np.asarray`` of each leaf of an
index built elsewhere), in the field order of the port's NamedTuples, so
this module needs nothing but torch and numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.state import Counters, UpLIFState
from repro_torch.core.types import (
    BMATState,
    GMMState,
    RadixSplineModel,
    RSStatic,
    SlotsState,
)
from repro_torch.core.sharded import ShardedUpLIF, _ShardMeta
from repro_torch.core.uplif import UpLIF, UpLIFConfig


def _tensors(kind, arrays: Sequence[np.ndarray], device):
    if len(arrays) != len(kind._fields):
        raise ValueError(
            f"{kind.__name__} takes {len(kind._fields)} arrays "
            f"({', '.join(kind._fields)}), got {len(arrays)}"
        )
    return kind(*(torch.tensor(np.asarray(a), device=device) for a in arrays))


def model_from_numpy(model: Sequence[np.ndarray], *,
                     device) -> RadixSplineModel:
    """``RadixSplineModel`` on ``device`` from its leaves (table,
    spline_keys, spline_pos, shift), dtypes kept as given: the inputs of
    the kernel-level ``ops.spline_lookup``."""
    return _tensors(RadixSplineModel, model, device)


def state_from_numpy(
    slots: Sequence[np.ndarray],
    model: Sequence[np.ndarray],
    bmat: Sequence[np.ndarray],
    counters: Sequence[np.ndarray],
    *,
    device,
) -> UpLIFState:
    """``UpLIFState`` on ``device`` from the leaves of SlotsState (keys, vals,
    occ), RadixSplineModel (table, spline_keys, spline_pos, shift),
    BMATState (keys, vals, fences, size) and Counters (n_keys, n_bmat_live,
    n_inplace, n_overflow, min_granularity). Dtypes are kept as given."""
    return UpLIFState(
        slots=_tensors(SlotsState, slots, device),
        model=_tensors(RadixSplineModel, model, device),
        bmat=_tensors(BMATState, bmat, device),
        counters=_tensors(Counters, counters, device),
    )


def uplif_from_numpy(
    slots, model, bmat, counters, *,
    rs_static: Sequence[int],
    gmm: Sequence[np.ndarray],
    alpha: float,
    config: UpLIFConfig,
    device,
) -> UpLIF:
    """An ``UpLIF`` host shell around ``state_from_numpy(...)``; ``rs_static``
    is (radix_bits, max_error, n_search_iters, n_spline) and ``gmm`` the
    (weights, means, stds) arrays. The BMAT kind and fanout come from
    ``config``."""
    state = state_from_numpy(slots, model, bmat, counters, device=device)
    return UpLIF.from_state(
        state,
        rs_static=RSStatic(*(int(x) for x in rs_static)),
        gmm=_tensors(GMMState, gmm, "cpu"),
        alpha=float(alpha),
        config=config,
        device=device,
    )


def sharded_from_numpy(
    slots, model, bmat, counters, *,
    boundaries: np.ndarray,
    metas: Sequence[dict],
    locate_per_shard: Sequence[str],
    bmat_kind: str,
    rs_iters: int,
    config: UpLIFConfig,
    device,
) -> ShardedUpLIF:
    """A ``ShardedUpLIF`` around a stacked ``state_from_numpy(...)`` (every
    leaf with a leading shard axis). ``metas`` holds one dict per shard with
    ``rs_static`` (4 ints), ``gmm`` (weights, means, stds), ``alpha`` and
    ``reservoir``; ``locate_per_shard`` is the per-shard strategy axis and
    ``config`` the router's own (its per-shard BMAT budget)."""
    state = state_from_numpy(slots, model, bmat, counters, device=device)
    meta = [
        _ShardMeta(
            rs_static=RSStatic(*(int(x) for x in m["rs_static"])),
            gmm=_tensors(GMMState, m["gmm"], "cpu"),
            alpha=float(m["alpha"]),
            reservoir=np.asarray(m["reservoir"], dtype=np.int64).copy(),
        )
        for m in metas
    ]
    return ShardedUpLIF.from_state(
        state, boundaries=np.asarray(boundaries, dtype=np.int64).copy(),
        meta=meta, config=config, bmat_kind=bmat_kind, rs_iters=rs_iters,
        locate_per_shard=locate_per_shard, device=device,
    )
