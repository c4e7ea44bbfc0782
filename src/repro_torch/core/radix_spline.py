"""RadixSpline base model (port of ``repro/core/radix_spline.py``).

The build is a greedy spline corridor over the sorted (key, position)
pairs: on a CUDA device K8 (``repro_torch/kernels/spline_corridor.py``)
finds the knots, elsewhere the host numpy loop of ``_greedy_spline_knots``,
which K8 is held to knot for knot; the radix table over the knots is built
with numpy on the host either way. Prediction is a batched torch program:
radix-table prefix lookup, bounded branchless binary search over the knots,
and linear interpolation in float64 (the ``"spline"`` locate strategy).
The fused kernel in ``repro_torch/kernels/spline_lookup.py`` does the same
search with float32 interpolation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import RadixSplineModel, RSStatic
from repro_torch.kernels.ops import native_kernels
from repro_torch.kernels.spline_corridor import spline_corridor

_DEF_WINDOW = 8192  # max spline-segment span; caps corridor scan cost at O(N)


def _greedy_spline_knots(
    keys: np.ndarray, pos: np.ndarray, max_error: int, window: int = _DEF_WINDOW
) -> np.ndarray:
    """GreedySplineCorridor: pick knot indices so linear interpolation between
    consecutive knots is within ``max_error`` positions of every data point.

    Vectorized per-window: from anchor ``i`` the feasible slope corridor is
    [cummax((pos-err-pos_i)/dx), cummin((pos+err-pos_i)/dx)]; the knot is
    placed just before the first point whose own slope exits the corridor.
    """
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    knots = [0]
    i = 0
    kf = keys.astype(np.float64)
    pf = pos.astype(np.float64)
    while i < n - 1:
        j_end = min(n, i + window)
        dx = kf[i + 1 : j_end] - kf[i]
        slope = (pf[i + 1 : j_end] - pf[i]) / dx
        hi = (pf[i + 1 : j_end] + max_error - pf[i]) / dx
        lo = (pf[i + 1 : j_end] - max_error - pf[i]) / dx
        # corridor *before* point m (exclusive): shift accumulations by one
        hi_before = np.concatenate(([np.inf], np.minimum.accumulate(hi)[:-1]))
        lo_before = np.concatenate(([-np.inf], np.maximum.accumulate(lo)[:-1]))
        ok = (slope <= hi_before) & (slope >= lo_before)
        bad = np.nonzero(~ok)[0]
        if bad.size == 0:
            nxt = j_end - 1
        else:
            nxt = i + int(bad[0])
        if nxt == i:  # always make progress
            nxt = i + 1
        knots.append(nxt)
        i = nxt
    if knots[-1] != n - 1:
        knots.append(n - 1)
    return np.asarray(knots, dtype=np.int64)


def build_radix_spline(
    keys: np.ndarray,
    positions: np.ndarray,
    *,
    radix_bits: int = 16,
    max_error: int = 32,
    device,
) -> Tuple[RadixSplineModel, RSStatic]:
    """Build the model mapping sorted int64 ``keys`` -> ``positions`` and
    place its arrays on ``device``; on a CUDA device K8 finds the knots."""
    keys = np.asarray(keys, dtype=np.int64)
    positions = np.asarray(positions, dtype=np.int64)
    if keys.ndim != 1 or keys.shape != positions.shape:
        raise ValueError("keys and positions must be 1-D of equal length")
    if len(keys) > 1 and not np.all(np.diff(keys) > 0):
        raise ValueError("keys must be strictly increasing")
    if not np.all(keys >= 0):
        raise ValueError("key domain is non-negative int64")

    if native_kernels(device):
        knot_idx = spline_corridor(
            torch.as_tensor(keys, device=device),
            torch.as_tensor(positions, device=device),
            max_error, _DEF_WINDOW,
        ).cpu().numpy()
    else:
        knot_idx = _greedy_spline_knots(keys, positions, max_error)
    sk = keys[knot_idx]
    sp = positions[knot_idx].astype(np.float64)
    n_spline = len(sk)

    # radix table: table[b] = first spline index with prefix >= b, plus two
    # trailing guards
    max_key = int(keys[-1]) if len(keys) else 1
    sig_bits = max(1, int(max_key).bit_length())
    shift = max(0, sig_bits - radix_bits)
    n_buckets = 1 << radix_bits
    prefixes = (sk >> shift).astype(np.int64)
    table = np.searchsorted(prefixes, np.arange(n_buckets + 2), side="left")
    table = np.minimum(table, n_spline - 1).astype(np.int32)

    # bound the binary search depth by the widest radix bucket
    spans = np.diff(np.clip(table, 0, n_spline - 1).astype(np.int64))
    max_span = int(spans.max()) + 2 if len(spans) else 2
    n_iters = max(1, int(np.ceil(np.log2(max_span + 1))))

    # pad knots with one trailing copy so segment s+1 is always readable
    sk_pad = np.concatenate([sk, sk[-1:]])
    sp_pad = np.concatenate([sp, sp[-1:]])

    model = RadixSplineModel(
        table=torch.as_tensor(table, device=device),
        spline_keys=torch.as_tensor(sk_pad, device=device),
        spline_pos=torch.as_tensor(sp_pad, device=device),
        shift=torch.tensor(shift, dtype=torch.int32, device=device),
    )
    static = RSStatic(
        radix_bits=radix_bits,
        max_error=max_error,
        n_search_iters=n_iters,
        n_spline=n_spline,
    )
    return model, static


def _rs_predict_impl(
    model: RadixSplineModel, keys: torch.Tensor, n_iters: int
) -> torch.Tensor:
    """Float64 predicted slot position per int64 key."""
    n_spline = model.spline_keys.shape[0] - 1
    n_buckets = model.table.shape[0] - 2
    b = torch.clamp(keys >> model.shift.to(torch.int64), 0, n_buckets - 1)
    lo = torch.clamp(model.table[b].to(torch.int64), min=1) - 1
    hi = torch.clamp(model.table[b + 1].to(torch.int64), 0, n_spline - 1)
    # rightmost knot with spline_keys[s] <= k, branchless bounded search
    for _ in range(n_iters):
        mid = (lo + hi + 1) >> 1
        go = model.spline_keys[mid] <= keys
        lo, hi = torch.where(go, mid, lo), torch.where(go, hi, mid - 1)
    s = torch.clamp(lo, 0, n_spline - 1)
    k0 = model.spline_keys[s]
    k1 = model.spline_keys[s + 1]
    p0 = model.spline_pos[s]
    p1 = model.spline_pos[s + 1]
    dk = (keys - k0).to(torch.float64)
    seg = torch.clamp((k1 - k0).to(torch.float64), min=1.0)
    t = torch.clamp(dk / seg, 0.0, 1.0)
    return p0 + t * (p1 - p0)


def rs_predict(
    model: RadixSplineModel, static: RSStatic, keys: torch.Tensor
) -> torch.Tensor:
    """Predict float positions for a batch of int64 keys (error <= max_error
    at every trained key; clamped extrapolation outside the key range)."""
    return _rs_predict_impl(model, keys, static.n_search_iters)


def rs_memory_bytes(model: RadixSplineModel) -> int:
    """Index-structure footprint of the base model (for §5.5 accounting)."""
    return sum(a.numel() * a.element_size() for a in model)
