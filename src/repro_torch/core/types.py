"""Core state types of the UpLIF index (port of ``repro/core/types.py``).

Structure-of-arrays NamedTuples of torch tensors, with the JAX package's
leaves and dtypes: int64 keys and values, float64 spline positions, bool
occupancy, int32 radix table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Sentinel key stored in padding / fill-forward tails. Real keys must be
# strictly smaller. int64 max keeps the slot arrays sorted with padding last.
KEY_MAX = int(np.iinfo(np.int64).max)
# Sentinel value marking a deleted entry.
TOMBSTONE = int(np.iinfo(np.int64).min)


class RadixSplineModel(NamedTuple):
    """Error-bounded radix spline (Kipf et al. 2020), the paper's base model.

    ``table[b]`` = index of the first spline point whose radix prefix is >= b.
    ``spline_keys``/``spline_pos`` are the knots, padded by one trailing copy
    of the last knot so segment interpolation never reads out of bounds.
    """

    table: torch.Tensor        # int32[2**radix_bits + 2]
    spline_keys: torch.Tensor  # int64[S + 1]
    spline_pos: torch.Tensor   # float64[S + 1]
    shift: torch.Tensor        # int32 scalar — radix shift amount


class RSStatic(NamedTuple):
    """Static (host) metadata for a RadixSplineModel."""

    radix_bits: int
    max_error: int
    n_search_iters: int  # bound on the per-query knot-search depth
    n_spline: int


class GMMState(NamedTuple):
    """1-D Gaussian mixture over the key domain (models D_update). Host-side
    (CPU float64 tensors): only the bulk load's gap sizing reads it."""

    weights: torch.Tensor  # float64[K]
    means: torch.Tensor    # float64[K]
    stds: torch.Tensor     # float64[K]


class BMATState(NamedTuple):
    """Array-packed BMAT delta buffer: ``keys`` sorted ascending with KEY_MAX
    padding, ``size`` live entries, fences = every ``fanout``-th key plus a
    trailing KEY_MAX."""

    keys: torch.Tensor    # int64[capacity]
    vals: torch.Tensor    # int64[capacity]
    fences: torch.Tensor  # int64[capacity // fanout + 1]
    size: torch.Tensor    # int32 scalar


class SlotsState(NamedTuple):
    """The gapped, fill-forward-sorted slot array (in-place store).

    Invariants: ``keys`` is non-decreasing; an occupied slot holds its own
    key; an empty slot holds the key of the next occupied slot to its right
    (KEY_MAX if none).
    """

    keys: torch.Tensor  # int64[capacity]
    vals: torch.Tensor  # int64[capacity]
    occ: torch.Tensor   # bool[capacity]


class OpStats(NamedTuple):
    """Running counters used by the self-tuning agent (Section 4.1)."""

    n_lookups: torch.Tensor          # int64
    n_inplace_inserts: torch.Tensor  # int64
    n_bmat_inserts: torch.Tensor     # int64
    n_conflicts: torch.Tensor        # int64
    min_granularity: torch.Tensor    # int64 — smallest split-segment seen
