"""Nullifier — update placeholders in the key domain (port of
``repro/core/nullifier.py``, Section 3.4).

Given sorted keys and the learned update distribution D_update, inject empty
slots between consecutive keys, sized by Eq. 6 and capped at d_MAX per pair;
the total budget is alpha_target * N (Eq. 7). Host numpy; the slot arrays
are then placed on the requested device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gmm import gmm_cdf_np
from repro_torch.core.types import GMMState, KEY_MAX, SlotsState


class NullifyResult(NamedTuple):
    slots: SlotsState
    positions: np.ndarray  # int64[N] — slot index of each input key
    gaps: np.ndarray       # int64[N] — placeholders placed *before* key i
    alpha: float           # Eq. 7 mean gap actually realized


def gap_sizes(
    keys: np.ndarray,
    gmm: GMMState,
    *,
    alpha_target: float,
    d_max: int,
    quantize: str = "ceil",
) -> np.ndarray:
    """Eq. 6 gap counts for each key (gap before key i; the first key gets
    the [k_0 - 1, k_0] mass). ``quantize`` "ceil" guarantees a slot wherever
    D_update puts any mass; "round" keeps the total near the α·N budget."""
    keys = np.asarray(keys, dtype=np.int64)
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    budget = float(alpha_target) * n
    kf = keys.astype(np.float64)
    edges = np.concatenate([[kf[0] - (kf[1] - kf[0] if n > 1 else 1.0)], kf])
    cdf = gmm_cdf_np(gmm, edges)
    mass = np.maximum(np.diff(cdf), 0.0)
    total = mass.sum()
    if total <= 0:
        mass = np.full(n, 1.0 / n)
        total = 1.0
    quota = budget * mass / total
    if quantize == "round":
        g = np.round(quota).astype(np.int64)
    else:
        g = np.ceil(quota).astype(np.int64)
    return np.minimum(g, int(d_max))


def nullify(
    keys: np.ndarray,
    vals: np.ndarray,
    gmm: GMMState,
    *,
    alpha_target: float = 1.0,
    d_max: int = 64,
    tail_slack: int = 8,
    align: int = 1,
    quantize: str = "ceil",
    device,
) -> NullifyResult:
    """Produce the D_update-expanded slot array (Definition 4).

    Empty slots carry the fill-forward key (next occupied key to the right;
    KEY_MAX in the tail) so the whole array is sorted and binary-searchable.
    ``align`` rounds the capacity up to a multiple (the insert path needs a
    window-aligned capacity for its grid-segment windows).
    """
    keys = np.asarray(keys, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.int64)
    n = len(keys)
    g = gap_sizes(
        keys, gmm, alpha_target=alpha_target, d_max=d_max, quantize=quantize
    )
    positions = (np.cumsum(g) + np.arange(n)).astype(np.int64)
    capacity = int(positions[-1]) + 1 + tail_slack if n else tail_slack
    if align > 1:
        capacity = ((capacity + align - 1) // align) * align

    slot_keys = np.full(capacity, KEY_MAX, dtype=np.int64)
    slot_vals = np.zeros(capacity, dtype=np.int64)
    occ = np.zeros(capacity, dtype=bool)
    slot_keys[positions] = keys
    slot_vals[positions] = vals
    occ[positions] = True
    # fill-forward: an empty slot takes the key of the next occupied slot
    idx = np.where(occ, np.arange(capacity), capacity)
    nxt = np.minimum.accumulate(idx[::-1])[::-1]
    has_next = nxt < capacity
    slot_keys[~occ & has_next] = slot_keys[nxt[~occ & has_next]]

    alpha = float(g.sum()) / max(n, 1)
    slots = SlotsState(
        keys=torch.as_tensor(slot_keys, device=device),
        vals=torch.as_tensor(slot_vals, device=device),
        occ=torch.as_tensor(occ, device=device),
    )
    return NullifyResult(slots=slots, positions=positions, gaps=g, alpha=alpha)
