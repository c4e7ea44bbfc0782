"""The build phase of maintenance (port of the build part of
``repro/tuning/executor.py``).

``build`` turns one declarative ``MaintenancePlan`` into a ``StateDelta``
by running the host-side unstack/retrain/split/merge machinery against an
immutable ``RouterSnapshot``: it never touches the live router's tensors.
The synchronous scheduler calls ``build`` and ``commit`` back to back. The
worker-thread pool that overlaps builds with serving waves
(``MaintenanceExecutor``) arrives with the async/serving slice of the
port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.sharded import (
    RouterSnapshot,
    StateDelta,
    merge_shells,
    retrain_shell_fitted,
    split_point,
    split_shells,
)
from repro_torch.tuning.controller import (
    A_MERGE_SHARDS,
    A_RETRAIN_SHARD,
    A_SPLIT_SHARD,
)

#: plan actions that require a build phase (everything else — switch-BMAT,
#: presize — is metadata/capacity-only and executes directly at plan time)
BUILD_ACTIONS = (A_RETRAIN_SHARD, A_SPLIT_SHARD, A_MERGE_SHARDS)


@dataclasses.dataclass
class BuildResult:
    """One finished build: the delta to commit, or why there is none.

    ``delta is None`` with ``error is None`` means the build concluded the
    action is a structural no-op (e.g. a split of a shard whose live keys
    collapsed to one value) — the plan is abandoned, not failed."""

    plan: object                    # the MaintenancePlan that was built
    delta: Optional[StateDelta]
    build_seconds: float
    error: Optional[Exception] = None


def build(plan, snapshot: RouterSnapshot) -> Optional[StateDelta]:
    """Plan + immutable snapshot -> StateDelta (a pure host build).

    Reads only the snapshot; every tensor it produces is new. Returns None
    when the action degenerates (unsplittable or unmergeable shards) — the
    same conditions under which the live entry points return False."""
    t0 = time.perf_counter()
    s = plan.shard
    if plan.action == A_RETRAIN_SHARD:
        shell = snapshot.shell(s)
        retrain_shell_fitted(
            shell, int(snapshot.state.slots.keys.shape[1]), gmm=plan.gmm
        )
        lo, hi = snapshot.shard_bounds(s)
        return StateDelta(
            epoch=snapshot.epoch, kind="retrain", shard=s,
            key_lo=lo, key_hi=hi, shells=(shell,),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    if plan.action == A_SPLIT_SHARD:
        shell = snapshot.shell(s)
        keys, vals = shell.extract_live()
        mid = split_point(keys)
        if mid is None:
            return None
        left, right = split_shells(shell, keys, vals, mid, snapshot.cfg)
        lo, hi = snapshot.shard_bounds(s)
        return StateDelta(
            epoch=snapshot.epoch, kind="split", shard=s,
            key_lo=lo, key_hi=hi, shells=(left, right),
            boundary=int(keys[mid]),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    if plan.action == A_MERGE_SHARDS:
        if snapshot.n_shards < 2 or not (0 <= s < snapshot.n_shards - 1):
            return None
        sh1, sh2 = snapshot.shell(s), snapshot.shell(s + 1)
        k1, v1 = sh1.extract_live()
        k2, v2 = sh2.extract_live()
        keys = np.concatenate([k1, k2])
        vals = np.concatenate([v1, v2])
        if len(keys) == 0:
            return None
        merged = merge_shells(
            sh1, sh2, keys, vals, snapshot.cfg,
            np.random.default_rng(snapshot.epoch),
        )
        lo, _ = snapshot.shard_bounds(s)
        _, hi = snapshot.shard_bounds(s + 1)
        return StateDelta(
            epoch=snapshot.epoch, kind="merge", shard=s,
            key_lo=lo, key_hi=hi, shells=(merged,),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    raise ValueError(f"action {plan.action} has no build phase")
