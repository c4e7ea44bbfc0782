"""Load-shedding admission control for the request gateway (port of
``repro/serve/admission.py``).

The overload ladder — shed maintenance BEFORE shedding clients:

  level 0  healthy       backlog below ``shed_maintenance_at`` of capacity;
                         maintenance plans admit normally and the
                         scheduler's token bucket refills from served
                         waves.
  level 1  shed           backlog ≥ ``shed_maintenance_at`` · capacity;
           maintenance    the gateway reports pressure to the maintenance
                         scheduler (``MaintenanceScheduler.set_pressure``):
                         new plan admission pauses, budget refill stops,
                         draining commits advance at a reduced replay cap.
                         Clients are still fully served.
  level 2  shed           backlog ≥ ``shed_requests_at`` · capacity; new
           requests       submissions get an explicit ``RetryAfter`` whose
                         hint is the backlog over the measured drain rate
                         — clients back off instead of queueing into an
                         ever-longer tail.

Levels are computed from the queued-request count alone, so a submit-time
check is exact and cheap; with ``shed_maintenance_at`` strictly below
``shed_requests_at`` a growing backlog ALWAYS crosses the maintenance
threshold first — the shed-before-reject ordering is structural, not a
race (pinned by tests/test_torch_gateway.py).
"""
from __future__ import annotations

import dataclasses


class RetryAfter(RuntimeError):
    """Explicit backpressure: the gateway refused the request; retry no
    sooner than ``retry_after_s`` (the estimated time for the backlog to
    drain below the rejection threshold)."""

    def __init__(self, retry_after_s: float, backlog: int):
        super().__init__(
            f"gateway overloaded ({backlog} queued); "
            f"retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = float(retry_after_s)
        self.backlog = int(backlog)


@dataclasses.dataclass
class AdmissionController:
    """Backlog → overload level, plus the retry-after estimate."""

    capacity: int                       # queued requests the gateway holds
    shed_maintenance_at: float = 0.5    # level-1 threshold (fraction)
    shed_requests_at: float = 0.9       # level-2 threshold (fraction)

    def __post_init__(self):
        if not 0.0 < self.shed_maintenance_at < self.shed_requests_at <= 1.0:
            raise ValueError(
                "need 0 < shed_maintenance_at < shed_requests_at <= 1, got "
                f"{self.shed_maintenance_at}, {self.shed_requests_at}"
            )

    def level(self, backlog: int) -> int:
        if backlog >= self.shed_requests_at * self.capacity:
            return 2
        if backlog >= self.shed_maintenance_at * self.capacity:
            return 1
        return 0

    def retry_after(self, backlog: int, drain_rate: float) -> float:
        """Time until the EXCESS over the rejection threshold drains at the
        measured rate (clamped to [1ms, 5s] so a cold drain-rate estimate
        can neither hammer nor strand clients)."""
        excess = backlog - self.shed_requests_at * self.capacity
        est = max(excess, 1.0) / max(drain_rate, 1.0)
        return float(min(max(est, 0.001), 5.0))
