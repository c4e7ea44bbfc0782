"""Small pieces the metric readers share."""
from __future__ import annotations

from typing import Optional

import numpy as np


def span_pct(run, name: str, q: float) -> Optional[float]:
    """The ``q``-th percentile of a span's durations, in ms."""
    xs = run.spans.get(name)
    if not xs:
        return None
    return 1e3 * float(np.percentile(xs, q))


def idle_share(run) -> Optional[float]:
    """Idle % of the profiled stretch; nothing for a short stretch."""
    p = run.profile
    if p is None or p.short or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
