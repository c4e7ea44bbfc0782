"""A kernel's share of its roofline, from a traced run.

The least time the card could take for a launch is its bytes over the
H100's published HBM bandwidth (NVIDIA's data sheet, SXM part: 3.35 TB/s
at the full 700 W; K1 and K2 do no work that the tensor or vector units
bound). The share is that time over the launch's device time: the mean
bytes per launch that the kernel probe counted past the window, over the
mean device time per launch of the profiled stretch, both over the cell's
own mix of launches. A stretch the profiler saw short, or no launch, gives
no share.
"""
from __future__ import annotations

from typing import Optional

from perfharness import spec

HBM_BYTES_PER_S = 3.35e12


def share(run, name: str) -> Optional[float]:
    mod = spec.kernel_module(name)
    counted = run.kernel_bytes.get(name)
    p = run.profile
    if not counted or p is None or p.short:
        return None
    times = [b - a for n, a, b in p.kernels() if mod.KERNEL in n]
    if not times:
        return None
    t_launch = sum(times) / len(times)
    b_launch = sum(counted) / len(counted)
    return 100.0 * (b_launch / HBM_BYTES_PER_S) / t_launch
