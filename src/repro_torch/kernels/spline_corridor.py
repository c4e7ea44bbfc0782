"""K8 — the spline corridor: the radix spline's knot indices
(GreedySplineCorridor) as a CUDA kernel pair, and its plain torch version.

Replaces no TPU kernel. Both packages build the spline on the host, in the
loop of ``_greedy_spline_knots`` (``src/repro/core/radix_spline.py``, and
its copy in ``repro_torch/core/radix_spline.py``), which this kernel pair
is held to knot for knot: one NumPy step per knot, each over the next
window (8192) of points, about 90,000 steps at 16M keys. The CUDA source
is ``csrc/spline_corridor.cu``; its header says what bounds it on the H100
(float64 division, and the chain's dependent reads) and what the design
does about it (every anchor's next knot at once, a thread per anchor;
then one block walks the chain through tiles staged in shared memory).

Both versions give the same knots, bit for bit with the host loop,
because they repeat its float64 operations one by one: keys and positions
rounded to float64 (exact below 2^53, round to nearest above), then
``dx = kf[m] - kf[i]``, ``slope = (pf[m] - pf[i]) / dx`` and the bounds
``((pf[m] +- E) - pf[i]) / dx``, whose running minimum and maximum carry
a NaN on as NumPy's do (keys that round to one float64 give ``dx`` 0).

``spline_corridor`` launches the kernels for CUDA tensors (or raises) and
runs ``spline_corridor_plain`` for CPU tensors; ``spline_corridor.launches``
counts the CUDA launches, two a call with two or more keys. The call reads
the knot count back once (a host sync), and the scratch it allocates (the
next-knot array, the chain's buffer and its count) is freed when it
returns.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels import build

_I32_MAX = torch.iinfo(torch.int32).max
ANCHORS = 1 << 14  # plain version: anchors a chunk
COLUMNS = 64       # plain version: points a step of each anchor's scan


def next_knots_plain(keys, positions, max_error: int, window: int):
    """The next knot of every anchor ``i < n - 1`` (int64 [n - 1]): the
    host loop's step from ``i``, vectorised over a chunk of anchors at a
    time and ``COLUMNS`` points of their scans at a time, the anchors
    whose corridor closed dropped after each step."""
    n = keys.shape[0]
    dev = keys.device
    kf = keys.to(torch.float64)
    pf = positions.to(torch.float64)
    e = float(max_error)
    nxt = torch.empty(max(n - 1, 0), dtype=torch.int64, device=dev)
    for a0 in range(0, n - 1, ANCHORS):
        i = torch.arange(a0, min(a0 + ANCHORS, n - 1), device=dev)
        end = torch.clamp(i + window, max=n)
        out = end - 1  # where no point leaves the corridor
        ki, pi = kf[i][:, None], pf[i][:, None]
        hi_min = torch.full_like(ki, float("inf"))
        lo_max = torch.full_like(ki, float("-inf"))
        alive = torch.arange(i.shape[0], device=dev)
        for c0 in range(1, window, COLUMNS):
            if alive.numel() == 0:
                break
            m = (i[alive][:, None]
                 + torch.arange(c0, min(c0 + COLUMNS, window), device=dev))
            e_alive = end[alive][:, None]
            inside = m < e_alive
            mm = torch.clamp(m, max=n - 1)
            km, pm = kf[mm], pf[mm]
            dx = km - ki[alive]
            p0 = pi[alive]
            slope = (pm - p0) / dx
            hi = torch.minimum(torch.cummin((pm + e - p0) / dx, 1).values,
                               hi_min[alive])
            lo = torch.maximum(torch.cummax((pm - e - p0) / dx, 1).values,
                               lo_max[alive])
            hi_before = torch.cat([hi_min[alive], hi[:, :-1]], 1)
            lo_before = torch.cat([lo_max[alive], lo[:, :-1]], 1)
            bad = ~((slope <= hi_before) & (slope >= lo_before)) & inside
            has = bad.any(1)
            first = torch.argmax(bad.to(torch.int8), 1)
            out[alive[has]] = m[has, first[has]] - 1
            # a corridor closes at its first failing point or at its end
            open_ = ~has & (m[:, -1] < e_alive[:, 0] - 1)
            hi_min[alive[open_]] = hi[open_, -1:]
            lo_max[alive[open_]] = lo[open_, -1:]
            alive = alive[open_]
        nxt[a0:a0 + i.shape[0]] = torch.where(out == i, i + 1, out)
    return nxt


def walk_chain(nxt, n: int):
    """The knots: the chain ``0 -> nxt[0] -> ...`` while below ``n - 1``,
    then ``n - 1`` if the chain did not end there (int64, on ``nxt``'s
    device)."""
    if n < 2:
        return torch.zeros(n, dtype=torch.int64, device=nxt.device)
    step = nxt.tolist()
    knots = [0]
    i = 0
    while i < n - 1:
        i = step[i]
        knots.append(i)
    if knots[-1] != n - 1:
        knots.append(n - 1)
    return torch.tensor(knots, dtype=torch.int64, device=nxt.device)


def spline_corridor_plain(keys, positions, max_error: int, window: int):
    """Plain torch version of K8 (the module's contract)."""
    nxt = next_knots_plain(keys, positions, max_error, window)
    return walk_chain(nxt, keys.shape[0])


def _check(keys, positions, max_error, window) -> tuple[int, int]:
    for name, x in (("keys", keys), ("positions", positions)):
        if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    if positions.device != keys.device or positions.shape != keys.shape:
        raise ValueError("keys and positions must be of one length on one "
                         "device")
    if keys.shape[0] > _I32_MAX:
        raise ValueError(f"K8 takes at most {_I32_MAX} keys")
    if operator.index(window) < 1:
        raise ValueError(f"window must be positive, got {window}")
    return operator.index(max_error), operator.index(window)


def spline_corridor(keys, positions, max_error: int, window: int):
    """K8: the knot indices (int64, on the keys' device) of the greedy
    spline corridor over sorted int64 ``keys`` and their int64
    ``positions``, within ``max_error`` positions, each segment at most
    ``window`` points. The CUDA kernels for CUDA tensors, the plain version
    for CPU tensors."""
    max_error, window = _check(keys, positions, max_error, window)
    if keys.device.type == "cpu":
        return spline_corridor_plain(keys, positions, max_error, window)
    if keys.device.type != "cuda":
        raise ValueError(f"no spline corridor kernel for {keys.device}")
    n = keys.shape[0]
    if n < 2:
        return torch.zeros(n, dtype=torch.int64, device=keys.device)
    dev = keys.device
    nxt = torch.empty(n - 1, dtype=torch.int32, device=dev)
    knots = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = build.library().spline_corridor_launch(
        keys.data_ptr(), positions.data_ptr(), nxt.data_ptr(),
        knots.data_ptr(), count.data_ptr(), n, max_error, window,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "spline_corridor")
    build.count_launch(spline_corridor)
    build.count_launch(spline_corridor)
    return knots[:int(count.item())].to(torch.int64)


spline_corridor.launches = 0
