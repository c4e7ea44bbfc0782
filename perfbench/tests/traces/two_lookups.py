"""Two lookup waves in a profiled stretch of 100 ms: K1 and K2 twice each
and one copy back on the device, the harness's spans and the kernels'
bytes of a 10 s window, and the program's spans of the two lookups, after
an insert of an earlier stretch (``uplif``'s top spans)."""
from __future__ import annotations

import program_trace

from perfharness import cell, spec, trace


def profile(short: bool = False) -> trace.Profile:
    return trace.Profile(
        window_s=0.1, waves=2,
        device=[
            ("fused_locate_kernel(long const*)", 0.010, 0.013),
            ("bmat_rank_kernel(long const*)", 0.020, 0.022),
            ("Memcpy DtoH (Device -> Pageable)", 0.030, 0.031),
            ("fused_locate_kernel(long const*)", 0.050, 0.054),
            ("bmat_rank_kernel(long const*)", 0.060, 0.063),
        ],
        spans=[("index.lookup", 0.0, 0.04), ("gen", 0.04, 0.05),
               ("index.lookup", 0.05, 0.09)],
        launched={"fused_locate": 2, "bmat_rank": 2}, short=short, tries=1)


def record(short: bool = False) -> cell.RunRecord:
    return cell.RunRecord(
        window_s=10.0, waves=4,
        spans={"index.lookup": [0.001, 0.002, 0.003],
               "index.insert": [0.010, 0.012, 0.011]},
        profile=profile(short),
        kernel_bytes={"k1": [335_000, 335_000], "k2": [67_000]},
        ops=16_384,
        program_spans=spec.system("uplif").PROGRAM_SPANS,
    )


def play():
    program_trace.play([
        program_trace.insert_call(0.5, 0.010, 0.004, 400, 100),
        program_trace.lookup_call(1.0), program_trace.lookup_call(2.0)])
