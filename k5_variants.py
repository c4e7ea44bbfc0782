#!/usr/bin/env python3
"""Time design variants of the port's K5 (spline lookup) on one GPU.

    python3 k5_variants.py

K5 gives a query a warp and finds its knot segment with one 32-lane round
where the bucket's knot range fits it, and with bisect rounds (the next
five steps of the reference's bisect, all 31 probes of a depth-5 decision
tree read at once) where it does not, looking again after every bisect
round whether the rest fits the round
(``src/repro_torch/kernels/csrc/spline_lookup.cu``). This script builds three
variants of that source beside it and times all four:

  * ``committed``: the kernel as committed (through its wrapper);
  * ``tree_walk``: each bisect round walks its five steps in registers
    from the ballot of the probes' outcomes (five dependent steps), where
    the committed round takes the range after them by one shuffle from the
    lane of the path's last node;
  * ``round_first_only``: the round only at the first look; a range wider
    than the round runs bisect rounds to the end, then one read brings the
    interpolation's knots (one dependent read more);
  * ``ballot``: a 32-ary count over the range (lane l reads the last knot
    of the l-th of 32 chunks) in place of each bisect round: fewer
    operations a round, but it equals the bisect only on sorted knots.

The inputs are ``chip_smoke.py``'s kernel-level API mixes (4096 queries:
hits, misses, keys above the domain, KEY_MAX) on the 4M-key wikits index
(radix shift 15) and the 2M-key fb index (shift 36), bulk-loaded, and the
fb mix's queries split by the path the committed kernel takes
(``spline_lookup_paths``: the round at once, or bisect rounds first).
Every variant must equal the committed kernel bit for bit on each input.
Each is timed warm (``chip_smoke.device_ms``), three rounds in alternating
order. Prints the card and one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "k5_variants"
ROUND_IF = ("        if (width >= 1 && width <= kRoundKnots "
            "&& width <= converges) {")
BISECT_START = "        // -- bisect round"
BISECT_END = "        // -- end of the bisect round"
TREE_WALK = """        // -- the bisect round, walking its steps in registers
        const int d = left < kTreeDepth ? left : kTreeDepth;
        const int node = lane + 1;
        const int depth = 31 - __clz(node);
        bool go = false;
        if (depth < d) {
            int a = lo, z = hi;
            for (int lev = depth - 1; lev >= 0; --lev) {
                const int mid = (a + z + 1) >> 1;
                if ((node >> lev) & 1) a = mid;
                else z = mid - 1;
            }
            int mid = (a + z + 1) >> 1;
            mid = mid < 0 ? 0 : (mid > n_knots - 1 ? n_knots - 1 : mid);
            go = __ldg(knots + mid) <= q;
        }
        const unsigned g = __ballot_sync(kFull, go);
        int at = 1;
        for (int step = 0; step < d; ++step) {
            const int mid = (lo + hi + 1) >> 1;
            const bool gs = (g >> (at - 1)) & 1u;
            lo = gs ? mid : lo;
            hi = gs ? hi : mid - 1;
            at = 2 * at + (gs ? 1 : 0);
        }
        left -= d;
"""
BALLOT = """        // -- a 32-ary count over knots[lo + 1 .. hi] (sorted knots only)
        const int step = (hi - lo + 31) >> 5;
        const int first = lo + 1 + lane * step;
        const int last = first + step - 1 < hi ? first + step - 1 : hi;
        const int below = __popc(__ballot_sync(
            kFull, first <= hi && __ldg(knots + last) <= q));
        const int nlo = lo + below * step;
        hi = nlo >= hi ? hi : (nlo + step - 1 < hi ? nlo + step - 1 : hi);
        lo = nlo >= hi ? hi : nlo;
        left -= kTreeDepth;
"""


def variant_sources(src: str) -> dict:
    """The three variants' sources, patched from the committed one."""
    assert ROUND_IF in src and BISECT_START in src and BISECT_END in src
    a, b = src.index(BISECT_START), src.index(BISECT_END)
    return {
        "tree_walk": src[:a] + TREE_WALK + src[b:],
        "round_first_only": src.replace(
            ROUND_IF, ROUND_IF.replace("(width >= 1",
                                       "(left == n_iters && width >= 1")),
        "ballot": src[:a] + BALLOT + src[b:],
    }


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import UpLIF
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.spline_lookup import (
        spline_lookup, spline_lookup_paths,
    )

    inputs, shapes = {}, {}
    for label, n_keys, seed in (("wikits", cs.N_KEYS, 21),
                                ("fb", cs.FB_KEYS, 22)):
        keys = WorkloadRunner(make_dataset(label, n_keys), init_frac=0.5,
                              batch=cs.BATCH, seed=0).init_keys
        index = UpLIF(keys, keys + 1)
        m, st = index.rs_model, index.rs_static
        q = cs.api_batches(torch, index, keys, seed)[0]
        kw = dict(shift=int(m.shift), n_iters=st.n_search_iters)
        model = (m.table, m.spline_keys, m.spline_pos)
        inputs[label] = (model, q, kw)
        shapes[label] = cs.k5_shape(torch, m, q, st.n_search_iters)
        if label == "fb":
            path = spline_lookup_paths(m.table, m.spline_keys, q, **kw)[0]
            for name, sel in (("fb_round_at_once", path == 0),
                              ("fb_bisect_first", path != 0)):
                inputs[name] = (model, q[sel].contiguous(), kw)
        del index

    WORK.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "spline_lookup.cu").read_text()
    jobs = {}
    for name, text in variant_sources(src).items():
        cu, so = WORK / f"{name}.cu", WORK / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-I",
             str(build.CSRC), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.library()
    stream = torch.cuda.current_stream().cuda_stream
    fns = {"committed": {
        k: (lambda a=a, q=q, kw=kw: spline_lookup(*a, q, **kw))
        for k, (a, q, kw) in inputs.items()}}
    want = {k: fn() for k, fn in fns["committed"].items()}
    regs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln]
        lib = ctypes.CDLL(str(so))
        fn = lib.spline_lookup_launch
        fn.argtypes = build.SIGNATURES["spline_lookup_launch"]
        fn.restype = ctypes.c_int
        fns[name] = {}
        for k, ((table, sk, sp), q, kw) in inputs.items():
            out = torch.empty(q.shape[0], dtype=torch.float32, device="cuda")

            def launch(fn=fn, table=table, sk=sk, sp=sp, q=q, kw=kw,
                       out=out):
                build.check(fn(
                    table.data_ptr(), sk.data_ptr(), sp.data_ptr(),
                    q.data_ptr(), out.data_ptr(), q.shape[0],
                    table.shape[0], sk.shape[0], kw["shift"], kw["n_iters"],
                    int(kw["shift"] >= 32), stream), "spline_lookup")
                return out
            got = launch()
            torch.cuda.synchronize()
            cs.require(torch.equal(got.view(torch.int32),
                                   want[k].view(torch.int32)),
                       f"{name} differs from the committed kernel on {k}")
            fns[name][k] = launch

    def timed(fn, what):
        # the profiler on the H100 machine has seen no device event at all
        # in some profiles; such a profile is taken again
        for attempt in range(3):
            try:
                return cs.device_ms(torch, fn, 500)
            except cs.SmokeFailure as err:
                print(f"{what}: {err} (attempt {attempt + 1})",
                      file=sys.stderr, flush=True)
        raise cs.SmokeFailure(f"{what}: no device time in three profiles")

    res = {name: {k: [] for k in inputs} for name in fns}
    order = list(fns)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            for k, fn in fns[name].items():
                res[name][k].append(timed(fn, f"{name} on {k}"))
    x = torch.zeros(cs.BATCH, dtype=torch.int64, device="cuda")
    print(cs.card_line())
    floor = cs.device_ms(torch, lambda: x.add_(1), 500)
    print(json.dumps({"k5_shape": shapes,
                      "queries": {k: v[1].shape[0] for k, v in inputs.items()},
                      "ptxas": regs, "variants_ms": res, "floor_ms": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
