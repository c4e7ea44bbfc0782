#!/usr/bin/env python3
"""Time design variants of the port's K1 (fused locate) on one GPU.

    python3 k1_variants.py

K1's span search counts the span's slot keys <= q in two dependent rounds:
the last key of every 32-key chunk the span touches, then the one chunk
where the keys pass q (``src/repro_torch/kernels/csrc/fused_locate.cu``).
This script builds two variants of that source beside it and times all
three on one batch:

  * ``committed``: the kernel as committed (through its wrapper);
  * ``chunk16``: one-line chunks (16 keys: 13 probes for L = 192 off a
    line, then one line);
  * ``one_round``: the whole span in one round (every lane reads
    ceil(L / 32) keys: 48 sectors for L = 192), one dependent read fewer.

The batch is ``chip_smoke.py``'s main-path batch shape: the 4M-key wikits
index after 30 write-heavy waves, one mixed wave's 2048 reads and 2048
insert keys. Every variant must equal the committed kernel's ``(j,
start)``. Each is timed warm (``chip_smoke.device_ms``) and with the L2
flushed by a read before each launch (``chip_smoke.cold_ms``), in three
rounds in alternating order. Prints the card and one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "k1_variants"
SPAN_START = "    // 5. count the span's keys <= q"
SPAN_END = "    if (lane == 0) {\n        j_out[i]"
CHUNK = "    int chunk_log2 = 5;"


def variant_sources(src: str, L: int) -> dict:
    """The two variants' sources, patched from the committed one."""
    assert SPAN_START in src and SPAN_END in src and CHUNK in src
    rounds = (L + 31) // 32
    one_round = (
        "    const long long* span = slots + slb + start;\n"
        f"    long long v[{rounds}];\n"
        "#pragma unroll\n"
        f"    for (int r = 0; r < {rounds}; ++r) {{\n"
        "        const int at = r * 32 + lane;\n"
        "        v[r] = at < L ? __ldg(span + at) : 0;\n"
        "    }\n"
        "    int cnt = 0;\n"
        "#pragma unroll\n"
        f"    for (int r = 0; r < {rounds}; ++r)\n"
        "        cnt += __popc(__ballot_sync(\n"
        "            kFull, r * 32 + lane < L && v[r] <= q));\n"
    )
    a, b = src.index(SPAN_START), src.index(SPAN_END)
    return {
        "chunk16": src.replace(CHUNK, "    int chunk_log2 = 4;"),
        "one_round": src[:a] + one_round + src[b:],
    }


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import UpLIF
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.spline_lookup import fused_locate

    keys = make_dataset("wikits", cs.N_KEYS)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=cs.BATCH, seed=0)
    index = UpLIF(runner.init_keys, runner.init_keys + 1)
    for _ in range(30):
        _, ins = runner.next_batch(0.5)
        index.insert(ins, ins + 1)
    batch = np.concatenate(runner.next_batch(0.5))
    k1 = cs.kernel_inputs(torch, index, batch)[0]
    args, kw = k1["args"], k1["kw"]
    shape = cs.k1_shape(k1)

    WORK.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "fused_locate.cu").read_text()
    jobs = {}
    for name, text in variant_sources(src, shape["L"]).items():
        cu, so = WORK / f"{name}.cu", WORK / f"{name}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-I",
             str(build.CSRC), str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.library()
    n = args[5].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    j0, s0 = fused_locate(*args, **kw)
    fns = {"committed": lambda: fused_locate(*args, **kw)}
    regs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln]
        lib = ctypes.CDLL(str(so))
        fn = lib.fused_locate_launch
        fn.argtypes = build.SIGNATURES["fused_locate_launch"]
        fn.restype = ctypes.c_int
        j = torch.empty(n, dtype=torch.int64, device="cuda")
        start = torch.empty_like(j)

        def launch(fn=fn, j=j, start=start):
            build.check(fn(
                *(t.data_ptr() for t in args[:6]), None, j.data_ptr(),
                start.data_ptr(), n, kw["n_table"], kw["n_knots"], kw["cap"],
                kw["window"], kw["rs_iters"], 0, stream), "fused_locate")
        launch()
        torch.cuda.synchronize()
        cs.require(torch.equal(j, j0) and torch.equal(start, s0),
                   f"{name} differs from the committed kernel")
        fns[name] = launch

    res = {name: {"warm_ms": [], "cold_ms": []} for name in fns}
    order = list(fns)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            res[name]["warm_ms"].append(cs.device_ms(torch, fns[name], 500))
            res[name]["cold_ms"].append(cs.cold_ms(torch, fns[name], 200))
    x = torch.zeros(cs.BATCH, dtype=torch.int64, device="cuda")
    print(cs.card_line())
    floor = cs.device_ms(torch, lambda: x.add_(1), 500)
    print(json.dumps({"k1_shape": shape, "queries": n, "ptxas": regs,
                      "variants": res, "floor_ms": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
