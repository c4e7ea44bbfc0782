"""Run the check's control at a cell's own size: the plain reference put
in the program's place, with its keys held and compared as float32 (the
nearest precision below the exact 64-bit keys the configurations state).
Every number the check compares must come out above its limit.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \
        [--seconds 5] [--out out/control.jsonl]

One line of JSON per seed: the cell, the seed and each number compared
with its limit. The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR.parent / "src"), str(BENCH_DIR)]

from perfharness import cell as cellmod  # noqa: E402
from perfharness import spec, systems  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    c = spec.find_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = cellmod.run_cell(c, seed, args.seconds, False, device=device,
                               factory=systems.Control, t_process=t0)
        row = {"cell": c.name, "seed": seed, "correct": out["correct"],
               "attempted": out["attempted"], "check": out["check"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0 if not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
