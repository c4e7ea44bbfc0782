"""The benchmark of the PyTorch/CUDA port of UpLIF: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name (``perfbench/perfharness/spec.py``). The run
sets up the system from the seed, measures for ``--seconds`` seconds and
checks every answer it sampled, and the contents after the window,
against the plain reference (``perfbench/reference.py``). Its last line
on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics with ``--trace 0``, the
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which also end standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits with 2 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / "build" / "perfbench_cache"


def _environment():
    """Every build and kernel cache at a fixed path inside the checkout,
    set before torch is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    for p in (str(ROOT / "src"), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    _environment()
    from perfharness import cell as cellmod
    from perfharness import spec

    try:
        cell = spec.find_cell(args.workload)
    except spec.SpecError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card is available; the benchmark runs "
              "only on one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are available", file=sys.stderr)
        return 2
    try:
        out = cellmod.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_process=T_PROCESS)
    except Exception:  # noqa: BLE001 — the run failed: no result line
        traceback.print_exc()
        return 1
    out.pop("_record")
    for line in out.pop("_examples"):
        print(f"wrong: {line}", file=sys.stderr)
    found = cellmod.forbidden_modules()
    if found:
        print("perfbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 1
    for name, c in out["check"].items():
        lim = f" limit {c['limit']}" if "limit" in c else ""
        print(f"check {name} {c['value']}{lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
