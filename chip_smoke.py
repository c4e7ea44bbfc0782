#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port of UpLIF on one GPU.

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``) and runs:

  1. card     — requires CUDA; prints the card's name and power limit;
  2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
                (nvcc, sm_90a) and prints the build seconds;
  3. main path — bulk-loads 4M wikits keys into ``UpLIF`` with the default
                config ("auto" resolves to the fused kernels), serves the four
                read/write mixes of ``WORKLOADS`` in 4096-op waves and a delete
                phase; every read must be found with value key + 1, deleted
                keys must miss, and both kernels' launch counts must grow in
                every phase; then ``torch.profiler`` over 20 write-heavy
                waves gives the device's busy and idle share per wave and
                its busiest operations;
  4. kernels  — each kernel against its plain torch version on the card, on
                the main path's final state and on an fb index (radix shift
                36), with hits, misses and above-domain keys; K1 also in its
                float64-interpolation mode;
  5. large index — all 8M wikits keys, a capacity above the float32
                position bound: lookups and an insert wave go through K1's
                float64 mode, which must equal the spline path;
  6. whole path — a short op tape through the port on the card and on the
                CPU: visible results, insert overflow counts, live contents
                and the slot and BMAT arrays must be identical;
  7. timing   — on a main-path batch (one mixed wave's 2048 reads and 2048
                insert keys), warmed up: each kernel's device time per
                launch (``ms``, from the profiler's device events), the time
                per call of the ``ops`` adapter the index calls, between
                CUDA events (``call_ms``, host dispatch included), its plain
                version's and a one-call PyTorch yardstick's device time,
                and the bound, printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before it, as does a machine without CUDA.

Bound (``bound_ms``): the larger of bytes over the H100's 3.35 TB/s and
float32 operations over 67 TFLOP/s. Bytes count each element the batch
needs once: the queries and outputs, plus the distinct table, knot,
position, slot, fence and node elements that the plain version reads on
this batch (recorded while it runs), at their stored widths.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH = 4096
N_KEYS = 8_000_000          # wikits keys generated; half are bulk-loaded
WAVES = 200                 # 4096-op waves per read/write mix
DELETE_WAVES = 16
FB_KEYS = 4_000_000
K1_SOURCE = "src/repro_torch/kernels/csrc/fused_locate.cu"
K2_SOURCE = "src/repro_torch/kernels/csrc/bmat_rank.cu"
K1_REPLACES = "src/repro/kernels/spline_lookup.py:208"
K2_REPLACES = "src/repro/kernels/bmat_rank.py:70"


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}"
    )


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_main_path(torch, index, runner, waves: int, delete_waves: int):
    """The four mixes and a delete phase; returns per-phase reports and the
    launch counts of the whole run (counts reset just before it)."""
    from repro_torch.data import WORKLOADS
    from repro_torch.kernels import ops

    for _ in range(2):  # warm-up waves, checked but not timed or counted
        reads, ins = runner.next_batch(0.5)
        f, v = index.lookup(reads)
        require(f.all() and np.array_equal(v, reads + 1), "warm-up reads")
        index.insert(ins, ins + 1)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    phases = []
    for mix, rate in WORKLOADS.items():
        before = ops.launch_counts()
        lat, n_ops, n_reads = [], 0, 0
        for _ in range(waves):
            reads, ins = runner.next_batch(rate)
            t0 = time.perf_counter()
            if len(reads):
                found, vals = index.lookup(reads)
            if len(ins):
                index.insert(ins, ins + 1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            n_ops += len(reads) + len(ins)
            if len(reads):
                n_reads += len(reads)
                require(found.all(), f"{mix}: {int((~found).sum())} reads missed")
                require(np.array_equal(vals, reads + 1), f"{mix}: wrong values")
        phases.append(_phase_report(torch, index, mix, lat, n_ops, before,
                                    ops.launch_counts(), reads=n_reads))

    # delete phase: known keys (bulk-loaded and never deleted before)
    victims = runner.init_keys[:: max(1, len(runner.init_keys) // (delete_waves * BATCH))]
    victims = victims[: delete_waves * BATCH]
    before = ops.launch_counts()
    lat = []
    for w in range(delete_waves):
        chunk = victims[w * BATCH:(w + 1) * BATCH]
        t0 = time.perf_counter()
        hit = index.delete(chunk)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        require(hit.all(), f"delete: {int((~hit).sum())} known keys not hit")
    phases.append(_phase_report(torch, index, "delete", lat, len(victims),
                                before, ops.launch_counts(), reads=0))
    found, _ = index.lookup(victims[:BATCH])
    require(not found.any(), "deleted keys are still found")
    return phases, ops.launch_counts()


def profile_waves(torch, index, runner, rate: float, waves: int):
    """Device busy and idle share over a few mixed waves, from the
    profiler's device events (kernels and copies on the one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(waves):
            reads, ins = runner.next_batch(rate)
            index.lookup(reads)
            index.insert(ins, ins + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("profile: device time not measured (no device events)")
        return None
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rep = {
        "waves": waves, "write_rate": rate,
        "wall_ms_per_wave": wall_ms / waves,
        "device_busy_ms_per_wave": busy_ms / waves,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_wave": len(dev) / waves,
        "k1_k2_device_ms_per_wave": sum(
            v for k, v in by_name.items()
            if "fused_locate_kernel" in k or "bmat_rank_kernel" in k
        ) / 1e3 / waves,
        "top_device_ms_per_wave": {k[:60]: v / 1e3 / waves for k, v in top},
    }
    print("profile " + json.dumps(rep), flush=True)
    return rep


def _phase_report(torch, index, name, lat, n_ops, before, after, reads):
    grew = {k: after[k] - before[k] for k in after}
    require(all(v > 0 for v in grew.values()),
            f"{name}: a kernel was not launched: {grew}")
    lat_ms = np.asarray(lat) * 1e3
    rep = {
        "phase": name,
        "waves": len(lat),
        "ops": n_ops,
        "reads_checked": reads,
        "mops_per_s": n_ops / float(np.sum(lat)) / 1e6,
        "wave_ms_p50": float(np.percentile(lat_ms, 50)),
        "wave_ms_p99": float(np.percentile(lat_ms, 99)),
        "launches_per_wave": {k: v / len(lat) for k, v in grew.items()},
        "bmat_size": index.bmat.size,
        "capacity": index.capacity,
        "device_mem_mib": torch.cuda.memory_allocated() / 2**20,
    }
    print("phase " + json.dumps(rep), flush=True)
    return rep


# ---------------------------------------------------------------------------
# kernel inputs, comparisons and timing
# ---------------------------------------------------------------------------


def kernel_inputs(torch, index, queries):
    """K1 and K2 inputs as the main path gives them, for one query batch
    (a single index, so no shard ids)."""
    st = index.fstatic()
    m, b = index.rs_model, index.bmat.state
    q = torch.as_tensor(queries, device=index.device)
    k1 = dict(
        args=(m.table, m.spline_keys, m.spline_pos, m.shift.reshape(1),
              index.slots.keys, q),
        kw=dict(n_table=m.table.shape[0], n_knots=m.spline_keys.shape[0],
                cap=index.capacity, window=st.window, rs_iters=st.rs_iters),
    )
    k2 = dict(
        args=(b.keys, b.fences, q),
        kw=dict(cap=b.keys.shape[0], nf=b.fences.shape[0], fanout=st.fanout),
    )
    return k1, k2


def query_mix(rng, keys, n=BATCH):
    """Hits, misses inside the domain, keys above it, and KEY_MAX."""
    from repro_torch.core.types import KEY_MAX

    lo, hi = int(keys[0]), int(keys[-1])
    return np.concatenate([
        rng.choice(keys, n // 2),
        rng.integers(lo, hi, n // 4),
        hi + 1 + rng.integers(0, 1 << 40, n // 4 - 2),
        [KEY_MAX, KEY_MAX],
    ]).astype(np.int64)


def compare_kernels(torch, index, queries, label):
    """Each kernel against its plain version on the card (K1 in both of its
    interpolation modes); returns (k1 max abs err, k2 max abs err)."""
    from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain
    from repro_torch.kernels.spline_lookup import (
        fused_locate, fused_locate_plain,
    )

    k1, k2 = kernel_inputs(torch, index, queries)
    W = index.cfg.window
    err1 = 0
    for interp64 in (False, True):
        kw = dict(k1["kw"], interp64=interp64)
        j, start = fused_locate(*k1["args"], **kw)
        j0, start0 = fused_locate_plain(*k1["args"], **kw)
        torch.cuda.synchronize()
        mode = "float64" if interp64 else "float32"
        print(f"kernels[{label}]: K1 {mode} j differ {int((j != j0).sum())}, "
              f"start rows differ {int((start != start0).sum())} "
              f"(expected 0)", flush=True)
        require(torch.equal(j, j0),
                f"{label}: K1 ({mode}) j differs from its plain version")
        require(int((start - start0).abs().max()) <= W,
                f"{label}: K1 ({mode}) start differs by more than one row")
        err1 = max(err1, int((j - j0).abs().max()),
                   int((start - start0).abs().max()))
    r = bmat_rank(*k2["args"], **k2["kw"])
    r0 = bmat_rank_plain(*k2["args"], **k2["kw"])
    torch.cuda.synchronize()
    print(f"kernels[{label}]: K2 ranks differ {int((r != r0).sum())}; "
          f"bmat_size {index.bmat.size}, capacity {index.capacity}, shift "
          f"{int(index.rs_model.shift)}", flush=True)
    require(torch.equal(r, r0), f"{label}: K2 differs from its plain version")
    return err1, int((r - r0).abs().max())


def read_footprint(torch, plain, args, kw, arrays) -> int:
    """Bytes of the distinct elements of ``arrays`` (name -> tensor passed
    in ``args``) that one call of the plain version reads, recorded from
    its indexing while it runs."""
    from torch.overrides import TorchFunctionMode

    seen = {name: [] for name in arrays}

    class Reads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and isinstance(
                    args[1], torch.Tensor):
                for name, a in arrays.items():
                    if args[0] is a:
                        seen[name].append(args[1].reshape(-1))
            return func(*args, **(kwargs or {}))

    with Reads():
        plain(*args, **kw)
    return sum(
        int(torch.unique(torch.cat(idx)).numel()) * arrays[name].element_size()
        for name, idx in seen.items() if idx
    )


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the sum of the profiler's device events (the
    kernels and copies the call ran) over ``iters`` calls, divided by
    ``iters``. Host dispatch between launches is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    require(us, "the profiler saw no device time")
    return sum(us) / 1e3 / iters


def call_ms(torch, fn, iters: int) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back
    calls: the kernel plus whatever host dispatch it cannot hide."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(n_bytes: float, n_f32_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_timing(torch, index, queries):
    from repro_torch.kernels import ops
    from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain
    from repro_torch.kernels.spline_lookup import (
        fused_locate, fused_locate_plain,
    )

    k1, k2 = kernel_inputs(torch, index, queries)
    q = k1["args"][5]
    n = q.shape[0]
    m, b = index.rs_model, index.bmat.state
    slot_keys = index.slots.keys
    # queries in, (j, start) out, the shift, and the distinct probes
    k1_bytes = n * (8 + 16) + m.shift.element_size() + read_footprint(
        torch, fused_locate_plain, k1["args"], k1["kw"],
        dict(table=m.table, spline_keys=m.spline_keys,
             spline_pos=m.spline_pos, slot_keys=slot_keys),
    )
    k1_ops = n * 12  # conversions, subs, mul, div, clamps, fma, round
    # queries in, rank out, and the distinct fence and node probes
    k2_bytes = n * (8 + 8) + read_footprint(
        torch, bmat_rank_plain, k2["args"], k2["kw"],
        dict(keys=b.keys, fences=b.fences),
    )
    calls = {
        "fused_locate": (
            lambda: fused_locate(*k1["args"], **k1["kw"]),
            lambda: ops.fused_locate(*k1["args"], **k1["kw"]),
            lambda: fused_locate_plain(*k1["args"], **k1["kw"]),
            lambda: torch.searchsorted(slot_keys, q, right=True),
            k1_bytes, bound_ms(k1_bytes, k1_ops),
        ),
        "bmat_rank": (
            lambda: bmat_rank(*k2["args"], **k2["kw"]),
            lambda: ops.bmat_rank_fused(*k2["args"], **k2["kw"]),
            lambda: bmat_rank_plain(*k2["args"], **k2["kw"]),
            lambda: torch.searchsorted(b.keys, q),
            k2_bytes, bound_ms(k2_bytes, 0),
        ),
    }
    return {
        name: dict(
            ms=device_ms(torch, kern, 200),
            call_ms=call_ms(torch, adapter, 200),
            plain_ms=device_ms(torch, plain, 10),
            library_ms=device_ms(torch, lib, 200),
            bytes=n_bytes,
            bound=bound,
        )
        for name, (kern, adapter, plain, lib, n_bytes, bound) in calls.items()
    }


# ---------------------------------------------------------------------------
# an index above the float32 position bound
# ---------------------------------------------------------------------------


def large_index(torch, keys):
    """All generated keys in one index, whose capacity exceeds the float32
    position bound: lookups and an insert wave must go through K1 in its
    float64 mode, and K1 must equal the spline path there."""
    from repro_torch.core import UpLIF, fops
    from repro_torch.core.state import LOCATE_SPLINE
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    big = UpLIF(keys, keys + 1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    m = big.rs_model
    require(big.capacity > ops.MAX_F32_POSITIONS and not ops.locate_fusable(
        big.capacity, m.spline_keys.shape[0]),
        "large index: capacity is within the float32 position bound")
    require(big.locate_strategy() == "fused", "large index: not fused")
    reads = rng.choice(keys, BATCH)
    fresh = np.setdiff1d(rng.integers(int(keys[0]), int(keys[-1]), 2 * BATCH),
                         keys)[:BATCH]
    ops.reset_launch_counts()
    found, vals = big.lookup(reads)
    require(found.all() and np.array_equal(vals, reads + 1),
            "large index: reads")
    big.insert(fresh, fresh + 1)
    found, vals = big.lookup(fresh)
    require(found.all() and np.array_equal(vals, fresh + 1),
            "large index: inserted keys")
    counts = ops.launch_counts()
    require(all(v > 0 for v in counts.values()),
            f"large index: a kernel was not launched: {counts}")
    st = big.fstatic()
    q = torch.as_tensor(query_mix(rng, keys), device=big.device)
    jf, cf = fops._locate(st, big.slots.keys, m, q)
    js, cs = fops._locate(st._replace(locate=LOCATE_SPLINE), big.slots.keys,
                          m, q)
    require(torch.equal(jf, js) and torch.equal(cf, cs),
            "large index: K1 (float64) differs from the spline path")
    print(f"large index: {len(keys)} keys loaded in {load_s:.1f} s, capacity "
          f"{big.capacity}, shift {int(m.shift)}; reads and inserts found; "
          f"launches {counts}; K1 float64 == spline path on "
          f"{q.shape[0]} queries", flush=True)
    err = compare_kernels(torch, big, query_mix(rng, keys), "wikits-8M")
    del big
    return err


# ---------------------------------------------------------------------------
# whole path: the card against the CPU
# ---------------------------------------------------------------------------


def tape(seed: int = 5, n: int = 40_000):
    from repro_torch.data import make_dataset

    r = np.random.default_rng(seed)
    keys = make_dataset("wikits", 2 * n, seed)
    base = np.sort(r.choice(keys, n, replace=False))
    fresh = np.setdiff1d(keys, base)
    hot = r.integers(int(base[500]), int(base[560]), 3000).astype(np.int64)
    dups = np.concatenate([hot[:400], hot[:400], base[100:500]])
    ops_tape = [
        ("insert", fresh[:20_000], fresh[:20_000] + 11),
        ("insert", hot, hot + 13),
        ("delete", np.concatenate([base[300:2300], fresh[:800], hot[:300]])),
        ("insert", dups, dups + 17),
        ("insert", fresh[20_000:], fresh[20_000:] + 19),
    ]
    probes = np.concatenate([base[::7], fresh[::5], hot[::3],
                             r.integers(0, int(keys[-1]) * 2, 3000)])
    return base, ops_tape, probes


def card_vs_cpu(torch):
    from repro_torch.core import UpLIF, UpLIFConfig

    base, ops_tape, probes = tape()
    cfg = UpLIFConfig(locate="fused")
    results = {}
    for dev in ("cuda", "cpu"):
        idx = UpLIF(base, base + 1, cfg, device=dev)
        out = []
        for op in ops_tape:
            if op[0] == "insert":
                out.append(np.asarray(idx.insert(op[1], op[2])))
            else:
                out.append(idx.delete(op[1]))
            out.extend(idx.lookup(probes))
        out.extend(idx.extract_live())
        arrays = [a.cpu().numpy() for a in (*idx.slots, idx.bmat.state.keys,
                                            idx.bmat.state.vals)]
        results[dev] = (out, arrays)
    for a, b in zip(results["cuda"][0], results["cpu"][0]):
        require(np.array_equal(a, b), "card and CPU differ on the op tape")
    for a, b in zip(results["cuda"][1], results["cpu"][1]):
        require(np.array_equal(a, b), "card and CPU slot or BMAT arrays differ")
    print(f"whole path: card == CPU on {len(ops_tape)} ops (results, overflow "
          f"counts, live contents, slot and BMAT arrays)", flush=True)


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import UpLIF
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    _, log, secs = build.build()
    build.library()
    print(f"build: {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    keys = make_dataset("wikits", N_KEYS)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=BATCH, seed=0)
    t0 = time.perf_counter()
    index = UpLIF(runner.init_keys, runner.init_keys + 1)
    torch.cuda.synchronize()
    print(f"bulk load: {len(runner.init_keys)} keys in "
          f"{time.perf_counter() - t0:.1f} s, capacity {index.capacity}, "
          f"shift {int(index.rs_model.shift)}, knots {index.rs_static.n_spline}, "
          f"rs_iters {index.rs_static.n_search_iters}, "
          f"locate {index.locate_strategy()}", flush=True)
    require(index.locate_strategy() == "fused", "auto did not resolve to fused")
    m = index.rs_model
    require(ops.locate_fusable(index.capacity, m.spline_keys.shape[0]),
            "the main path's index is above the float32 position bound")

    phases, launches = run_main_path(torch, index, runner, WAVES, DELETE_WAVES)
    print(f"main path launches: {launches}", flush=True)
    profile_waves(torch, index, runner, rate=0.5, waves=20)

    rng = np.random.default_rng(1)
    errs = [compare_kernels(torch, index, query_mix(rng, runner.init_keys),
                            "wikits")]
    fb_keys = make_dataset("fb", FB_KEYS)
    fb_runner = WorkloadRunner(fb_keys, init_frac=0.5, batch=BATCH, seed=0)
    fb = UpLIF(fb_runner.init_keys, fb_runner.init_keys + 1)
    require(int(fb.rs_model.shift) == 36, "fb index does not use shift 36")
    for _ in range(8):  # fill the fb BMAT so K2 has something to rank
        _, ins = fb_runner.next_batch(1.0)
        fb.insert(ins, ins + 1)
    errs.append(compare_kernels(torch, fb, query_mix(rng, fb_runner.init_keys),
                                "fb"))
    del fb
    errs.append(large_index(torch, keys))

    card_vs_cpu(torch)

    # a main-path batch: one mixed wave's reads and insert keys
    batch = np.concatenate(runner.next_batch(0.5))
    errs.append(compare_kernels(torch, index, batch, "wikits main-path batch"))
    timing = kernel_timing(torch, index, batch)
    meta = {
        "fused_locate": (K1_SOURCE, K1_REPLACES, max(e[0] for e in errs)),
        "bmat_rank": (K2_SOURCE, K2_REPLACES, max(e[1] for e in errs)),
    }
    kernels = []
    for name, t in timing.items():
        source, replaces, err = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_bytes": t["bytes"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
