#!/usr/bin/env python3
"""Time the port's K1 (fused locate), K2 (BMAT rank), K3 (GMM E-step), K4
(tile search), K5 (spline lookup) and K6 (grouped matrix product) kernels
of two source trees in turns on one GPU.

    python3 kernel_ab.py OTHER_TREE [--out PATH]

``OTHER_TREE`` is the root of another checkout of this repository, for
example a ``git archive`` of an earlier commit unpacked under ``build/``.
This tree makes the inputs once, as ``chip_smoke.py`` makes them: the 4M-key
wikits index after the single-index main path (four mixes of 200 waves and
the delete phase), K1's and K2's main-path batch (one mixed wave's 2048
reads and 2048 insert keys) on its model, slot array (at the main path's
offset from a 128-byte line) and BMAT, K3's inputs as the forecaster gives
them for one write-heavy wave's 2048 insert keys (K = 4, after it has
observed 20 waves) and a sweep of K 1..8 at N 1..8193, K4's route batch (a
4096-query mix routed by ``ops.spline_lookup`` over the index's 10.5M-slot
array) and a rank batch with duplicated runs, K5's 4096-query mixes on
that index (radix shift 15) and on ``chip_smoke.py``'s fb index (2M keys
bulk-loaded, shift 36), and, for this tree only, K3 at K 16, 33 and 64 and
K2 at fanouts 128 and 256 on the main path's BMAT (the other tree may
refuse them). Then each timing runs in a fresh process that imports
``repro_torch`` from one tree (building that tree's kernels into its own
``build/``), in the order OTHER, THIS, THIS, OTHER, and prints one JSON
line:

  * ``k1_ms`` / ``k1_cold_ms``: K1's device time per launch, warm and with
    the L2 flushed by a read before each launch, ``k1_call_ms`` through
    the wrapper between CUDA events;
  * ``k3_ms``: K3's device time per launch on the forecaster's inputs,
    ``k3_call_ms`` through the wrapper;
  * ``k2_ms``: K2's device time per launch (profiler device events, warm:
    the main path ranks the same BMAT every wave), ``k2_call_ms`` through
    the wrapper between CUDA events, ``k2_library_ms`` for
    ``torch.searchsorted(keys, q)``;
  * ``k4_cold_ms`` / ``k4_cold_write_ms`` / ``k4_warm_ms``: K4's route
    launch with the L2 flushed before each launch by a read / by a write
    (``chip_smoke.cold_ms``) / warm, and ``k4_library_cold_ms`` /
    ``k4_library_cold_write_ms`` for ``torch.searchsorted(slots, q,
    right=True) - 1``;
  * ``tiled_rank_device_ms`` / ``tiled_rank_call_ms``: ``ops.bmat_rank`` over
    the slot array on the rank batch (every K4 launch it makes, and the
    host's part), with its K4 launches per call;
  * ``k5_ms`` / ``k5_fb_ms``: K5's device time per launch on the wikits
    and fb mixes (warm: its model is 0.2-0.4 MB), ``k5_call_ms`` /
    ``k5_fb_call_ms`` through the wrapper;
  * this tree only: ``k3_k16_ms``, ``k3_k33_ms``, ``k3_k64_ms`` and
    ``k2_fanout128_ms``, ``k2_fanout256_ms``;
  * ``floor_ms`` / ``floor_cold_ms``: one trivial launch (``add_`` on 4096
    int64), warm and after the read flush;
  * ``k6_<shape>_<dtype>_ms`` and ``..._call_ms``: K6's device time per
    launch and its time through the wrapper between CUDA events at
    ``chip_smoke.K6_SHAPES`` and the empty-groups case, in float32 and
    bfloat16, on ``chip_smoke.k6_inputs`` made on the card from seed 17 in
    each timing process (the same inputs in every run); ``k6_paths``: the
    launches by path where the tree counts them.

Every run's outputs (K1's ``(j, start)``, K3's responsibilities on the
forecaster's inputs and on the sweep, K2's ranks, K4's route entries, the
tiled ranks, K5's positions at both shifts, this tree's wide K3 and K2
cases, and K6's float32 products, one fmaf chain per output in both trees)
must equal those of the first run that has them, bit for bit; K6's
bfloat16 products only those of the same tree (the two trees' tensor-core
instructions sum in other orders). The
summary goes to stdout and to ``--out`` (by default
``build/kernel_ab/summary.json``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "kernel_ab"
WIDE_K = (16, 33, 64)     # K3 above the parent's bound of 8 (this tree)
WIDE_FANOUTS = (128, 256)  # K2 above the parent's bound of 64 (this tree)
K6_ITERS = 20


def make_inputs(path: Path) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import UpLIF
    from repro_torch.core.bmat import _make_fences
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import ops
    from repro_torch.tuning.forecast import UpdateForecaster

    keys = make_dataset("wikits", cs.N_KEYS)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=cs.BATCH, seed=0)
    index = UpLIF(runner.init_keys, runner.init_keys + 1)
    _, _, live = cs.run_main_path(torch, index, runner, cs.WAVES,
                                  cs.DELETE_WAVES)
    batch = np.concatenate(runner.next_batch(0.5))
    k1, k2 = cs.kernel_inputs(torch, index, batch)
    fc = UpdateForecaster(float(keys[0]), float(keys[-1]))
    for _ in range(20):
        fc.observe(runner.next_batch(0.5)[1])
    k3 = cs.k3_args(torch, fc, runner.next_batch(0.5)[1])
    rng = np.random.default_rng(3)
    sweep = [[torch.as_tensor(a.astype(np.float32)) for a in (
        rng.uniform(0, 1, n), rng.dirichlet(np.ones(k)),
        np.sort(rng.uniform(0, 1, k)), rng.uniform(0.01, 0.3, k))]
        for n in (1, 31, 2048, 8193) for k in range(1, 9)]
    m, st = index.rs_model, index.rs_static
    sk = index.slots.keys
    q, qq = cs.api_batches(torch, index, live, 21)
    p = ops.spline_lookup(m.table, m.spline_keys, m.spline_pos, m.shift, q,
                          st.n_search_iters)
    route = ops._route_tiles(sk, q, p)[3]
    fb_keys = WorkloadRunner(make_dataset("fb", cs.FB_KEYS), init_frac=0.5,
                             batch=cs.BATCH, seed=0).init_keys
    fb = UpLIF(fb_keys, fb_keys + 1)
    k5 = {}
    for label, idx, keys_in, seed in (("wikits", index, live, 21),
                                      ("fb", fb, fb_keys, 22)):
        fm, fst = idx.rs_model, idx.rs_static
        k5[label] = dict(
            args=[fm.table.cpu(), fm.spline_keys.cpu(), fm.spline_pos.cpu(),
                  cs.api_batches(torch, idx, keys_in, seed)[0].cpu()],
            kw=dict(shift=int(fm.shift), n_iters=fst.n_search_iters))
        print(f"inputs: K5[{label}] " + json.dumps(cs.k5_shape(
            torch, fm, k5[label]["args"][3].cuda(), fst.n_search_iters)),
            flush=True)
    del fb
    wide_k3 = [[torch.as_tensor(a.astype(np.float32)) for a in (
        k3[0].cpu().numpy(), rng.dirichlet(np.ones(k)),
        np.sort(rng.uniform(0, 1, k)), rng.uniform(0.01, 0.3, k))]
        for k in WIDE_K]
    bk = k2["args"][0]
    wide_k2 = [dict(fences=_make_fences(bk, f).cpu(), fanout=f)
               for f in WIDE_FANOUTS]
    cpu = lambda ts: [t.cpu() for t in ts]  # noqa: E731
    torch.save(dict(
        k1_args=cpu(k1["args"]), k1_kw=k1["kw"],
        k1_lead=(k1["args"][4].data_ptr() % 128) // 8,
        k3_args=cpu(k3), k3_sweep=sweep,
        k2_args=cpu(k2["args"]), k2_kw=k2["kw"], slots=sk.cpu(),
        route=cpu(route), route_q=q.cpu(), rank_q=qq.cpu(),
        fences=cs._fences(torch, sk).cpu(), k5=k5, wide_k3=wide_k3,
        wide_k2=wide_k2,
    ), path)
    print(f"inputs: K1 {json.dumps(cs.k1_shape(k1))}; K3 N "
          f"{k3[0].shape[0]}, K {k3[1].shape[0]}; BMAT cap {k2['kw']['cap']}, "
          f"nf {k2['kw']['nf']}, fanout {k2['kw']['fanout']}; "
          f"{sk.shape[0]} slots, "
          f"{route[1].shape[0]} segments, rank batch {qq.shape[0]}",
          flush=True)


def time_k6(torch, tree_tag: str) -> tuple[dict, dict]:
    """K6 at ``K6_SHAPES`` and the empty-groups case in both dtypes: the
    timings, and the outputs to compare (float32 under one name for both
    trees, bfloat16 under this tree's ``tree_tag``)."""
    import chip_smoke as cs
    from repro_torch.kernels.ragged_dot import ragged_dot

    shapes = dict(cs.K6_SHAPES, empty=(1000, 256, 192, 40))
    res, outs = {}, {}
    for name, (m, k, n, g) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            lhs, rhs, sizes = cs.k6_inputs(torch, m, k, n, g, dtype, 17,
                                           empty=name == "empty")
            fn = lambda: ragged_dot(lhs, rhs, sizes)  # noqa: E731
            key = f"k6_{name}_{dt}"
            outs[key if dtype == torch.float32 else f"{key}_{tree_tag}"] = (
                fn().cpu())
            res[f"{key}_ms"] = cs.device_ms(torch, fn, K6_ITERS)
            res[f"{key}_call_ms"] = cs.call_ms(torch, fn, K6_ITERS)
            del lhs, rhs, sizes
            torch.cuda.empty_cache()
    paths = getattr(ragged_dot, "launches_by_path", None)
    if paths is not None:
        res["k6_paths"] = dict(paths)
    return res, outs


def time_tree(tree: Path, inputs: Path, outputs: Path, wide: bool) -> None:
    import torch

    import chip_smoke as cs

    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bmat_rank import bmat_rank
    from repro_torch.kernels.gmm_estep import gmm_estep
    from repro_torch.kernels.spline_lookup import fused_locate, spline_lookup
    from repro_torch.kernels.tile_search import tile_search

    cs.require(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"imported {repro_torch.__file__}, not {tree}")
    build.library()
    k6_res, k6_outs = time_k6(torch, "this" if wide else "other")

    def cuda(v):
        if torch.is_tensor(v):
            return v.cuda()
        if isinstance(v, dict):
            return {k: cuda(t) for k, t in v.items()}
        return [cuda(t) for t in v] if isinstance(v, list) else v

    d = {k: cuda(v) for k, v in torch.load(inputs).items()}
    # K1's slot array at the main path's offset from a 128-byte line
    k1_args, k1_kw, lead = list(d["k1_args"]), d["k1_kw"], d["k1_lead"]
    buf = torch.empty(k1_args[4].shape[0] + lead, dtype=torch.int64,
                      device="cuda")
    buf[lead:] = k1_args[4]
    k1_args[4] = buf[lead:]
    k2_args, kw, sk = d["k2_args"], d["k2_kw"], d["slots"]
    bkeys, q2 = k2_args[0], k2_args[2]
    out = torch.empty(d["route_q"].shape[0], dtype=torch.int32, device="cuda")
    x = torch.zeros(cs.BATCH, dtype=torch.int64, device="cuda")
    k1 = lambda: fused_locate(*k1_args, **k1_kw)  # noqa: E731
    k3 = lambda: gmm_estep(*d["k3_args"])  # noqa: E731
    k2 = lambda: bmat_rank(*k2_args, **kw)  # noqa: E731
    k4 = lambda: tile_search(sk, *d["route"], pass_idx=0, out=out)  # noqa: E731
    lib4 = lambda: torch.searchsorted(sk, d["route_q"], right=True) - 1  # noqa: E731
    tiled = lambda: ops.bmat_rank(sk, d["fences"], d["rank_q"], 16)  # noqa: E731
    k5 = {label: (lambda a=c["args"], kw=c["kw"]: spline_lookup(*a, **kw))
          for label, c in d["k5"].items()}
    k3w = {k: (lambda a=a: gmm_estep(*a))
           for k, a in zip(WIDE_K, d["wide_k3"])} if wide else {}
    k2w = {c["fanout"]: (lambda c=c: bmat_rank(
        bkeys, c["fences"], q2, cap=kw["cap"], nf=c["fences"].shape[0],
        fanout=c["fanout"])) for c in d["wide_k2"]} if wide else {}

    ops.reset_launch_counts()
    ranks = tiled()
    torch.cuda.synchronize()
    tiled_k4 = ops.launch_counts()["tile_search"]
    out.fill_(-7)
    k4()
    j, start = k1()
    sweep = torch.cat([gmm_estep(*a).reshape(-1) for a in d["k3_sweep"]])
    torch.save(dict(k1_j=j.cpu(), k1_start=start.cpu(), k3=k3().cpu(),
                    k3_sweep=sweep.cpu(), k2=k2().cpu(), k4=out.cpu(),
                    tiled=ranks.cpu(),
                    **{f"k5_{lb}": fn().cpu() for lb, fn in k5.items()},
                    **{f"k3_k{k}": fn().cpu() for k, fn in k3w.items()},
                    **{f"k2_fanout{f}": fn().cpu() for f, fn in k2w.items()},
                    **k6_outs),
               outputs)
    res = {
        "tree": str(tree), "card": cs.card_line(),
        "k1_ms": cs.device_ms(torch, k1, 500),
        "k1_cold_ms": cs.cold_ms(torch, k1, 200),
        "k1_call_ms": cs.call_ms(torch, k1, 500),
        "k3_ms": cs.device_ms(torch, k3, 500),
        "k3_call_ms": cs.call_ms(torch, k3, 500),
        "k2_ms": cs.device_ms(torch, k2, 500),
        "k2_call_ms": cs.call_ms(torch, k2, 500),
        "k2_library_ms": cs.device_ms(
            torch, lambda: torch.searchsorted(bkeys, q2), 500),
        "k4_cold_ms": cs.cold_ms(torch, k4, 200),
        "k4_cold_write_ms": cs.cold_ms(torch, k4, 200, "write"),
        "k4_warm_ms": cs.device_ms(torch, k4, 200),
        "k4_library_cold_ms": cs.cold_ms(torch, lib4, 200),
        "k4_library_cold_write_ms": cs.cold_ms(torch, lib4, 200, "write"),
        "tiled_rank_device_ms": cs.device_ms(torch, tiled, 50),
        "tiled_rank_call_ms": cs.call_ms(torch, tiled, 50),
        "tiled_rank_k4_launches": tiled_k4,
        "k5_ms": cs.device_ms(torch, k5["wikits"], 500),
        "k5_call_ms": cs.call_ms(torch, k5["wikits"], 500),
        "k5_fb_ms": cs.device_ms(torch, k5["fb"], 500),
        "k5_fb_call_ms": cs.call_ms(torch, k5["fb"], 500),
        **{f"k3_k{k}_ms": cs.device_ms(torch, fn, 500)
           for k, fn in k3w.items()},
        **{f"k2_fanout{f}_ms": cs.device_ms(torch, fn, 500)
           for f, fn in k2w.items()},
        "floor_ms": cs.device_ms(torch, lambda: x.add_(1), 500),
        "floor_cold_ms": cs.cold_ms(torch, lambda: x.add_(1), 200),
        **k6_res,
    }
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--out", type=Path, default=WORK / "summary.json")
    ap.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--outputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--wide", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    WORK.mkdir(parents=True, exist_ok=True)
    inputs = WORK / "inputs.pt"
    if args.time is not None:
        time_tree(args.time, inputs, args.outputs, args.wide)
        return 0
    if args.other is None or not (args.other / "src" / "repro_torch").is_dir():
        ap.error("OTHER_TREE must be a checkout with src/repro_torch")
    make_inputs(inputs)
    runs, first = [], {}
    for k, tree in enumerate((args.other, ROOT, ROOT, args.other)):
        outputs = WORK / f"outputs{k}.pt"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time",
             str(tree.resolve()), "--outputs", str(outputs),
             *(["--wide"] if tree is ROOT else [])],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
        for name, out in torch.load(outputs).items():
            if not torch.equal(first.setdefault(name, out), out):
                print(f"kernel_ab: run {k} differs on {name}", file=sys.stderr)
                return 1
    metrics = [k for k, v in runs[1].items() if isinstance(v, (int, float))]
    summary = {
        "order": ["other", "this", "this", "other"],
        "other": str(args.other), "card": runs[0]["card"],
        "runs": {m: [r.get(m) for r in runs] for m in metrics},
        "median_other": {m: statistics.median([runs[0][m], runs[3][m]])
                         for m in metrics if m in runs[0]},
        "median_this": {m: statistics.median([runs[1][m], runs[2][m]])
                        for m in metrics},
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    print("kernel_ab " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
