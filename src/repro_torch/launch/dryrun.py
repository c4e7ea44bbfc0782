"""Multi-pod dry run on the meta device: trace every (arch x shape x mesh)
cell's program and record its per-device memory, its FLOPs and a traffic
proxy for the roofline (port of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1-5-110b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
  ... [--strategy tp_fsdp|fsdp_only|dp_fsdp|auto] [--moe-dispatch dense|ragged]
      [--cache-dtype float8_e4m3fn] [--out experiments/dryrun_torch] [--tag baseline]

Each cell writes <out>/<tag>/<arch>__<shape>__<mesh>.json (meshes
``pod16x16`` and ``pod2x16x16``).

The program of a cell is the reference's: ``train_step`` with its
microbatches and block remat, ``forward_lm`` for prefill, ``decode_step``
against the 32k cache (its length set to seq - 1, so the step reads the
whole cache, as the reference's fixed-shape step does). It runs once, on
meta tensors of the global shapes (``launch/program_analysis.py``): no
device, no subprocess, no environment flag. A train step's microbatches
are one program, traced once and counted ``nm`` times; a cell whose
program the other mesh already traced (the same microbatches) reuses that
trace (``trace_reused``). No XLA compile exists to read,
so a record is filled as follows:
  * counted exactly, per device, from the partition specs: the argument
    bytes of the leaves the program reads (``jax.jit`` prunes the rest),
    the output and the alias (donated) bytes (an output the reference leaves
    unannotated takes the activation rule of its kind: logits by
    ``act_spec("logits")``, scalars replicated; a cache's host length is
    the reference's int32 scalar);
  * counted over the global program, then divided by the mesh's device
    count (``flops_split: "ideal"``): the matmul-class FLOPs and the
    traffic proxy, each kept whole beside (``*_global``);
  * no counterpart on one card: the collective bytes, the temp bytes, the
    generated code, the cost analysis and the compile time are ``null``,
    each listed under ``unmeasured`` with its reason, never 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.program_analysis import (
    COLLECTIVES,
    Counter,
    repeat,
    run_counted,
)
from repro_torch.launch.specs import SHAPES, cell_supported, input_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import abstract_params, flatten_tree
from repro_torch.models.transformer import (
    abstract_cache,
    decode_step,
    forward_lm,
)
from repro_torch.parallel.partition import NamedSharding, P, ShardingStrategy
from repro_torch.train.optimizer import AdamWConfig, OptState, abstract_opt_state
from repro_torch.train.step import grads_of, make_train_step, pick_microbatches

UNMEASURED = {
    "memory.temp_size_in_bytes":
        "no XLA buffer assignment: the port runs eagerly, and a meta run "
        "allocates nothing to take a peak from",
    "memory.generated_code_size_in_bytes": "no compiled executable",
    "collective_bytes_per_device":
        "one card exchanges nothing: a sharded program's collectives come "
        "from XLA's SPMD partitioner, which the port has no counterpart of",
    "collective_bytes_total": "as collective_bytes_per_device",
    "flops_cost_analysis": "no XLA cost analysis (dot FLOPs are counted)",
    "bytes_accessed_per_device":
        "no XLA cost analysis: the fused traffic lies between the argument "
        "and output bytes (each read or written once) and "
        "traffic_bytes_proxy (every eager op's output, unfused), and the "
        "roofline's bound is 'undetermined' where t_compute falls between",
    "compile_s": "nothing is compiled; trace_s is the meta run's time",
}

# a cache's host length stands for the reference's int32 scalar where the
# reference has one (its KV and MLA caches; its RWKV cache counts nothing)
_HOST_INT_BYTES = 4
_HOST_INT_FIELDS = ("kv", "mla")


class Cell(NamedTuple):
    """A cell's program: ``fn(*args)``, to be counted by ``counter``, with a
    sharding tree per argument, ``out_shardings(outputs)`` giving the
    outputs' tree, and the donated arguments."""

    fn: Callable
    counter: Counter
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Callable[[Any], Any]
    donate_argnums: Tuple[int, ...]
    strategy: str
    nm: Optional[int]


def _n_devices(mesh) -> int:
    return math.prod(mesh.shape.values())


def choose_strategy(cfg: ModelConfig, shape: str, mesh) -> str:
    """'auto' strategy (the reference's hillclimb winners):
    - small dense models (<10B) training with batch divisible by the full
      device count: pure DP/FSDP (no TP all-reduces);
    - everything else: tp_fsdp."""
    info = SHAPES[shape]
    if (
        info["kind"] == "train"
        and cfg.n_params() < 10e9
        and info["batch"] % _n_devices(mesh) == 0
    ):
        return "dp_fsdp"
    return "tp_fsdp"


def _replicated(mesh):
    return NamedSharding(mesh, P())


def _full_cache(cache, length: int):
    """The cache with ``length`` tokens written (its host counts)."""
    return cache._replace(**{
        f: {**getattr(cache, f), "len": length}
        for f in ("kv", "mla", "rwkv") if getattr(cache, f)})


def build_cell(cfg: ModelConfig, shape: str, mesh, strategy: str,
               cache_dtype: str | None = None) -> Cell:
    """The cell's program over meta arguments, and its shardings."""
    info = SHAPES[shape]
    if strategy == "auto":
        strategy = choose_strategy(cfg, shape, mesh)
    strat = ShardingStrategy(
        cfg, mesh, strategy=strategy, batch_size=info["batch"]
    )
    pspecs = strat.param_shardings()
    aparams = abstract_params(cfg)
    batch = input_specs(cfg, shape)
    logits = strat.act_spec("logits", 3)
    logits_sh = NamedSharding(mesh, logits if logits is not None else P())
    counter = Counter()

    if info["kind"] == "train":
        aopt = abstract_opt_state(aparams)
        opt_shardings = OptState(m=pspecs, v=pspecs, step=_replicated(mesh))
        bspecs = strat.batch_specs(batch)
        n_data = math.prod(
            mesh.shape[a] for a in ("pod", "data") if a in mesh.axis_names)
        nm = pick_microbatches(info["batch"], info["seq"], n_data)
        if strategy == "dp_fsdp":
            nm = 1  # microbatches < device count pad wastefully
        # the microbatches are one program: traced once, counted nm times
        train_step = make_train_step(cfg, AdamWConfig(), nm,
                                     grads_fn=repeat(grads_of, counter))

        def outs(out):
            _, _, _, metrics = out
            return (pspecs, opt_shardings, _replicated(mesh),
                    {k: _replicated(mesh) for k in metrics})

        return Cell(train_step, counter, (aparams, aopt, batch),
                    (pspecs, opt_shardings, bspecs), outs, (0, 1),
                    strategy, nm)

    if info["kind"] == "prefill":
        bspecs = strat.batch_specs(batch)

        def prefill(params, batch):
            with torch.no_grad():
                return forward_lm(params, cfg, batch, remat=False)

        return Cell(prefill, counter, (aparams, batch), (pspecs, bspecs),
                    lambda out: logits_sh, (), strategy, None)

    # decode
    cache = batch["cache"]
    if cache_dtype:
        cache = abstract_cache(cfg, info["batch"], info["seq"], cache_dtype)
    cache = _full_cache(cache, info["seq"] - 1)
    bspecs = strat.batch_specs(batch["batch"])
    cspecs = strat.cache_specs(cache, info["batch"])

    def serve_step(params, b, cache):
        with torch.no_grad():
            return decode_step(params, cfg, b["tokens"], cache)

    return Cell(serve_step, counter, (aparams, batch["batch"], cache),
                (pspecs, bspecs, cspecs), lambda out: (logits_sh, cspecs),
                (2,), strategy, None)


def _leaf_bytes(leaf, sharding) -> int:
    if not isinstance(leaf, torch.Tensor):
        return _HOST_INT_BYTES
    return math.prod(sharding.shard_shape(leaf.shape)) * leaf.element_size()


def _pairs(tree, shardings):
    """(leaf, sharding) pairs of a tree and its sharding tree; a host
    integer only where the reference holds an int32 scalar."""
    leaves, shards = flatten_tree(tree), flatten_tree(shardings)
    if [p for p, _ in leaves] != [p for p, _ in shards]:
        raise ValueError("a tree and its shardings differ in structure")
    return [(leaf, sh) for (path, leaf), (_, sh) in zip(leaves, shards)
            if isinstance(leaf, torch.Tensor)
            or (len(path) > 1 and path[-2] in _HOST_INT_FIELDS)]


def _key(leaf, sharding):
    if not isinstance(leaf, torch.Tensor):
        return ("host int",)
    return (tuple(leaf.shape), leaf.dtype, tuple(sharding.spec))


def memory_per_device(cell: Cell, trace) -> dict:
    """Argument, output and alias bytes per device of a traced cell: every
    leaf's shard once, over the argument leaves the program reads (as
    ``jax.jit`` prunes the unused ones: a decode step reads neither the
    encoder's weights nor the cross-attention's K and V projections); a
    donated argument leaf aliases an output leaf of its shape, dtype and
    spec (each output taken once)."""
    args = [[(leaf, sh) for leaf, sh in _pairs(a, s)
             if not isinstance(leaf, torch.Tensor) or trace.reads(leaf)]
            for a, s in zip(cell.args, cell.in_shardings)]
    outputs = trace.outputs
    outs = _pairs(outputs, cell.out_shardings(outputs))
    free = {}
    for leaf, sh in outs:
        free[_key(leaf, sh)] = free.get(_key(leaf, sh), 0) + 1
    alias = 0
    for i in cell.donate_argnums:
        for leaf, sh in args[i]:
            k = _key(leaf, sh)
            if free.get(k, 0):
                free[k] -= 1
                alias += _leaf_bytes(leaf, sh)
    return {
        "argument_size_in_bytes": sum(_leaf_bytes(leaf, sh)
                                      for pairs in args for leaf, sh in pairs),
        "output_size_in_bytes": sum(_leaf_bytes(leaf, sh)
                                    for leaf, sh in outs),
        "temp_size_in_bytes": None,
        "alias_size_in_bytes": alias,
        "generated_code_size_in_bytes": None,
    }


def run_cell(arch: str, shape: str, multi_pod: bool, strategy: str,
             moe_dispatch: str, out_dir: str, tag: str,
             cache_dtype: str | None = None, traces: dict | None = None):
    """Trace one cell and write its record (see the module docstring).
    ``traces``, a dict that the caller keeps across cells, lets a cell
    reuse the trace of the same program on another mesh."""
    cfg = get_config(arch)
    if tag == "optimized" and cfg.n_heads % 16 != 0 and cfg.head_dim * cfg.n_heads >= 4096:
        # zero-padded Q heads unlock TP head sharding
        pad = ((cfg.n_heads + 15) // 16) * 16
        cfg = dataclasses.replace(cfg, pad_heads_to=pad)
    if moe_dispatch != "dense" and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch)
        )
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    path = os.path.join(out_dir, tag, f"{arch}__{shape}__{mesh_name}.json")
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "tag": tag,
        "strategy": strategy, "moe_dispatch": moe_dispatch,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
    }
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _dump(rec, path)
        print(f"[skip] {arch} {shape} {mesh_name}: {why}", flush=True)
        return rec

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = _n_devices(mesh)
        cell = build_cell(cfg, shape, mesh, strategy, cache_dtype)
        # both meshes run one global program where the microbatches agree
        traces = {} if traces is None else traces
        key = (repr(cfg), shape, cache_dtype, cell.nm)
        reused = key in traces
        if not reused:
            trace = run_counted(cell.fn, *cell.args, counter=cell.counter)
            traces[key] = (cell.args, trace, time.time() - t0)
        args, trace, t_trace = traces[key]
        cell = cell._replace(args=args)
        stats = trace.stats
        rec.update(
            status="ok",
            strategy_used=cell.strategy,
            microbatches=cell.nm,
            trace_s=round(t_trace, 2),
            trace_reused=reused,
            compile_s=None,
            memory=memory_per_device(cell, trace),
            flops_per_device=stats["dot_flops"] / n_dev,
            flops_global=stats["dot_flops"],
            flops_split="ideal",
            flops_cost_analysis=None,
            bytes_accessed_per_device=None,
            traffic_bytes_proxy=stats["traffic_bytes_proxy"] / n_dev,
            traffic_bytes_proxy_global=stats["traffic_bytes_proxy"],
            collective_bytes_per_device={k: None for k in COLLECTIVES},
            collective_bytes_total=None,
            unmeasured=UNMEASURED,
        )
        print(
            f"[ok]   {arch} {shape} {mesh_name}: trace {t_trace:.1f}s"
            f"{' (reused)' if reused else ''} "
            f"flops/dev {rec['flops_per_device']:.3e} args "
            f"{rec['memory']['argument_size_in_bytes']/2**30:.2f} GiB "
            f"temp —",
            flush=True,
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} {shape} {mesh_name}: {rec['error'][:200]}", flush=True)
    _dump(rec, path)
    return rec


def _dump(rec, path):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--moe-dispatch", default="dense")
    ap.add_argument("--cache-dtype", default=None,
                    help="decode-cache storage dtype (e.g. float8_e4m3fn; "
                         "changes numerics, opt-in)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    results, traces = [], {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(
                    run_cell(arch, shape, mp, args.strategy,
                             args.moe_dispatch, args.out, args.tag,
                             args.cache_dtype, traces)
                )
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped-by-design, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
