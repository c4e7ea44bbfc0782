"""Counts over a program run on meta tensors (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference compiles each cell with XLA and reparses the optimized HLO.
No compiled program exists here: ``analyze_program(fn, *args)`` runs ``fn``
on the ``meta`` device (shapes and dtypes, no memory, no arithmetic) and
counts every aten op it dispatches, with the reference's keys:

  * ``dot_flops``: matmul-class FLOPs by ``torch.utils.flop_counter``'s
    formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, the
    attention ops, and K6 and K6w's shape-only ops,
    ``kernels/ragged_dot.py``); the backward's products and the recompute
    under ``torch.utils.checkpoint`` are counted as they run, as the
    reference's HLO counts remat;
  * ``collective_bytes`` (the five kinds) and ``collective_bytes_total``:
    0, because a program of one device exchanges nothing; a
    ``torch.distributed`` collective inside ``fn`` raises, never counted
    as 0;
  * ``traffic_bytes_proxy``: twice the bytes of every op's output, views
    and aliases left out (each output written once and read about once),
    the reference's proxy for HBM traffic.

Everything is over the whole program ``fn`` runs: the dry run divides it by
a mesh's device count (an ideal split), where the reference's HLO is the
per-device program. A part that a program repeats on the same shapes (a
train step's microbatches) may run once and be counted each time it
recurs (``repeat``), as the reference's analyzer multiplies a loop body by
its trip count.
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# the namespaces of torch.distributed's collectives
_DISTRIBUTED = ("c10d", "_c10d_functional", "c10d_functional")

# ops that return an existing tensor or a new view of one
_ALIASES = ("detach", "alias", "lift_fresh", "_unsafe_view")

class CollectiveInProgram(RuntimeError):
    """A program of one device called a collective."""


def _storage(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (shared by its views; meta
    tensors have storages, all at address 0)."""
    return t.untyped_storage()._cdata


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


class Counter(TorchDispatchMode):
    """Counts the aten ops dispatched inside it: matmul-class FLOPs by
    ``torch.utils.flop_counter``'s formulas (an op without one is first
    decomposed, as ``FlopCounterMode`` does), the bytes of every output
    that is not a view or an alias, and the storages that an op other than
    a view reads; a collective raises ``CollectiveInProgram``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.out_bytes = 0
        self.read = set()

    def totals(self) -> Tuple[int, int]:
        return self.flops, self.out_bytes

    def add(self, flops: int, out_bytes: int) -> None:
        """Count a repeat of work already traced (see ``repeat``)."""
        self.flops += flops
        self.out_bytes += out_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _DISTRIBUTED:
            raise CollectiveInProgram(
                f"{func} in a program of one device: the port runs on one "
                f"card and counts no collective traffic")
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or packet.__name__ in _ALIASES):
            for t in _tensors((args, kwargs)):
                self.read.add(_storage(t))
            for t in _tensors(out):
                self.out_bytes += t.numel() * t.element_size()
        return out


class repeat:
    """``fn`` for a program that calls it several times on arguments of the
    same shapes (a train step's microbatches), counted by ``counter``: the
    first call runs; each later one adds the first one's counts to
    ``counter`` again and returns its outputs, without running. Exact for
    calls that are the same ops on the same shapes, which on meta tensors
    carry no values."""

    def __init__(self, fn, counter: Counter):
        self.fn = fn
        self.counter = counter
        self.first = None
        self.delta = None

    def __call__(self, *args, **kwargs):
        if self.first is None:
            before = self.counter.totals()
            self.first = self.fn(*args, **kwargs)
            after = self.counter.totals()
            self.delta = (after[0] - before[0], after[1] - before[1])
        else:
            self.counter.add(*self.delta)
        return self.first


class Trace(NamedTuple):
    """A counted run: its outputs, its counts (``analyze_program``'s keys)
    and the storages its ops read."""

    outputs: Any
    stats: Dict[str, object]
    read_storages: FrozenSet[int]

    def reads(self, t: torch.Tensor) -> bool:
        """Whether an op other than a view read ``t``'s storage (an input
        the program never reads is one XLA's jit would prune)."""
        return _storage(t) in self.read_storages


def run_counted(fn, *args, counter: Counter | None = None,
                **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` inside ``counter`` (a new ``Counter`` by
    default; see the module docstring)."""
    c = Counter() if counter is None else counter
    with c:
        out = fn(*args, **kwargs)
    return Trace(out, {
        "dot_flops": float(c.flops),
        "collective_bytes": {k: 0.0 for k in COLLECTIVES},
        "collective_bytes_total": 0.0,
        "traffic_bytes_proxy": 2.0 * c.out_bytes,
    }, frozenset(c.read))


def analyze_program(fn, *args, **kwargs) -> Dict[str, object]:
    """The counts of ``fn(*args, **kwargs)`` (see the module docstring);
    run it on meta tensors to count a program of any size without memory."""
    return run_counted(fn, *args, **kwargs).stats
