"""Public-surface parity of the port with the JAX package.

Every module of ``src/repro`` and its namesake in ``src/repro_torch`` are
read with ``ast`` (neither package is imported). From each, the test
collects the public top-level functions, classes and constants, the
classes' public methods and constructor parameters, dataclass and
NamedTuple fields (a class body's annotated names), every parameter name
of those functions and methods, and a package ``__init__``'s exports. Each
reference item must have its counterpart in the port module of the same
name, or an entry in ``DEPARTURES`` that says why not.

An item is written ``module::Name``, ``module::Class.member`` or
``module::function(parameter)``; a departure covers the item it names and
everything under it (a function's parameters, a class's members). Each
reason names its entry under "Departures from the reference's public
surface" in ``ROADMAP.md`` §3. An entry that no longer names a reference
item, or names one the port now has, fails the second test, so the table
cannot go stale.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

# the one module the port renamed (ROADMAP §3, departure "hlo_analysis")
MODULE_MAP = {"launch/hlo_analysis.py": "launch/program_analysis.py"}

_HALVES = ("KeyHalves: TPU-only (hi:int32, lo:uint32) key split; the Hopper "
           "kernels read int64 keys (ROADMAP §3, departure \"KeyHalves\")")
_VMEM = ("TPU VMEM residency bound; the port routes ranks by "
         "kernels.ops.TILED_RANK_ABOVE to K4's tiled rank or K2 "
         "(kernels.ops.bmat_rank) and the CUDA kernels read HBM (ROADMAP §3, "
         "departure \"VMEM\")")
_CONSTRAIN = ("sharding-constraint hook of a TPU mesh; one device has none "
              "(ROADMAP §3, departure \"constrain\")")


def _pallas(counterpart):
    return (f"Pallas entry; its CUDA C++ counterpart is {counterpart} "
            "(ROADMAP §3, departure \"Pallas\")")


def _oracle(counterpart):
    return (f"pure-jnp oracle on split keys; the port's plain version is "
            f"{counterpart} (ROADMAP §3, departure \"oracles\")")


DEPARTURES = {
    # KeyHalves
    "core/state.py::KeyHalves": _HALVES,
    "core/state.py::make_halves": _HALVES,
    "core/state.py::UpLIFState.halves": _HALVES,
    "kernels/ops.py::split_key": _HALVES,
    **{f"kernels/ops.py::fused_locate({p})": _HALVES
       for p in ("slot_hi", "slot_lo", "spline_hi", "spline_lo",
                 "spline_pos32")},
    # the Pallas entries and their block constants
    "kernels/bmat_rank.py::bmat_rank_offset_pallas": _pallas(
        "kernels/bmat_rank.py::bmat_rank (csrc/bmat_rank.cu, K2)"),
    "kernels/bmat_rank.py::OFF_Q_BLK": _pallas("K2's own grid"),
    "kernels/gmm_estep.py::gmm_estep_pallas": _pallas(
        "kernels/gmm_estep.py::gmm_estep (csrc/gmm_estep.cu, K3)"),
    "kernels/gmm_estep.py::N_BLK": _pallas("K3's own grid"),
    "kernels/spline_lookup.py::fused_locate_pallas": _pallas(
        "kernels/spline_lookup.py::fused_locate (csrc/fused_locate.cu, K1)"),
    "kernels/spline_lookup.py::LOC_Q_BLK": _pallas("K1's own grid"),
    "kernels/spline_lookup.py::spline_lookup_pallas": _pallas(
        "kernels/spline_lookup.py::spline_lookup (csrc/spline_lookup.cu, K5)"),
    "kernels/spline_lookup.py::Q_BLK": _pallas("K5's own grid"),
    "kernels/tile_search.py::tile_search_pallas": _pallas(
        "kernels/tile_search.py::tile_search (csrc/tile_search.cu, K4)"),
    # the platform gate
    "kernels/ops.py::on_tpu": (
        "platform gate; the port asks kernels.ops.native_kernels(device) "
        "(ROADMAP §3, departure \"on_tpu\")"),
    "core/state.py::resolve_locate(on_tpu)": (
        "platform gate; the port's parameter is `native`, from "
        "native_kernels(device) (ROADMAP §3, departure \"on_tpu\")"),
    # VMEM budgets
    "kernels/ops.py::MAX_VMEM_KEYS": _VMEM,
    "kernels/ops.py::MAX_VMEM_SLOTS": _VMEM,
    "kernels/ops.py::rank_fusable": _VMEM,
    "kernels/ops.py::bmat_rank_fused": _VMEM,
    "kernels/ops.py::locate_fusable(n_table)": _VMEM,
    "kernels/ops.py::locate_fusable(n_shards)": _VMEM,
    # XLA's HLO text -> a dispatch-mode trace on meta
    "launch/hlo_analysis.py::HLOModule": (
        "parses XLA's HLO text; the port has no XLA and counts a meta trace "
        "in launch/program_analysis.py (ROADMAP §3, departure "
        "\"hlo_analysis\")"),
    "launch/hlo_analysis.py::analyze_hlo": (
        "its counterpart is launch/program_analysis.py::analyze_program "
        "(ROADMAP §3, departure \"hlo_analysis\")"),
    "tuning/forecast.py::ForecastConfig.use_pallas": (
        "the K3 switch is named `use_kernel` (ROADMAP §3, departure "
        "\"use_pallas\")"),
    # sharding hooks
    "models/attention.py::gqa(constrain)": _CONSTRAIN,
    "models/attention.py::mla(constrain)": _CONSTRAIN,
    "models/attention.py::cross_attention(constrain)": _CONSTRAIN,
    "models/transformer.py::forward_lm(constrain)": _CONSTRAIN,
    "models/transformer.py::decode_step(constrain)": _CONSTRAIN,
    "models/transformer.py::loss_fn(constrain)": _CONSTRAIN,
    "train/step.py::make_train_step(constrain)": _CONSTRAIN,
    "train/step.py::make_train_step(constrain_in_loop)": _CONSTRAIN,
    "train/step.py::make_train_step(param_specs)": _CONSTRAIN,
    "parallel/compression.py::compressed_psum(axis_name)": (
        "a mesh axis name; the port takes the torch.distributed `group` of "
        "that axis (ROADMAP §3, departure \"axis_name\")"),
    # the oracles
    "kernels/ref.py::bmat_rank_ref": _oracle(
        "kernels/bmat_rank.py::bmat_rank_plain"),
    "kernels/ref.py::gmm_estep_ref": _oracle(
        "kernels/ref.py::gmm_estep_plain"),
    "kernels/ref.py::spline_lookup_ref": _oracle(
        "kernels/spline_lookup.py::spline_lookup_plain"),
    "kernels/ref.py::tile_search_ref": _oracle(
        "kernels/tile_search.py::tile_search_plain"),
    **{f"kernels/ref.py::{fn}({p})": (
        "compares (hi, lo) key pairs; the port's takes two int64 keys "
        "`a`, `b` (ROADMAP §3, departure \"key pairs\")")
       for fn in ("key_leq", "key_lt")
       for p in ("hi_a", "lo_a", "hi_b", "lo_b")},
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _flat(nodes):
    """Statements of a body, looking inside ``if`` and ``try`` blocks."""
    for n in nodes:
        if isinstance(n, ast.If):
            yield from _flat(n.body)
            yield from _flat(n.orelse)
        elif isinstance(n, ast.Try):
            yield from _flat(n.body)
            for h in n.handlers:
                yield from _flat(h.body)
        else:
            yield n


def _targets(node):
    ts = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in ts if isinstance(t, ast.Name)]


def surface(path: Path) -> set:
    """The public items of one module (see the module docstring)."""
    out = set()
    is_package = path.name == "__init__.py"

    def function(name, node):
        out.add(name)
        out.update(f"{name}({p})" for p in _params(node))

    for n in _flat(ast.parse(path.read_text()).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(n.name):
                function(n.name, n)
        elif isinstance(n, ast.ClassDef) and _public(n.name):
            out.add(n.name)
            for m in _flat(n.body):
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(m.name):
                        function(f"{n.name}.{m.name}", m)
                    elif m.name == "__init__":
                        out.update(f"{n.name}({p})" for p in _params(m))
                elif isinstance(m, (ast.Assign, ast.AnnAssign)):
                    out.update(f"{n.name}.{t}" for t in _targets(m)
                               if _public(t))
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            out.update(t for t in _targets(n)
                       if _public(t) or t == "__version__")
        elif is_package and isinstance(n, ast.ImportFrom):
            out.update(a.asname or a.name for a in n.names
                       if _public(a.asname or a.name))
    return out


def _covers(key: str) -> bool:
    """Whether a departure names ``key`` or an item above it."""
    mod, item = key.split("::")
    while True:
        if f"{mod}::{item}" in DEPARTURES:
            return True
        if "(" in item:
            item = item[: item.index("(")]
        elif "." in item:
            item = item[: item.rindex(".")]
        else:
            return False


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _port_path(rel: str) -> Path:
    return PORT / MODULE_MAP.get(rel, rel)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    port = _port_path(rel)
    assert port.is_file(), f"src/repro_torch has no counterpart of {rel}"
    missing = sorted(
        f"{rel}::{item}" for item in surface(REF / rel) - surface(port)
        if not _covers(f"{rel}::{item}"))
    assert not missing, (
        f"the port's {port.relative_to(SRC)} lacks {missing}; port them or "
        "add each to DEPARTURES with its reason")


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departure_names_a_live_gap(key):
    rel, item = key.split("::")
    assert "ROADMAP §3, departure" in DEPARTURES[key]
    assert (REF / rel).is_file(), f"{key}: src/repro has no {rel}"
    assert item in surface(REF / rel), f"{key}: src/repro no longer has it"
    assert item not in surface(_port_path(rel)), (
        f"{key}: the port now has it; drop the departure")


def test_surface_sees_what_this_check_relies_on():
    """The collector finds each kind of item in a known module: a method
    and its parameter, a constructor parameter, a dataclass field, a
    NamedTuple field, a constant, a package export and the version."""
    bmat = surface(REF / "core/bmat.py")
    assert {"BMAT", "BMAT.rank", "BMAT.rank(queries)", "BMAT(tree_type)",
            "BMAT.extract(lo)", "bmat_height", "RBMAT"} <= bmat
    assert "GatewayConfig.on_complete" in surface(REF / "serve/gateway.py")
    assert "OpStats.n_lookups" in surface(REF / "core/types.py")
    assert {"fops", "BMAT", "gmm_pdf"} <= surface(REF / "core/__init__.py")
    assert {"ops", "ref"} <= surface(REF / "kernels/__init__.py")
    assert "__version__" in surface(REF / "__init__.py")
    assert "bucket_width" in surface(REF / "core/uplif.py")
