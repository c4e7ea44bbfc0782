"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects are linked
into one shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``. The build happens at first use, into
``build/repro_torch_kernels/`` at the repository root, and is keyed by a
hash of the sources, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds. The link adds ``libcuda``
(``-lcuda``) for K6's and K6w's TMA tensor maps.

The first load is guarded by a module lock: the gateway's flusher thread
and the maintenance workers may all reach a kernel first, and two builds
in one process would write the same object and temporary files.

The flags deliberately omit ``--use_fast_math``: the fused locate, spline
lookup and GMM E-step kernels need IEEE division, full-precision
``logf``/``expf`` and no flush-to-zero to match their plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_locate.cu", "bmat_rank.cu", "gmm_estep.cu",
           "spline_lookup.cu", "tile_search.cu", "ragged_dot.cu",
           "ragged_dot_wgrad.cu", "window_insert.cu", "spline_corridor.cu")
HEADERS = ("key_delta.cuh", "hopper.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
# libcuda: K6 and K6w encode their TMA tensor maps with
# cuTensorMapEncodeTiled (nvcc finds the toolkit's link stub)
LINK_FLAGS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# launcher name -> argtypes (pointers and the stream as void*, ints as int)
SIGNATURES = {
    # table, spline_keys, spline_pos, shift, slot_keys, queries, sid,
    # j_out, start_out, n, n_table, n_knots, cap, window, rs_iters,
    # interp64, stream (a null sid means shard 0 for every query)
    "fused_locate_launch": [_P] * 9 + [_I] * 7 + [_P],
    # keys, fences, queries, sid (or null), out, n, cap, nf, fanout, stream
    "bmat_rank_launch": [_P] * 5 + [_I] * 4 + [_P],
    # x, weights, means, stds, out, n, k, stream
    "gmm_estep_launch": [_P] * 5 + [_I] * 2 + [_P],
    # table, knots, knot_pos, queries, out, n, n_table, n_knots, shift,
    # n_iters, split, stream
    "spline_lookup_launch": [_P] * 5 + [_I] * 6 + [_P],
    # slots, queries, seg_tile, seg_start, out, n_seg, n, cap, pass_lo,
    # pass_hi, stream
    "tile_search_launch": [_P] * 5 + [_I] + [_LL] * 2
                          + [_I, _I, _P],
    # lhs, rhs, group_sizes, out, m, k, n, g, bf16, tma, trans, stream
    "ragged_dot_launch": [_P] * 4 + [_I] * 7 + [_P],
    # lhs, dout, group_sizes, drhs, m, k, n, g, bf16, tma, stream
    "ragged_dot_wgrad_launch": [_P] * 4 + [_I] * 6 + [_P],
    # j, icap, sid (or null), pending, claim, n, cap, window, n_rows, stream
    "window_insert_claim_launch": [_P] * 5 + [_I, _LL, _I, _LL, _P],
    # sk, sv, so, keys, vals, j, icap, sid (or null), pending, claim, ok,
    # failed_span, n_placed, min_span (both or neither null), n, cap,
    # n_rows, window, movement_k, stream
    "window_insert_apply_launch": [_P] * 14 + [_I, _LL, _LL, _I, _I, _P],
    # keys, positions, nxt, knots, count, n, max_error, window, stream
    "spline_corridor_launch": [_P] * 5 + [_I] * 3 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str, float]:
    """Compile the sources if needed. Returns (library path, the compiler's
    output, build seconds — 0.0 when the library was already built)."""
    tag = _digest()
    lib = BUILD_DIR / f"librepro_torch_kernels-{tag}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}-{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj.name}:\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs),
         *LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib, "".join(logs) + link.stdout, time.perf_counter() - t0


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process; one
    thread builds and loads it while any others wait)."""
    with _LOAD_LOCK:
        return _load()


# how often the library was loaded (misses) and reused (hits)
library.cache_info = _load.cache_info


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, path: str | None = None) -> None:
    """Add one to ``wrapper.launches`` where the wrapper launched its
    kernel, and to ``wrapper.launches_by_path[path]`` where it has more
    than one; under the lock, so threads that launch at once lose no
    count."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if path is not None:
            wrapper.launches_by_path[path] += 1


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
