"""Atomic, framework-neutral checkpointing (port of
``repro/train/checkpoint.py``), in the reference's format.

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per leaf and
``manifest.json`` (step, each leaf's name, shape and dtype, user
metadata). A leaf's file is named by its path as the reference's
``_flatten`` names it: the path's keys joined by ``__``, dict keys in
sorted order, a tuple's positions as numbers and a NamedTuple's fields by
name (``0__embed``, ``0__layers__blk0_attn__wq``, ``1__m__embed``,
``1__step`` for a (params, opt_state) pair). Writes go to a temp dir that
is renamed into place, so a crash mid-save never leaves a partial
checkpoint for ``latest_step`` to find; the oldest checkpoints beyond
``keep_last`` are removed.

A bfloat16 leaf is written as the JAX package writes one: its 16-bit
patterns under the npy descr ``'<V2'`` and ``"bfloat16"`` in the
manifest; reading goes through the manifest's dtype. A checkpoint written
by either package restores in the other (float32 and int32 leaves bit for
bit; the JAX package cannot restore a bfloat16 leaf at all, ROADMAP §3).
Leaves are stored whole; ``restore`` places them on one device, by the
given shardings where the caller passes them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.init import flatten_tree, rebuild_tree


def _flatten(tree):
    """(file name, leaf) pairs, named as the reference names them."""
    return [("__".join(str(p) for p in path), leaf)
            for path, leaf in flatten_tree(tree)]


def _host(leaf: torch.Tensor) -> tuple:
    """(numpy array, dtype name) of a leaf, copied off its device: a
    bfloat16 leaf as its uint16 patterns."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def _snapshot(tree):
    """(name, array, dtype name) of every leaf, copied to the host now (a
    CPU leaf is copied too, so later writes to it do not reach the
    snapshot)."""
    out = []
    for name, leaf in _flatten(tree):
        a, dt = _host(leaf)
        out.append((name, np.array(a, copy=True) if leaf.device.type == "cpu"
                    else a, dt))
    return out


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # what np.save writes for the JAX package's (ml_dtypes) bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write(ckpt_dir: str, step: int, snap, metadata, keep_last: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    manifest = {"step": step, "leaves": [], "metadata": metadata or {}}
    try:
        for name, arr, dtype in snap:
            _write_leaf(os.path.join(tmp, name + ".npy"), arr, dtype)
            manifest["leaves"].append(
                {"name": name, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree: Any,
         metadata: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Atomic checkpoint write. Returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    return _write(ckpt_dir, step, _snapshot(tree), metadata, keep_last)


def save_async(ckpt_dir: str, step: int, tree: Any,
               **kw) -> threading.Thread:
    """Non-blocking save: the leaves are copied to the host before it
    returns (the snapshot), the files are written by the returned thread.
    Keywords as ``save``'s (``metadata``, ``keep_last``)."""
    snap = _snapshot(tree)
    os.makedirs(ckpt_dir, exist_ok=True)
    t = threading.Thread(
        target=_write, daemon=True,
        args=(ckpt_dir, step, snap, kw.get("metadata", {}),
              kw.get("keep_last", 3)))
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.asarray(np.load(path), order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            shardings: Optional[Any] = None, device=None):
    """Restore into the structure of ``tree_like`` (tensors, or meta
    tensors such as ``abstract_params``' and ``abstract_opt_state``'s),
    each leaf in its stored dtype on ``device`` (``cuda`` unless the caller
    passes another). ``shardings`` (the same structure, the port's
    ``parallel.partition.NamedSharding``s) is the reference's elastic
    re-shard on load: each leaf is placed by its sharding, which on a mesh
    of one device puts it on ``device``; a sharding over more devices
    raises ``ValueError`` (the port runs on one card). Returns (tree,
    manifest)."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    keyed = _flatten(tree_like)
    missing = [n for n, _ in keyed if n not in dtypes]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
    placers = [None] * len(keyed)
    if shardings is not None:
        placers = [sh for _, sh in _flatten(shardings)]
        if len(placers) != len(keyed):
            raise ValueError(f"{len(placers)} shardings for {len(keyed)} "
                             f"leaves")
    out = []
    for (name, like), sh in zip(keyed, placers):
        t = _read_leaf(os.path.join(d, name + ".npy"), dtypes[name])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != expected "
                             f"{tuple(like.shape)}")
        out.append(t.to(device) if sh is None else sh.place(t, device))
    return rebuild_tree(tree_like, out), manifest


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
