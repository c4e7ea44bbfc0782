"""The bytes of each kernel launch, read after the window.

For a few waves past the window's close, a traced run observes the calls
into the kernels named in ``perfbench/kernels/``: each module names the
program's entry it observes (``ENTRY``, a module and an attribute) and
counts one launch's bytes from that launch's own inputs (``bytes_of``),
before the call goes on to the kernel. The waves are the cell's own, so
the launches have the window's mix of widths; their answers are checked
like the window's.
"""
from __future__ import annotations

import contextlib
import importlib
import threading


@contextlib.contextmanager
def observe(kmods: dict, out: dict):
    """Within the block, ``out[name]`` gathers the bytes of every launch
    of each kernel in ``kmods`` (name -> module)."""
    lock = threading.Lock()
    saved = []
    for name, mod in kmods.items():
        target = importlib.import_module(mod.ENTRY[0])
        orig = getattr(target, mod.ENTRY[1])

        def wrapped(*args, _orig=orig, _mod=mod, _name=name, **kwargs):
            n_bytes = _mod.bytes_of(args, kwargs)
            with lock:
                out.setdefault(_name, []).append(n_bytes)
            return _orig(*args, **kwargs)

        setattr(target, mod.ENTRY[1], wrapped)
        saved.append((target, mod.ENTRY[1], orig))
    try:
        yield out
    finally:
        for target, attr, orig in saved:
            setattr(target, attr, orig)
