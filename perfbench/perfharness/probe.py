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


class _Observed:
    """An entry that counts each call's bytes into ``out[name]``, then
    calls the entry. Its attributes are the entry's: a kernel's wrapper
    counts its own launches on itself (``fused_locate.launches``), through
    its module, which holds this object while the probe runs."""

    def __init__(self, entry, mod, name, out, lock):
        object.__setattr__(self, "_probe", (entry, mod, name, out, lock))

    def __call__(self, *args, **kwargs):
        entry, mod, name, out, lock = self._probe
        n_bytes = mod.bytes_of(args, kwargs)
        with lock:
            out.setdefault(name, []).append(n_bytes)
        return entry(*args, **kwargs)

    def __getattr__(self, attr):
        return getattr(self._probe[0], attr)

    def __setattr__(self, attr, value):
        setattr(self._probe[0], attr, value)


@contextlib.contextmanager
def observe(kmods: dict, out: dict):
    """Within the block, ``out[name]`` gathers the bytes of every launch
    of each kernel in ``kmods`` (name -> module)."""
    lock = threading.Lock()
    saved = []
    for name, mod in kmods.items():
        target = importlib.import_module(mod.ENTRY[0])
        orig = getattr(target, mod.ENTRY[1])
        setattr(target, mod.ENTRY[1], _Observed(orig, mod, name, out, lock))
        saved.append((target, mod.ENTRY[1], orig))
    try:
        yield out
    finally:
        for target, attr, orig in saved:
            setattr(target, attr, orig)
