"""Faults planted in the program's timed path, for the check's own tests.

Each fault replaces a method of the port's index class for the length
of a ``with plant(name):`` block; the run above it is the benchmark's
own. A sound comparison with the reference must fail each fault that a
cell can have:

  unchanged   an insert returns with the index's state unchanged
  half        half of each batch left out (the second half of the
              inserts is dropped; the second half of the lookups is
              answered "not found")
  altered     one answer altered where it is produced (a found value)

The cells run on one chip, so the fault of an exchange between chips left
out does not arise.
"""
from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("unchanged", "half", "altered")


def _classes():
    from repro_torch.core.uplif import UpLIF

    return (UpLIF,)


def _patches(name: str, cls):
    orig_insert, orig_lookup = cls.insert, cls.lookup

    def insert_unchanged(self, keys, vals=None, **kw):
        return 0

    def insert_half(self, keys, vals=None, **kw):
        keys = np.asarray(keys)
        h = (len(keys) + 1) // 2
        vals = keys.copy() if vals is None else np.asarray(vals)
        return orig_insert(self, keys[:h], vals[:h], **kw)

    def lookup_half(self, queries, **kw):
        f, v = orig_lookup(self, queries, **kw)
        f, v = f.copy(), v.copy()
        h = (len(f) + 1) // 2
        f[h:], v[h:] = False, 0
        return f, v

    def lookup_altered(self, queries, **kw):
        f, v = orig_lookup(self, queries, **kw)
        v = v.copy()
        hit = np.nonzero(f)[0]
        if len(hit):
            v[hit[0]] += 1
        return f, v

    return {
        "unchanged": {"insert": insert_unchanged},
        "half": {"insert": insert_half, "lookup": lookup_half},
        "altered": {"lookup": lookup_altered},
    }[name]


@contextlib.contextmanager
def plant(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    saved = []
    try:
        for cls in _classes():
            for attr, fn in _patches(name, cls).items():
                saved.append((cls, attr, cls.__dict__[attr]))
                setattr(cls, attr, fn)
        yield
    finally:
        for cls, attr, fn in reversed(saved):
            setattr(cls, attr, fn)
