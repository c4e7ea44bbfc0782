"""The system under test, built from a configuration file, and the control.

``build(cfg, keys, vals, device, rec)`` returns the port's index as the
configuration deploys it: one ``UpLIF``. The harness calls it only
through the methods below, and opens its spans around each call into a
layer.

``Control`` is the plain reference put in the program's place, computed
in a lower precision than the configuration states: its keys are held
and compared as float32. The benchmark's own runs never build it;
``perfbench/control.py`` and the tests do.
"""
from __future__ import annotations

import numpy as np


def index_config(cfg: dict):
    """The port's ``UpLIFConfig`` for the configuration's index knobs."""
    from repro_torch.core.uplif import UpLIFConfig

    return UpLIFConfig(**cfg["index"])


class IndexSystem:
    """One ``UpLIF``: the paper's index."""

    def __init__(self, cfg, keys, vals, device, rec):
        from repro_torch.core.uplif import UpLIF

        self.rec = rec
        self.index = UpLIF(keys, vals, index_config(cfg), device=device)

    def wave(self, reads, ins, ins_vals):
        rec = self.rec
        found = vals = None
        if len(reads):
            with rec.span("index.lookup", sync=True):
                found, vals = self.index.lookup(reads)
        if len(ins):
            with rec.span("index.insert", sync=True):
                self.index.insert(ins, ins_vals)
        return found, vals

    def contents(self):
        return self.index.extract_live()

    def close(self):
        self.index = None


def build(cfg: dict, keys, vals, device, rec):
    kind = cfg["system"]
    if kind == "uplif":
        return IndexSystem(cfg, keys, vals, device, rec)
    raise ValueError(f"unknown system {kind!r}")


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, keys in float32
# ---------------------------------------------------------------------------


class Control:
    """A sorted map whose keys are held and compared as float32: two keys
    that round to one float32 are one key. It serves the wave loop with
    the program's signatures."""

    def __init__(self, cfg, keys, vals, device=None, rec=None):
        k32 = np.asarray(keys).astype(np.float32)
        order = np.argsort(k32, kind="stable")
        k32, v = k32[order], np.asarray(vals, dtype=np.int64)[order]
        last = np.ones(len(k32), dtype=bool)
        last[:-1] = k32[1:] != k32[:-1]
        self._k, self._v = k32[last], v[last]
        self._delta = {}          # float32 key -> value

    def _get(self, q):
        q32 = np.asarray(q).astype(np.float32)
        i = np.minimum(np.searchsorted(self._k, q32), max(len(self._k) - 1, 0))
        found = (self._k[i] == q32) if len(self._k) else np.zeros(len(q), bool)
        vals = np.where(found, self._v[i] if len(self._k) else 0, 0)
        for j, x in enumerate(q32.tolist()):
            if x in self._delta:
                found[j] = True
                vals[j] = self._delta[x]
        return found, vals

    def lookup(self, q):
        return self._get(q)

    def insert(self, keys, vals):
        for k, v in zip(np.asarray(keys).astype(np.float32).tolist(),
                        np.asarray(vals).tolist()):
            self._delta[k] = int(v)
        return 0

    def wave(self, reads, ins, ins_vals):
        found = vals = None
        if len(reads):
            found, vals = self.lookup(reads)
        if len(ins):
            self.insert(ins, ins_vals)
        return found, vals

    def contents(self):
        keep = np.ones(len(self._k), dtype=bool)
        dk = np.fromiter(self._delta.keys(), dtype=np.float32,
                         count=len(self._delta))
        keep &= ~np.isin(self._k, dk)
        live = list(self._delta.items())
        keys = np.concatenate([self._k[keep].astype(np.float64),
                               np.asarray([k for k, _ in live], np.float64)])
        vals = np.concatenate([self._v[keep],
                               np.asarray([v for _, v in live], np.int64)])
        order = np.argsort(keys, kind="stable")
        return keys[order].astype(np.int64), vals[order]

    def close(self):
        pass
