"""The system under test, built from a configuration file, and the control.

``build(cfg, keys, vals, device, rec)`` returns the system that the
configuration names, as it deploys it: the ``build`` of
``perfbench/systems/<system>.py`` (``perfharness/spec.py`` gives the
contract).

``Control`` is the plain reference put in the program's place, computed
in a lower precision than the configuration states: its keys are held
and compared as float32. The benchmark's own runs never build it;
``perfbench/control.py`` and the tests do.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from perfharness import spec


def build(cfg: dict, keys, vals, device, rec,
          bench_dir: Path = spec.BENCH_DIR):
    """The ``build`` of ``systems/<cfg["system"]>.py`` under ``bench_dir``."""
    return spec.system(cfg["system"], bench_dir).build(cfg, keys, vals,
                                                       device, rec)


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
