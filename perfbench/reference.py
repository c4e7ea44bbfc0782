"""The plain reference of the benchmark: a sorted key-value map in NumPy.

It has the semantics the index promises (exact answers; an upsert replaces
the value; a delete removes the key; every acknowledged write is seen by
every later operation) and nothing of the index's design. It imports no
module of the program and takes nothing the program made: the harness
hands it the keys, values and operations it handed to the program, each
operation with a sequence number that orders it.

Operations are logged, not applied one by one: a write at sequence ``s``
is visible to a read at sequence ``t`` exactly when ``s < t``. The answers
are worked out after the run in a few vectorised passes, so checking tens
of millions of operations takes seconds.
"""
from __future__ import annotations

import numpy as np

INSERT = 1
DELETE = 2


class Reference:
    """A sorted map: the bulk-loaded pairs, then the logged writes."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray):
        keys = np.asarray(keys, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        # the last of equal keys wins, as an upsert of the same batch would
        last = np.ones(len(keys), dtype=bool)
        last[:-1] = keys[1:] != keys[:-1]
        self.keys0, self.vals0 = keys[last], vals[last]
        self._wk, self._wv, self._wkind, self._wseq = [], [], [], []
        self._sorted = None

    # -- logging ---------------------------------------------------------------
    def insert(self, keys, vals, seq):
        """Upserts at sequence ``seq`` (one number, or one per key)."""
        self._log(keys, vals, INSERT, seq)

    def delete(self, keys, seq):
        """Deletes at sequence ``seq``."""
        self._log(keys, np.zeros(len(keys), dtype=np.int64), DELETE, seq)

    def _log(self, keys, vals, kind, seq):
        keys = np.asarray(keys, dtype=np.int64)
        if len(keys) == 0:
            return
        self._wk.append(keys)
        self._wv.append(np.asarray(vals, dtype=np.int64))
        self._wkind.append(np.full(len(keys), kind, dtype=np.int8))
        self._wseq.append(np.broadcast_to(
            np.asarray(seq, dtype=np.int64), keys.shape).copy())
        self._sorted = None

    @property
    def n_writes(self) -> int:
        return sum(len(k) for k in self._wk)

    # -- the writes, sorted by (key, sequence) ---------------------------------
    def _writes(self):
        if self._sorted is None:
            if self._wk:
                wk = np.concatenate(self._wk)
                wv = np.concatenate(self._wv)
                wkind = np.concatenate(self._wkind)
                wseq = np.concatenate(self._wseq)
            else:
                wk = wv = wseq = np.zeros(0, dtype=np.int64)
                wkind = np.zeros(0, dtype=np.int8)
            # a stable sort by sequence, then by key: equal (key, sequence)
            # pairs keep their logged order, so the later one wins
            order = np.lexsort((np.arange(len(wk)), wseq, wk))
            self._sorted = (wk[order], wv[order], wkind[order], wseq[order])
        return self._sorted

    def _base(self, q):
        """(found, value) in the bulk-loaded map."""
        i = np.searchsorted(self.keys0, q)
        ic = np.minimum(i, max(len(self.keys0) - 1, 0))
        if len(self.keys0) == 0:
            return np.zeros(len(q), dtype=bool), np.zeros(len(q), np.int64)
        found = self.keys0[ic] == q
        return found, np.where(found, self.vals0[ic], 0)

    def _last_write_before(self, q, seq):
        """Index into the sorted writes of the last write of each key in
        ``q`` with a sequence below ``seq``, or -1."""
        wk, _, _, wseq = self._writes()
        n = len(wk)
        if n == 0:
            return np.full(len(q), -1, dtype=np.int64)
        # the writes of key k are wk[lo:hi]; the last one before seq is the
        # one before the first with a sequence >= seq
        lo = np.searchsorted(wk, q, side="left")
        hi = np.searchsorted(wk, q, side="right")
        out = np.full(len(q), -1, dtype=np.int64)
        has = hi > lo
        if not has.any():
            return out
        idx = np.nonzero(has)[0]
        # bisect within each key's run, all queries at once
        a, b = lo[idx].copy(), hi[idx].copy()
        s = seq[idx]
        while True:
            live = a < b
            if not live.any():
                break
            mid = (a + b) >> 1
            go = live & (wseq[np.minimum(mid, n - 1)] < s)
            a = np.where(go, mid + 1, a)
            b = np.where(live & ~go, mid, b)
        j = a - 1
        ok = j >= lo[idx]
        out[idx[ok]] = j[ok]
        return out

    # -- answers ---------------------------------------------------------------
    def lookup(self, keys, seq):
        """(found, value) of each key as a read at sequence ``seq`` sees
        it; a key not found has the value 0."""
        q = np.asarray(keys, dtype=np.int64)
        s = np.broadcast_to(np.asarray(seq, dtype=np.int64), q.shape)
        found, vals = self._base(q)
        j = self._last_write_before(q, s)
        _, wv, wkind, _ = self._writes()
        w = j >= 0
        found = found.copy()
        vals = vals.copy()
        found[w] = wkind[j[w]] == INSERT
        vals[w] = np.where(found[w], wv[j[w]], 0)
        return found, vals

    def delete_hits(self, keys, seq):
        """Whether each delete at sequence ``seq`` found its key live."""
        return self.lookup(keys, seq)[0]

    def contents(self, before=None):
        """The live (keys, values) after every logged write, or after those
        with a sequence below ``before``, sorted."""
        wk, wv, wkind, wseq = self._writes()
        if before is not None:
            keep = wseq < before
            wk, wv, wkind = wk[keep], wv[keep], wkind[keep]
        if len(wk) == 0:
            return self.keys0.copy(), self.vals0.copy()
        last = np.ones(len(wk), dtype=bool)
        last[:-1] = wk[1:] != wk[:-1]
        lk, lv, lkind = wk[last], wv[last], wkind[last]
        untouched = ~np.isin(self.keys0, lk, assume_unique=True)
        ins = lkind == INSERT
        keys = np.concatenate([self.keys0[untouched], lk[ins]])
        vals = np.concatenate([self.vals0[untouched], lv[ins]])
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]

    def size(self, before=None) -> int:
        return len(self.contents(before)[0])


def count_wrong(found, vals, want_found, want_vals) -> int:
    """Answers whose found flag differs, or whose value differs where both
    found the key."""
    found = np.asarray(found, dtype=bool)
    want_found = np.asarray(want_found, dtype=bool)
    bad = found != want_found
    both = found & want_found
    bad |= both & (np.asarray(vals) != np.asarray(want_vals))
    return int(bad.sum())


def contents_mismatch(keys, vals, want_keys, want_vals) -> int:
    """Keys missing on one side, plus keys held with another value."""
    keys = np.asarray(keys, dtype=np.int64)
    want_keys = np.asarray(want_keys, dtype=np.int64)
    common, ia, ib = np.intersect1d(keys, want_keys, assume_unique=False,
                                    return_indices=True)
    missing = len(want_keys) - len(common)
    extra = len(keys) - len(common)
    wrong = int((np.asarray(vals)[ia] != np.asarray(want_vals)[ib]).sum())
    return int(missing + extra + wrong)


def contents_examples(keys, vals, want_keys, want_vals, n: int = 4):
    """A few of the keys that ``contents_mismatch`` counts, as text."""
    keys = np.asarray(keys, dtype=np.int64)
    want_keys = np.asarray(want_keys, dtype=np.int64)
    out = [f"key {int(k)} missing" for k in
           np.setdiff1d(want_keys, keys)[:n]]
    out += [f"key {int(k)} extra" for k in np.setdiff1d(keys, want_keys)[:n]]
    common, ia, ib = np.intersect1d(keys, want_keys, return_indices=True)
    diff = np.nonzero(np.asarray(vals)[ia] != np.asarray(want_vals)[ib])[0]
    out += [f"key {int(common[i])} holds {int(np.asarray(vals)[ia[i]])}, "
            f"the reference {int(np.asarray(want_vals)[ib[i]])}"
            for i in diff[:n]]
    return out
