"""Paper workloads (Section 5.1; port of ``repro/data/workloads.py``):
Read-Only / Read-Heavy (10% writes) / Write-Heavy (50%) / Write-Only (100%).

A workload is executed in mixed batches against any index exposing the
UpLIF API (lookup/insert). ``WorkloadRunner`` measures sustained throughput
the way the paper does: initialize with the first part of the dataset, then
run timed mixed batches that read existing keys and insert the remaining
keys. The index decides the device; this module works on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.rl_agent import encode_state

WORKLOADS = {
    "read_only": 0.0,
    "read_heavy": 0.1,
    "write_heavy": 0.5,
    "write_only": 1.0,
}


@dataclasses.dataclass
class WorkloadResult:
    name: str
    dataset: str
    ops: int
    seconds: float
    mops: float
    index_bytes: int
    extra: dict


class WorkloadRunner:
    """Generates mixed read/insert batches from a key set.

    ``distribution_shift=True`` reproduces Section 5.3: the index is
    initialized with the *smallest* keys and the insert stream comes from the
    upper (unseen) part of the key domain.
    """

    def __init__(
        self,
        keys: np.ndarray,
        init_frac: float = 0.5,
        batch: int = 4096,
        seed: int = 0,
        distribution_shift: bool = False,
    ):
        keys = np.asarray(keys, dtype=np.int64)
        self.rng = np.random.default_rng(seed)
        n_init = int(len(keys) * init_frac)
        if distribution_shift:
            keys = np.sort(keys)
            self.init_keys = keys[:n_init]
            self.insert_keys = keys[n_init:].copy()
            self.rng.shuffle(self.insert_keys)
        else:
            perm = self.rng.permutation(len(keys))
            self.init_keys = np.sort(keys[perm[:n_init]])
            self.insert_keys = keys[perm[n_init:]]
        self.batch = batch
        self._ins_pos = 0
        self._known = self.init_keys

    def reset(self):
        self._ins_pos = 0
        self._known = self.init_keys

    def next_batch(self, write_rate: float) -> Tuple[np.ndarray, np.ndarray]:
        """(read_keys, insert_keys) for one mixed batch."""
        n_w = int(self.batch * write_rate)
        n_r = self.batch - n_w
        if self._ins_pos + n_w > len(self.insert_keys):
            self._ins_pos = 0  # wrap: re-inserting is a value update, valid
        ins = self.insert_keys[self._ins_pos : self._ins_pos + n_w]
        self._ins_pos += n_w
        reads = (
            self.rng.choice(self._known, n_r)
            if n_r > 0 and len(self._known)
            else np.zeros(0, dtype=np.int64)
        )
        if n_w:
            # grow the read-candidate pool occasionally (cheap amortized)
            if self._ins_pos % (self.batch * 16) < self.batch:
                self._known = np.concatenate(
                    [self._known, self.insert_keys[: self._ins_pos]]
                )
        return reads, ins

    def run(
        self,
        index,
        write_rate: float,
        seconds: float = 5.0,
        max_ops: Optional[int] = None,
        agent=None,
        agent_every: int = 16,
    ) -> WorkloadResult:
        """Timed mixed workload; optionally let a tuning agent act every
        ``agent_every`` batches (Module 4 in the serving loop)."""
        # warmup outside the timed window
        for _ in range(2):
            reads, ins = self.next_batch(write_rate)
            if len(reads):
                index.lookup(reads)
            if len(ins):
                index.insert(ins, ins + 1)
        ops = 0
        n_batches = 0
        t0 = time.perf_counter()
        while True:
            reads, ins = self.next_batch(write_rate)
            if len(reads):
                index.lookup(reads)
            if len(ins):
                index.insert(ins, ins + 1)
            ops += len(reads) + len(ins)
            n_batches += 1
            if agent is not None and n_batches % agent_every == 0:
                a = agent.choose(encode_state(index.measures()), explore=False)
                agent.apply_action(index, a)
            dt = time.perf_counter() - t0
            if dt >= seconds or (max_ops and ops >= max_ops):
                break
        dt = time.perf_counter() - t0
        return WorkloadResult(
            name=f"w{write_rate:.2f}",
            dataset="",
            ops=ops,
            seconds=dt,
            mops=ops / dt / 1e6,
            index_bytes=index.index_bytes(),
            extra=index.measures() if hasattr(index, "measures") else {},
        )
