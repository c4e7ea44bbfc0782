"""Training data pipeline with an UpLIF-backed document index (port of
``repro/data/pipeline.py``).

A packed token corpus is addressed by document id -> token offset, and
that mapping is an updatable index: shards stream in over time (inserts),
stale shards retire (deletes), and every batch assembly does a batched
lookup. The index lives on the caller's device (``cuda`` unless the
caller passes ``device="cpu"``); the corpus itself is host numpy.

The pipeline is deterministic in (seed, step): a restarted run re-issues
identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.uplif import UpLIF, UpLIFConfig


@dataclasses.dataclass
class PipelineConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    n_docs: int = 4096
    mean_doc_len: int = 640


class PackedCorpus:
    """Synthetic packed corpus: documents of varying length concatenated in
    one token stream; the (doc_id -> start offset) map lives in UpLIF."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        lens = rng.geometric(1.0 / cfg.mean_doc_len, cfg.n_docs).astype(np.int64)
        lens = np.maximum(lens, 16)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        self.total_tokens = int(lens.sum())
        self.tokens = rng.integers(
            0, cfg.vocab, self.total_tokens, dtype=np.int64
        ).astype(np.int32)
        # doc_id keys are sparse (shard_id << 32 | local_id), as in a real
        # corpus manifest
        self.doc_ids = (
            (rng.integers(0, 1 << 18, cfg.n_docs).astype(np.int64) << 32)
            | np.arange(cfg.n_docs, dtype=np.int64)
        )
        order = np.argsort(self.doc_ids)
        self.doc_ids = self.doc_ids[order]
        self._starts = starts[order]
        self._lens = lens[order]
        self.index = UpLIF(
            self.doc_ids, self._starts, UpLIFConfig(batch_bucket=1024),
            device=device,
        )

    # -- updatability (shards streaming in/out) ------------------------------
    def add_shard(self, shard_id: int, n_docs: int, seed: int = 1):
        rng = np.random.default_rng(seed + shard_id)
        lens = np.maximum(
            rng.geometric(1.0 / self.cfg.mean_doc_len, n_docs), 16
        ).astype(np.int64)
        new_tokens = rng.integers(
            0, self.cfg.vocab, int(lens.sum()), dtype=np.int64
        ).astype(np.int32)
        starts = self.total_tokens + np.concatenate([[0], np.cumsum(lens)[:-1]])
        ids = (np.int64(shard_id) << 32) | np.arange(n_docs, dtype=np.int64)
        self.tokens = np.concatenate([self.tokens, new_tokens])
        self.total_tokens += int(lens.sum())
        self.index.insert(ids, starts)
        self.doc_ids = np.sort(np.concatenate([self.doc_ids, ids]))
        return ids

    def retire_docs(self, ids: np.ndarray):
        self.index.delete(ids)
        self.doc_ids = np.setdiff1d(self.doc_ids, ids)

    # -- batch assembly --------------------------------------------------------
    def doc_tokens(self, ids: np.ndarray, max_len: int) -> np.ndarray:
        found, starts = self.index.lookup(ids)
        if not found.all():
            raise KeyError("doc id missing from index")
        out = np.zeros((len(ids), max_len), dtype=np.int32)
        for i, s in enumerate(starts):
            seg = self.tokens[s : s + max_len]
            out[i, : len(seg)] = seg
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given step (restart-safe)."""
        rng = np.random.default_rng((self.cfg.seed << 20) ^ step)
        ids = rng.choice(self.doc_ids, self.cfg.global_batch)
        return {"tokens": self.doc_tokens(ids, self.cfg.seq_len)}
