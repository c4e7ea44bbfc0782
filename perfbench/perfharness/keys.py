"""Keys and operation tapes, from the seed alone.

The dataset generators are frozen copies of the port's
``repro_torch/data/datasets.py`` (``make_fb``, ``make_wikits``: SOSD-shaped
keys, unique, sorted, below 2**52), so that a later change to the program
cannot move the yardstick. They draw the same distributions with a
``torch.Generator`` on the run's device, in a few large calls: on the
H100 machine's host the NumPy versions took 20-60 s of every run's
set-up at 16M keys. ``WaveTape`` is the read/insert mix of the
port's ``WorkloadRunner`` (``repro_torch/data/workloads.py``): the same
split of the keys into a bulk-loaded part and an insert stream, with or
without the paper's distribution shift, the same uniform reads over the
known keys and the same growth of that pool every 16 batches. It draws a
wave's reads with one vectorised call and never concatenates the pool.

Values: a bulk-loaded key k holds 2k + 1, an inserted key 2k + 2, so a
read that finds a stale or a neighbour's value is caught.
"""
from __future__ import annotations

import numpy as np
import torch

_MAX_KEY = 1 << 52


def _generator(seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _unique_pad(keys, n: int, g) -> np.ndarray:
    keys = torch.unique(keys)
    while keys.numel() < n:
        extra = torch.randint(0, _MAX_KEY, (2 * (n - keys.numel()),),
                              generator=g, device=keys.device)
        keys = torch.unique(torch.cat([keys, extra]))
    return keys[:n].cpu().numpy().astype(np.int64)


def make_fb(n: int, seed: int = 0, device="cpu") -> np.ndarray:
    """Facebook user ids: a heavy-tailed mixture of dense clusters."""
    g = _generator(seed, device)
    n_clusters = max(64, n // 4096)
    centers = torch.sort(torch.randint(0, _MAX_KEY, (n_clusters,),
                                       generator=g, device=device)).values
    # numpy's pareto(1.2) + 1, by its inverse CDF: U ** (-1 / 1.2)
    u = torch.rand(n_clusters, generator=g, device=device,
                   dtype=torch.float64)
    sizes = (1.0 - u) ** (-1.0 / 1.2)
    sizes = torch.clamp((sizes / sizes.sum() * n).to(torch.int64), min=1)
    offs = torch.randint(0, 1 << 24, (int(sizes.sum()),), generator=g,
                         device=device)
    reps = torch.repeat_interleave(centers, sizes)
    return _unique_pad(reps + offs[: reps.numel()], n, g)


def make_wikits(n: int, seed: int = 0, device="cpu") -> np.ndarray:
    """Wikipedia request timestamps: bursty near-linear increments."""
    g = _generator(seed, device)
    busy = torch.rand(n, generator=g, device=device) < 0.3
    e = torch.empty(2, n, dtype=torch.float64, device=device)
    e.exponential_(generator=g)
    gaps = torch.where(busy, 2.0 * e[0], 50.0 * e[1]).to(torch.int64) + 1
    keys = torch.cumsum(gaps, 0) + 1_500_000_000
    return _unique_pad(keys, n, g)


DATASETS = {"fb": make_fb, "wikits": make_wikits}


def split(keys: np.ndarray, n_init: int, seed: int, device="cpu",
          shift: bool = False):
    """(loaded keys sorted, the rest in a random order), as
    ``WorkloadRunner`` splits them: a random subset, or with the
    distribution shift the smallest ``n_init``."""
    g = _generator(seed, device)
    k = torch.as_tensor(keys, device=device)
    if shift:
        k = torch.sort(k).values
        rest = k[n_init:]
        rest = rest[torch.randperm(rest.numel(), generator=g, device=device)]
        return k[:n_init].cpu().numpy(), rest.cpu().numpy()
    perm = torch.randperm(k.numel(), generator=g, device=device)
    init = torch.sort(k[perm[:n_init]]).values
    return init.cpu().numpy(), k[perm[n_init:]].cpu().numpy()


def loaded_value(keys: np.ndarray) -> np.ndarray:
    return 2 * keys + 1


def inserted_value(keys: np.ndarray) -> np.ndarray:
    return 2 * keys + 2


class WaveTape:
    """Closed-loop mixed waves over a key set (``WorkloadRunner``'s mix).

    ``distribution_shift`` loads the smallest ``init_frac`` of the keys and
    inserts the rest in a shuffled order (the paper's Section 5.3);
    otherwise a random ``init_frac`` is loaded and the rest inserted in a
    random order."""

    GROW_EVERY = 16   # waves between growths of the read pool

    def __init__(self, keys: np.ndarray, *, init_frac: float, batch: int,
                 write_rate: float, seed: int,
                 distribution_shift: bool = False, device="cpu"):
        self.rng = np.random.default_rng([seed, 1])
        self.init_keys, self.insert_keys = split(
            keys, int(len(keys) * init_frac), seed, device,
            shift=distribution_shift)
        self.batch = int(batch)
        self.n_write = int(self.batch * write_rate)
        self.n_read = self.batch - self.n_write
        self._ins_pos = 0
        self._known_ins = 0   # inserted keys in the read pool

    def next_wave(self):
        """(read keys, insert keys) of the next wave."""
        n_w = self.n_write
        if self._ins_pos + n_w > len(self.insert_keys):
            self._ins_pos = 0   # wrap: a re-insert is a value update, valid
        ins = self.insert_keys[self._ins_pos:self._ins_pos + n_w]
        self._ins_pos += n_w
        reads = np.zeros(0, dtype=np.int64)
        if self.n_read:
            n_init = len(self.init_keys)
            i = self.rng.integers(0, n_init + self._known_ins, self.n_read)
            old = i < n_init
            reads = np.where(
                old, self.init_keys[np.minimum(i, n_init - 1)],
                self.insert_keys[np.maximum(i - n_init, 0)])
        if n_w and self._ins_pos % (self.batch * self.GROW_EVERY) < self.batch:
            self._known_ins = self._ins_pos
        return reads, ins
