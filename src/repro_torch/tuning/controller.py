"""Per-shard self-tuning controller (port of ``repro/tuning/controller.py``;
Section 4.3, Algorithm 1, online over the sharded router).

Tabular Q-learning as in ``core/rl_agent.py``, with three changes the
sharded router makes necessary and the paper's framing makes natural:

  * the *state* is a per-shard discretization of the live telemetry
    (delta-buffer fill, BMAT height, error scaling α, occupancy, forecast
    heat, BMAT type, shard count) — the controller focuses each decision on
    the shard the telemetry marks hottest;
  * the *action space* extends the paper's {keep, retrain, switch-BMAT}
    with the structural actions the router exposes: split-shard and
    merge-shards (the self-scaling knobs);
  * actions are *masked by the sharded state*: splitting past the shard
    cap, splitting a tiny shard, merging the last shard, or retraining an
    empty delta buffer are never representable choices, at train and at
    exploit time alike.

Rewards follow Algorithm 1, extended with a range-scan term: R =
η·tput/max_tput − (1−η)·mem/max_mem − η_r·range_lat/max_range_lat with
measured throughput/memory/range-latency (telemetry EWMAs — the ops run
between waves ARE the N operations of Algorithm 1 line 13). The scan term
is what makes BMAT-type switches that favor scans (the paper's Fig. 4
crossover) learnable online: a B+MAT's fenced layout answers the rank
range [r(lo), r(hi)) with fewer dependent gathers, which only shows up in
the reward if scan latency is in it. Cold-start exploitation falls back to
a transparent threshold heuristic until the Q-table has seen the state;
the heuristic is the bootstrap prior, the learned values override it.

Q-tables persist per **workload signature** — (write rate, skew, shift),
the paper's workload-class axes — through ``QTableStore``: a session saves
its table under its measured signature and a new session warm-starts from
the nearest stored signature (the paper's per-workload-class pre-training,
made incremental).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bmat import RBMAT
from repro_torch.core.state import LOCATE_FUSED, LOCATE_STRATEGIES
from repro_torch.kernels.ops import native_kernels
from repro_torch.tuning.telemetry import TelemetrySnapshot

# Extended per-shard action space (paper A1–A3 + structural A4/A5 + the
# per-shard locate-dispatch axis A6)
A_KEEP = 0           # maintain current structure
A_RETRAIN_SHARD = 1  # full retrain of the focus shard (absorbs its BMAT)
A_SWITCH_BMAT = 2    # flip RBMAT <-> B+MAT (global: layout is shared)
A_SPLIT_SHARD = 3    # split the focus shard at its median key
A_MERGE_SHARDS = 4   # merge the coldest adjacent shard pair
A_SWITCH_LOCATE = 5  # repin the focus shard's locate strategy (per shard)
ACTIONS = (A_KEEP, A_RETRAIN_SHARD, A_SWITCH_BMAT, A_SPLIT_SHARD,
           A_MERGE_SHARDS, A_SWITCH_LOCATE)
ACTION_NAMES = ("keep", "retrain_shard", "switch_bmat", "split_shard",
                "merge_shards", "switch_locate")


def locate_candidates(device) -> Tuple[str, ...]:
    """Strategies the controller may pin a shard of a router on ``device``
    to. Off CUDA the fused strategy runs the kernels' plain versions — a
    correctness proxy, not a speedup — so fused is a candidate exactly
    where K1 and K2 are native. The dispatch axis itself (mixed per-shard
    strategies in one wave) is exercised either way."""
    if native_kernels(device):
        return LOCATE_STRATEGIES
    return tuple(s for s in LOCATE_STRATEGIES if s != LOCATE_FUSED)

# state discretization edges
_FILL_EDGES = np.array([0.05, 0.2, 0.5, 0.8])
_HEIGHT_EDGES = np.array([4, 8, 12, 16, 20])
_ERR_EDGES = np.array([0.5, 1.0, 2.0, 4.0])
_OCC_EDGES = np.array([0.5, 0.75, 0.9])
_HEAT_EDGES = np.array([0.5, 1.5, 3.0])     # forecast mass × S (1 = even)
_SHARDS_EDGES = np.array([2, 4, 8, 16])


@dataclasses.dataclass
class ControllerConfig:
    alpha: float = 0.8       # learning rate (paper sensitivity: high)
    gamma: float = 0.2       # discount (paper sensitivity: low)
    eta: float = 0.7         # reward throughput/memory weight (Section 5.1)
    eta_range: float = 0.15  # range-scan latency penalty weight (0 = off)
    epsilon: float = 0.3
    epsilon_decay: float = 0.95
    epsilon_min: float = 0.05
    max_shards: int = 16
    min_split_keys: int = 8192   # a shard below this never splits
    merge_max_keys: int = 8192   # adjacent pairs above this never merge
    fill_retrain: float = 0.35   # heuristic: retrain past this buffer fill
    heat_split: float = 2.0      # heuristic: split past this forecast heat
    seed: int = 0


class ShardTuningController:
    """Q-learning over per-shard telemetry states with masked actions."""

    def __init__(self, config: ControllerConfig = ControllerConfig()):
        self.cfg = config
        self.q: Dict[Tuple, np.ndarray] = {}
        self.rng = np.random.default_rng(config.seed)
        self.epsilon = config.epsilon
        self._max_tput = 1e-9
        self._max_mem = 1.0
        self._max_range_lat = 0.0
        self.action_counts = np.zeros(len(ACTIONS), dtype=np.int64)

    # -- state ---------------------------------------------------------------
    def focus_shard(self, snap: TelemetrySnapshot, heat: np.ndarray) -> int:
        """The shard this decision is about: most urgent by buffer fill,
        forecast heat as the tie-breaker (pressure that is coming)."""
        # heat × S == 1 means "even share"; weigh predicted pressure a
        # quarter as much as pressure already materialized in the buffer
        urgency = snap.bmat_fill + 0.25 * heat * snap.n_shards
        return int(np.argmax(urgency))

    def encode(
        self, snap: TelemetrySnapshot, s: int, heat: np.ndarray
    ) -> Tuple[int, ...]:
        """Discretized per-shard state (S1..S5 + fill/occupancy/heat/#shards)."""
        return (
            int(np.searchsorted(_FILL_EDGES, float(snap.bmat_fill[s]))),
            int(np.searchsorted(_HEIGHT_EDGES, int(snap.bmat_height[s]))),
            int(np.searchsorted(_ERR_EDGES, float(snap.alpha[s]))),
            int(np.searchsorted(_OCC_EDGES, float(snap.occupancy[s]))),
            int(np.searchsorted(_HEAT_EDGES, float(heat[s]) * snap.n_shards)),
            0 if snap.bmat_type == RBMAT else 1,
            int(np.searchsorted(_SHARDS_EDGES, snap.n_shards)),
        )

    def action_mask(self, snap: TelemetrySnapshot, s: int) -> np.ndarray:
        """bool[|A|] — which actions the *sharded state* admits right now."""
        mask = np.zeros(len(ACTIONS), dtype=bool)
        mask[A_KEEP] = True
        mask[A_RETRAIN_SHARD] = int(snap.bmat_size[s]) > 0
        mask[A_SWITCH_BMAT] = True
        mask[A_SPLIT_SHARD] = (
            snap.n_shards < self.cfg.max_shards
            and int(snap.n_keys[s] + snap.n_bmat_live[s])
            >= self.cfg.min_split_keys
        )
        live = snap.n_keys + snap.n_bmat_live
        pair_ok = (
            snap.n_shards >= 2
            and int((live[:-1] + live[1:]).min()) <= self.cfg.merge_max_keys
        )
        mask[A_MERGE_SHARDS] = pair_ok
        # switching the locate strategy is only a representable choice when
        # the latency telemetry actually argues for a different one — the
        # action is then deterministic (pin the argmin), so exposing it
        # with nothing to change would just be a noisy KEEP
        mask[A_SWITCH_LOCATE] = (
            bool(snap.locate_strategy)
            and self.pick_locate(snap, s) != snap.locate_strategy[s]
        )
        return mask

    def pick_locate(self, snap: TelemetrySnapshot, s: int) -> str:
        """Latency-argmin locate strategy for shard ``s``.

        Reads the per-(shard, strategy) seconds-per-query EWMAs. A
        strategy the shard has never run under gets an OPTIMISTIC prior
        (half the best observed latency) so it is tried rather than
        starved; with no observations at all the current assignment stands
        (no evidence, no churn). Leaving the current strategy requires a
        ≥10% predicted win — hysteresis against EWMA noise flapping the
        jit-variant set."""
        cur = snap.locate_strategy[s]
        cands = locate_candidates(snap.device)
        obs = {c: snap.locate_lat.get((s, c)) for c in cands}
        observed = [v for v in obs.values() if v is not None]
        if not observed:
            return cur
        prior = 0.5 * min(observed)
        score = {c: (v if v is not None else prior) for c, v in obs.items()}
        best = min(cands, key=lambda c: score[c])
        if cur in score and score[best] >= 0.9 * score[cur]:
            return cur
        return best

    @staticmethod
    def coldest_pair(snap: TelemetrySnapshot) -> int:
        """Index s of the adjacent pair (s, s+1) with the fewest live keys."""
        live = snap.n_keys + snap.n_bmat_live
        return int(np.argmin(live[:-1] + live[1:]))

    # -- policy --------------------------------------------------------------
    def _q_row(self, s: Tuple) -> np.ndarray:
        if s not in self.q:
            self.q[s] = np.zeros(len(ACTIONS))
        return self.q[s]

    @staticmethod
    def _masked(row: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = np.full_like(row, -np.inf)
        out[mask] = row[mask]
        return out

    def heuristic(
        self,
        snap: TelemetrySnapshot,
        s: int,
        heat: np.ndarray,
        mask: np.ndarray,
    ) -> int:
        """Cold-start bootstrap policy for states the Q-table hasn't seen:
        retrain when the focus shard's buffer is hot, split when the
        forecast piles mass onto one near-full shard, else keep."""
        if mask[A_RETRAIN_SHARD] and float(snap.bmat_fill[s]) >= self.cfg.fill_retrain:
            return A_RETRAIN_SHARD
        if (
            mask[A_SPLIT_SHARD]
            and float(heat[s]) * snap.n_shards >= self.cfg.heat_split
            and float(snap.bmat_fill[s]) >= self.cfg.fill_retrain / 2
        ):
            return A_SPLIT_SHARD
        return A_KEEP

    def choose(
        self,
        state: Tuple,
        mask: np.ndarray,
        *,
        explore: bool = True,
        snap: Optional[TelemetrySnapshot] = None,
        s: int = 0,
        heat: Optional[np.ndarray] = None,
    ) -> int:
        allowed = np.flatnonzero(mask)
        if explore and self.rng.random() < self.epsilon:
            return int(self.rng.choice(allowed))
        if state not in self.q:
            if snap is not None and heat is not None:
                return self.heuristic(snap, s, heat, mask)
            return A_KEEP
        return int(np.argmax(self._masked(self._q_row(state), mask)))

    # -- learning (Algorithm 1 lines 14-19) ----------------------------------
    def reward(
        self, throughput: float, memory: float, range_lat: float = 0.0
    ) -> float:
        """R = η·tput − (1−η)·mem − η_r·range_lat, each term normalized by
        its running max. The scan term contributes nothing until the
        serving loop actually reports range latencies (max stays 0), so
        point-only workloads reproduce the paper's two-term reward. The
        range normalizer DECAYS (~5%/reward) before ratcheting: the first
        scan observation includes jit compilation, orders of magnitude
        above steady state — a never-decaying max would pin every later
        penalty near zero and deaden the term it exists for."""
        self._max_tput = max(self._max_tput, throughput)
        self._max_mem = max(self._max_mem, memory)
        self._max_range_lat = max(self._max_range_lat * 0.95, range_lat)
        r = (
            self.cfg.eta * throughput / self._max_tput
            - (1 - self.cfg.eta) * memory / self._max_mem
        )
        if self._max_range_lat > 0.0:
            r -= self.cfg.eta_range * range_lat / self._max_range_lat
        return r

    def update(
        self,
        state: Tuple,
        a: int,
        r: float,
        state_next: Tuple,
        mask_next: np.ndarray,
    ):
        row = self._q_row(state)
        nxt = self._masked(self._q_row(state_next), mask_next)
        best_next = float(np.max(nxt))
        if not np.isfinite(best_next):
            best_next = 0.0
        row[a] = (1 - self.cfg.alpha) * row[a] + self.cfg.alpha * (
            r + self.cfg.gamma * best_next
        )
        self.epsilon = max(
            self.cfg.epsilon_min, self.epsilon * self.cfg.epsilon_decay
        )

    # -- persistence (paper's per-workload-class pre-training) ----------------
    def export_q(self) -> dict:
        """JSON-serializable view of the learned table."""
        return {
            ",".join(map(str, k)): [float(x) for x in v]
            for k, v in self.q.items()
        }

    def import_q(self, table: dict, only_missing: bool = True):
        """Warm-start from a stored table. ``only_missing`` keeps rows this
        session already learned (its own measurements beat the prior).
        Stored rows narrower than the live action space (saved before an
        action was added, e.g. switch_locate) zero-pad: a zero Q is
        exactly the value an unseen action starts with."""
        for ks, row in table.items():
            k = tuple(int(x) for x in ks.split(","))
            if only_missing and k in self.q:
                continue
            r = np.asarray(row, dtype=np.float64)
            if len(r) < len(ACTIONS):
                r = np.pad(r, (0, len(ACTIONS) - len(r)))
            self.q[k] = r[: len(ACTIONS)]


class QTableStore:
    """Q-tables keyed by workload signature (write-rate × skew × shift).

    One JSON file holds every signature's table. ``nearest`` returns the
    stored entry with the smallest L2 distance in signature space (each
    axis log-compressed — a 2x write-rate difference matters equally at
    0.1 and 0.4); a fresh session warm-starts from it and, at save time,
    writes its own table under its own measured signature. Corrupt or
    unreadable stores degrade to empty (pre-training is an accelerant,
    never a dependency)."""

    def __init__(self, path: str):
        self.path = path
        self._entries: list = []
        try:
            with open(path) as fh:
                self._entries = json.load(fh)["entries"]
        except (OSError, ValueError, KeyError):
            self._entries = []

    @staticmethod
    def _dist(a: Sequence[float], b: Sequence[float]) -> float:
        av = np.log1p(np.asarray(a, dtype=np.float64))
        bv = np.log1p(np.asarray(b, dtype=np.float64))
        return float(np.sqrt(((av - bv) ** 2).sum()))

    def nearest(self, signature: Sequence[float]) -> Optional[dict]:
        if not self._entries:
            return None
        return min(
            self._entries,
            key=lambda e: self._dist(e["signature"], signature),
        )

    def warm_start(
        self, controller: ShardTuningController, signature: Sequence[float]
    ) -> bool:
        """Load the nearest stored table into the controller's empty rows."""
        entry = self.nearest(signature)
        if entry is None:
            return False
        controller.import_q(entry["q"], only_missing=True)
        return True

    def save(
        self, signature: Sequence[float], controller: ShardTuningController
    ):
        """Insert-or-replace this signature's entry and persist the store.
        Signatures closer than ~5% on every axis collapse into one entry
        (replaced by the newer table — it subsumes the warm-start)."""
        sig = [float(x) for x in signature]
        self._entries = [
            e for e in self._entries
            if self._dist(e["signature"], sig) > 0.05
        ]
        self._entries.append({"signature": sig, "q": controller.export_q()})
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"entries": self._entries}, fh)
        os.replace(tmp, self.path)
