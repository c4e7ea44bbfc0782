"""RL-based self-tuning (Section 4.3, Algorithm 1; port of
``repro/core/rl_agent.py``).

Tabular Q-learning over discretized performance-measure states. The reward is
*measured*: the agent runs N operations through the live index after each
action and observes wall-clock throughput + live index memory, exactly as in
Algorithm 1 (lines 11–19). The paper pre-trains an agent per workload and
then exploits the Q-table; ``QLearningAgent.train`` / ``.policy`` mirror that.

The agent is host numpy; the index it tunes decides the device. ``save``
and ``load`` keep the JAX package's ``.npz`` format, so a Q-table learned
there loads here and gives the same policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.bmat import RBMAT
from repro_torch.core.uplif import UpLIF

# Action space A (Section 4.2 / 4.3)
A_KEEP = 0        # A1: maintain current BMAT structure
A_RETRAIN = 1     # A2: retrain index models on specific BMAT branches
A_SWITCH = 2      # A3: transition to the other BMAT type
ACTIONS = (A_KEEP, A_RETRAIN, A_SWITCH)

# state discretization buckets
_HEIGHT_EDGES = np.array([4, 8, 12, 16, 20])          # S1: BMAT height
_GRAN_EDGES = np.array([10**3, 10**6, 10**9, 10**12])  # S2: min granularity
_ERR_EDGES = np.array([0.5, 1.0, 2.0, 4.0])            # S3: error scaling α
_MODELS_EDGES = np.array([256, 1024, 4096, 16384])     # S4: number of models


def encode_state(measures: Dict) -> Tuple[int, int, int, int, int]:
    """(S1..S5) of Section 4.3, discretized for the Q-table."""
    s1 = int(np.searchsorted(_HEIGHT_EDGES, measures["bmat_height"]))
    g = measures["granularity"]
    s2 = int(np.searchsorted(_GRAN_EDGES, min(g, 10**15)))
    s3 = int(np.searchsorted(_ERR_EDGES, measures["error_scaling"]))
    s4 = int(np.searchsorted(_MODELS_EDGES, measures["n_models"]))
    s5 = 0 if measures["bmat_type"] == RBMAT else 1
    return (s1, s2, s3, s4, s5)


@dataclasses.dataclass
class AgentConfig:
    alpha: float = 0.8      # learning rate — paper's sensitivity: high is best
    gamma: float = 0.2      # discount — paper's sensitivity: low is best
    eta: float = 0.7        # reward throughput/memory weight (Section 5.1)
    epsilon: float = 0.5
    epsilon_decay: float = 0.95
    epsilon_min: float = 0.05
    ops_per_step: int = 1000  # N in Algorithm 1
    seed: int = 0


class QLearningAgent:
    """System Tuning Agent (Algorithm 1)."""

    def __init__(
        self,
        config: AgentConfig = AgentConfig(),
        available_actions: Tuple[int, ...] = ACTIONS,
    ):
        self.cfg = config
        self.available_actions = available_actions  # admin may disable some
        self.q: Dict[Tuple, np.ndarray] = {}
        self.rng = np.random.default_rng(config.seed)
        self.epsilon = config.epsilon
        self.history: List[Dict] = []
        # reward normalizers (max system throughput / total memory), learned
        # online from observations
        self._max_tput = 1e-9
        self._max_mem = 1.0

    def _q_row(self, s: Tuple) -> np.ndarray:
        if s not in self.q:
            self.q[s] = np.zeros(len(ACTIONS))
        return self.q[s]

    def choose(self, s: Tuple, explore: bool = True) -> int:
        if explore and self.rng.random() < self.epsilon:
            return int(self.rng.choice(self.available_actions))
        if s not in self.q and not explore:
            return A_KEEP  # unseen state at exploit time: cheapest action
        return int(np.argmax(self._masked(self._q_row(s))))

    def reward(self, throughput: float, memory: float) -> float:
        """R(s,a) = η·tput/max_tput − (1−η)·mem/total_mem (Section 4.3)."""
        self._max_tput = max(self._max_tput, throughput)
        self._max_mem = max(self._max_mem, memory)
        return (
            self.cfg.eta * throughput / self._max_tput
            - (1 - self.cfg.eta) * memory / self._max_mem
        )

    def update(self, s: Tuple, a: int, r: float, s_next: Tuple):
        row = self._q_row(s)
        nxt = self._q_row(s_next)
        best_next = np.max(nxt[list(self.available_actions)])
        row[a] = (1 - self.cfg.alpha) * row[a] + self.cfg.alpha * (
            r + self.cfg.gamma * best_next
        )
        self.epsilon = max(
            self.cfg.epsilon_min, self.epsilon * self.cfg.epsilon_decay
        )

    # ------------------------------------------------------------------
    def apply_action(self, index: UpLIF, a: int):
        """tuneSystem(a_t) — Section 4.2 actions on the live index."""
        if a == A_RETRAIN:
            if index.bmat.size > 4096:
                index.retrain_full()
            else:
                index.retrain_subset()
        elif a == A_SWITCH:
            index.switch_bmat_type()
        # A_KEEP: no-op

    def step(
        self,
        index: UpLIF,
        run_ops: Callable[[UpLIF], int],
        explore: bool = True,
    ) -> Dict:
        """One Algorithm-1 iteration: observe, act, run N ops, reward, learn.

        ``run_ops(index)`` must execute ~cfg.ops_per_step operations and
        return the count; timing starts at the tuning point so the tuning
        overhead is charged to the action (Algorithm 1 line 11–13).
        """
        s = encode_state(index.measures())
        a = self.choose(s, explore)
        t0 = time.perf_counter()
        self.apply_action(index, a)
        n_ops = run_ops(index)
        dt = max(time.perf_counter() - t0, 1e-9)
        tput = n_ops / dt
        mem = float(index.index_bytes())
        r = self.reward(tput, mem)
        s_next = encode_state(index.measures())
        if explore:
            self.update(s, a, r, s_next)
        rec = {
            "state": s,
            "action": a,
            "reward": r,
            "throughput": tput,
            "memory": mem,
            "next_state": s_next,
        }
        self.history.append(rec)
        return rec

    def train(
        self,
        index: UpLIF,
        run_ops: Callable[[UpLIF], int],
        episodes: int = 50,
    ) -> List[Dict]:
        return [self.step(index, run_ops, explore=True) for _ in range(episodes)]

    def _masked(self, row: np.ndarray) -> np.ndarray:
        masked = np.full_like(row, -np.inf)
        masked[list(self.available_actions)] = row[list(self.available_actions)]
        return masked

    def policy(self) -> Dict[Tuple, int]:
        """Greedy policy from the learned Q-table (evaluation mode: the paper
        'only exploits the calculated Q-Table'). Masks disabled actions the
        same way ``choose`` does — the admin's action restrictions must hold
        at exploit time too, not just during training."""
        return {s: int(np.argmax(self._masked(row))) for s, row in self.q.items()}

    def save(self, path: str):
        np.savez(
            path,
            states=np.array([list(s) for s in self.q], dtype=np.int64),
            values=np.array(list(self.q.values()), dtype=np.float64),
        )

    @classmethod
    def load(cls, path: str, config: AgentConfig = AgentConfig()):
        agent = cls(config)
        data = np.load(path)
        for s, v in zip(data["states"], data["values"]):
            agent.q[tuple(int(x) for x in s)] = v.copy()
        return agent
