"""The paper's own system configuration (Section 5.1): RadixSpline base
model with spline error bound, B+MAT delta buffer, GMM placeholders, and the
RL agent hyperparameters from the sensitivity study (alpha high, gamma low,
eta = 0.7)."""
from repro_torch.core.bmat import BPMAT
from repro_torch.core.rl_agent import AgentConfig
from repro_torch.core.uplif import UpLIFConfig

# Index configuration. The paper uses RadixSpline "spline degree 128" — our
# greedy corridor with xi=24 yields comparable knot densities on the three
# datasets; W/K/d_max are the tensorized Movement/placeholder knobs
# (DESIGN.md §2).
INDEX = UpLIFConfig(
    max_error=24,
    window=64,
    movement_k=6,
    d_max=32,
    alpha_target=1.0,
    radix_bits=16,
    bmat_type=BPMAT,
    bmat_fanout=16,
)

# Section 5.1 "RL Hyperparameters": high learning rate, low discount.
AGENT = AgentConfig(alpha=0.8, gamma=0.2, eta=0.7, ops_per_step=1000)

DATASETS = ("fb", "wikits", "logn")
INIT_KEYS = 100_000_000      # paper scale; benchmarks auto-scale to host
WORKLOAD_SECONDS = 60.0
