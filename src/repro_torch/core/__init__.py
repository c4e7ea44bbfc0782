"""UpLIF index core of the port: state, host builders, ops, the shell and
the sharded router."""
from repro_torch.core.sharded import ShardedUpLIF  # noqa: F401
from repro_torch.core.uplif import UpLIF, UpLIFConfig  # noqa: F401
