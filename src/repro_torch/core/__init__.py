"""UpLIF index core of the port: state, host builders, ops and the shell."""
from repro_torch.core.uplif import UpLIF, UpLIFConfig  # noqa: F401
