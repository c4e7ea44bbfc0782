"""Parallel tooling (port of ``repro/parallel``): so far the device-local
half of gradient compression."""
from repro_torch.parallel import compression

__all__ = ["compression"]
