"""Parallel tooling (port of ``repro/parallel``): the sharding strategy
layer (``partition``: partition specs computed as the reference computes
them, placed only on a one-device mesh) and gradient compression with its
all-reduce (``compression.compressed_psum``)."""
from repro_torch.parallel import compression, partition
from repro_torch.parallel.partition import ShardingStrategy

__all__ = ["ShardingStrategy", "compression", "partition"]
