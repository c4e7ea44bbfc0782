"""Logical meshes (port of ``repro/launch/mesh.py``).

A mesh here is axis names and sizes, nothing more: building one touches no
device, no CUDA context and no process group, so the partition specs and
the dry run can be computed for the reference's 16 x 16 and 2 x 16 x 16
TPU meshes on any machine. The port executes on a mesh of one device
(``make_mesh_for_devices(1)``, shape (1, 1)); a sharding over a larger
mesh raises when it would place a tensor (``parallel/partition.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes; ``shape`` maps each name to its size in
    axis order, as ``jax.sharding.Mesh.shape`` does."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.shape.values())


def _mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over the axes ``axes`` (the reference's
    ``jax.make_mesh``, every axis Auto)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    return Mesh(axes, dict(zip(axes, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Axes: `pod` (cross-pod data parallelism over DCN), `data` (in-pod data
    parallel + FSDP storage sharding), `model` (tensor/expert parallel).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 1) -> Mesh:
    """Elastic helper: any device count -> (data, model) mesh."""
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices do not split into model "
                         f"parallel groups of {model_parallel}")
    return _mesh((n_devices // model_parallel, model_parallel),
                 ("data", "model"))
