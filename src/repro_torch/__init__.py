"""PyTorch/CUDA port of the UpLIF learned index.

The package mirrors ``src/repro`` module by module (``core/``, ``kernels/``,
``data/``). It imports torch and numpy only: never JAX and nothing of the
JAX package, whose host-side numpy pieces it keeps as its own copies.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises.
"""

__version__ = "1.0.0"
