"""Launch tooling (port of ``repro/launch``): meshes, input cells, the dry
run, its roofline, and the train and serve launchers.

The reference does three jobs with it: it maps logical weight and
activation axes to a TPU mesh; it lowers and compiles every (arch x shape
x mesh) cell on 512 placeholder CPU devices and reads XLA's memory, FLOP
and collective figures for a TPU v5e roofline; and it launches training
and serving. On one H100 the port does the same as follows:

  * meshes are logical (``mesh``): axis names and sizes, the reference's
    16 x 16 and 2 x 16 x 16 or ``make_mesh_for_devices(n, mp)``; building
    one touches no device, CUDA or process group. The port executes only
    on a mesh of one device, (1, 1) on the card;
  * partition specs (``repro_torch.parallel.partition``) are computed
    exactly as the reference computes them: pure data giving every
    parameter, optimizer, batch and cache leaf's per-device shard shape; on
    a one-device mesh they place leaves on that device, and a sharding
    over more devices raises ``ValueError`` (the port runs on one card),
    never replicating in silence;
  * the dry run (``dryrun``) traces each cell's program, the reference's
    ``train_step``, prefill ``forward_lm`` and ``decode_step``, on the
    ``meta`` device: argument, output and alias bytes counted exactly per
    device from the specs; matmul-class FLOPs and a traffic proxy counted
    over the global program (``program_analysis``, the counterpart of
    ``hlo_analysis.py``) and split evenly over the mesh; collective and
    temp bytes and compile time, which have no counterpart on one card,
    ``null`` and listed with their reasons, never 0;
  * the roofline (``roofline``) uses the H100's public figures (989e12
    bf16 FLOP/s, 3.35e12 B/s HBM, 450e9 B/s NVLink a direction) and shows
    the collective term as "—";
  * the launchers (``train``, ``serve``) are the reference's command lines
    with the same flags plus ``--device`` (``cuda`` by default), each with
    a function (``train(cfg, ...)``, ``serve(cfg, ...)``) that takes any
    config.

The submodules load on first use, so ``python -m repro_torch.launch.train``
runs its module once.
"""
import importlib

__all__ = ["dryrun", "mesh", "program_analysis", "roofline", "serve",
           "specs", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
