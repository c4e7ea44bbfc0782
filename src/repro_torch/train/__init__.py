"""Training (port of ``repro/train``): AdamW with global-norm clipping,
the microbatched train step, atomic checkpoints in the reference's format
and the fault-tolerant loop."""
from repro_torch.train.checkpoint import latest_step, restore, save, save_async
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    abstract_opt_state,
    adamw_update,
    global_norm,
    init_opt_state,
)
from repro_torch.train.step import grads_of, make_train_step, pick_microbatches

__all__ = [
    "AdamWConfig",
    "OptState",
    "init_opt_state",
    "abstract_opt_state",
    "global_norm",
    "adamw_update",
    "grads_of",
    "make_train_step",
    "pick_microbatches",
    "save",
    "save_async",
    "latest_step",
    "restore",
    "LoopConfig",
    "SimulatedFailure",
    "run",
]
