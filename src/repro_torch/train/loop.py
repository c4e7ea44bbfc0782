"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

  * checkpoint/restart: atomic checkpoints every N steps; on start, the loop
    resumes from the latest complete checkpoint (params and optimizer
    state; the batch is a function of the step, so the data cursor is the
    step itself);
  * failure injection: ``fail_at_step`` simulates a node crash mid-run;
  * straggler watchdog: a step over ``deadline_factor`` x the median of the
    last 50 is logged and counted;
  * async checkpoint writes overlap file IO with training.

A resumed run equals an uninterrupted one bit for bit where the step is
deterministic. The port's step is, on the CPU and on the card: the
embedding's backward adds a repeated token's rows in a sorted order, the
loss's target gather has no repeated index, and K6w adds each output in
one fixed order (``chip_smoke.py`` phase 19d checks the resume on the
card with and without ``torch.use_deterministic_algorithms``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.models.init import tree_device
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    keep_last: int = 3
    async_ckpt: bool = False
    deadline_factor: float = 3.0   # straggler threshold vs median step time
    fail_at_step: Optional[int] = None  # failure injection (tests)
    log_every: int = 10


class SimulatedFailure(RuntimeError):
    pass


def run(
    train_step: Callable,  # (params, opt, batch) -> (params, opt, loss, m)
    params: Any,
    opt_state: Any,
    next_batch: Callable[[int], Any],  # step -> batch (deterministic in step)
    cfg: LoopConfig,
    metadata: Optional[Dict] = None,
) -> Dict:
    """Runs (or resumes) training. Returns summary metrics, the final
    params and optimizer state, and each step's seconds (``step_s``)."""
    start_step = 0
    latest = ckpt.latest_step(cfg.ckpt_dir)
    if latest is not None:
        device = tree_device(params)
        (params, opt_state), _ = ckpt.restore(
            cfg.ckpt_dir, (params, opt_state), step=latest, device=device)
        start_step = latest
        print(f"[loop] resumed from step {latest}", flush=True)

    losses: List[float] = []
    step_times: List[float] = []
    stragglers = 0
    pending = None
    for step in range(start_step, cfg.total_steps):
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = next_batch(step)
        params, opt_state, loss, metrics = train_step(params, opt_state, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        step_times.append(dt)
        losses.append(loss)
        med = float(np.median(step_times[-50:]))
        if len(step_times) > 5 and dt > cfg.deadline_factor * med:
            stragglers += 1
            print(f"[watchdog] step {step} took {dt:.2f}s (median {med:.2f}s)",
                  flush=True)
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            if cfg.async_ckpt:
                if pending is not None:
                    pending.join()
                pending = ckpt.save_async(
                    cfg.ckpt_dir, step + 1, (params, opt_state),
                    metadata=metadata or {}, keep_last=cfg.keep_last,
                )
            else:
                ckpt.save(cfg.ckpt_dir, step + 1, (params, opt_state),
                          metadata=metadata, keep_last=cfg.keep_last)
        if (step + 1) % cfg.log_every == 0:
            print(
                f"[loop] step {step+1}/{cfg.total_steps} "
                f"loss {loss:.4f} ({dt*1e3:.0f} ms/step)",
                flush=True,
            )
    if pending is not None:
        pending.join()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "median_step_s": float(np.median(step_times)) if step_times else 0.0,
        "step_s": step_times,
        "stragglers": stragglers,
        "params": params,
        "opt_state": opt_state,
    }
