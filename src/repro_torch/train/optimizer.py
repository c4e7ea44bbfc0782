"""In-house AdamW with global-norm clipping (port of
``repro/train/optimizer.py``).

The optimizer state mirrors the parameter tree (m and v in float32) beside
an int32 step. The arithmetic is the reference's, in float32 as JAX does
it: the step, ``b1 ** step``, the warmup division and the cosine are
float32 tensors on the parameters' device, never Python doubles, and the
global norm sums the leaves in JAX's order (dict keys sorted). The update
is functional: it returns new tensors and writes none of its inputs (about
fifteen eager passes over each leaf; ``PERF.md`` §7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.init import flatten_tree, tree_device, unflatten_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # int32, 0-d


def _map(fn, tree):
    return unflatten_tree([(path, fn(leaf))
                           for path, leaf in flatten_tree(tree)])


def init_opt_state(params) -> OptState:
    """Zero m and v (float32, each leaf's shape and device) and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(m=_map(zeros, params), v=_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=tree_device(params)))


def abstract_opt_state(abstract_params) -> OptState:
    """``init_opt_state``'s tree on the meta device (no memory)."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return OptState(m=_map(f32, abstract_params),
                    v=_map(f32, abstract_params),
                    step=torch.empty((), dtype=torch.int32, device="meta"))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; ``step`` is a
    float32 tensor and so is the result."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in JAX's order."""
    return torch.sqrt(sum((leaf.float() ** 2).sum()
                          for _, leaf in flatten_tree(tree)))


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); inputs are not written."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = cfg.grad_clip / (gnorm + 1e-9)
    scale = torch.minimum(torch.ones_like(clip), clip)
    stepf = step.float()
    lr = _schedule(cfg, stepf)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    paths = [path for path, _ in flatten_tree(params)]
    leaves = [[leaf for _, leaf in flatten_tree(t)]
              for t in (params, grads, state.m, state.v)]
    out = [upd(*four) for four in zip(*leaves)]
    new_p, new_m, new_v = (unflatten_tree(list(zip(paths, col)))
                           for col in zip(*out))
    return (new_p, OptState(m=new_m, v=new_v, step=step),
            {"grad_norm": gnorm, "lr": lr})
