"""Architecture registry (port of ``repro/configs``): the 10 assigned
configs (+ reduced smoke variants).

``get_config(name)`` returns the full published config; ``smoke_config(name)``
returns a same-family reduced config that runs a forward/decode step on CPU.
The config modules are data: the port keeps its own copies, built on its
own ``ModelConfig``.
"""
from __future__ import annotations

import dataclasses
import importlib

_ARCHS = [
    "llava_next_34b",
    "qwen1_5_110b",
    "granite_20b",
    "phi4_mini_3_8b",
    "deepseek_7b",
    "recurrentgemma_2b",
    "qwen3_moe_30b_a3b",
    "deepseek_v2_236b",
    "rwkv6_1_6b",
    "whisper_small",
]

ALIASES = {a.replace("_", "-"): a for a in _ARCHS}
ARCH_IDS = [a.replace("_", "-") for a in _ARCHS]


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}")


def get_config(name: str):
    return _module(name).CONFIG


def smoke_config(name: str):
    return _module(name).SMOKE


def _shrink(cfg, **overrides):
    """Build a reduced same-family config (helper used by config modules)."""
    return dataclasses.replace(cfg, **overrides)
