"""Model configuration covering all 10 assigned architectures (port of
``repro/models/config.py``).

One dataclass; family-specific sub-configs are optional fields. Configs for
the assigned archs live in repro_torch/configs/<id>.py and are looked up by
``repro_torch.configs.get_config``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared (always-on) experts, deepseek-v2 style
    d_ff_shared: int = 0
    router_dtype: str = "float32"
    capacity_factor: float = 1.25
    dispatch: str = "dense"     # "dense" (one-hot einsum) | "ragged" (ragged_dot)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 = full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block."""

    d_rnn: int = 0               # lru width (0 => d_model)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:rec
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    head_dim: int = 64
    decay_lora: int = 64


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; the conv/audio frontend is a stub
    (input_specs provides precomputed frame embeddings)."""

    n_enc_layers: int = 12
    n_dec_layers: int = 12
    enc_seq_divisor: int = 2     # enc_len = seq // divisor in shape cells


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """LLaVA-NeXT-style stub frontend: anyres patch embeddings are inputs."""

    n_image_tokens: int = 2880   # anyres 2x2 grid + base, pre-projected
    image_token_stride: int = 0  # 0 => image tokens prepended


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_frac: float = 1.0        # phi4 uses partial rotary
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKV6Config] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat policy for train_step: "none" | "block" (save layer inputs)
    remat: str = "block"
    # implementation-level zero-padding of Q heads so the head dim shards on
    # the TP axis (value-preserving: padded wq columns/wo rows are zero).
    # §Perf hillclimb C1. 0 = no padding.
    pad_heads_to: int = 0

    @property
    def n_heads_eff(self) -> int:
        return max(self.n_heads, self.pad_heads_to or 0)

    @property
    def attn_free(self) -> bool:
        return self.rwkv is not None

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (long_500k) is supported by design."""
        return self.rwkv is not None or self.rglru is not None

    def n_params(self) -> int:
        """Analytic parameter count (validated against init in smoke tests)."""
        from repro_torch.models.init import param_descriptors

        desc = param_descriptors(self)
        return int(sum(math.prod(d.shape) for _, d in _items(desc)))

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        from repro_torch.models.init import param_descriptors

        desc = param_descriptors(self)
        total = 0
        for path, d in _items(desc):
            if not hasattr(d, "shape"):
                continue
            n = math.prod(d.shape)
            if path.split("/")[-1].startswith("we"):
                n = n * (self.moe.top_k) // self.moe.n_experts
            total += n
        return int(total)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _items(v, f"{prefix}/{k}")
        return out
    return [(prefix, tree)]
