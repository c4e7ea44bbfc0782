"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig, RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # d_model / rwkv head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    rwkv=RWKV6Config(head_dim=64, decay_lora=64),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
    vocab=512, head_dim=64,
    rwkv=RWKV6Config(head_dim=64, decay_lora=16),
)
