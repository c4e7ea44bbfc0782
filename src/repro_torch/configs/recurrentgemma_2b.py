"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent (pattern
rec,rec,attn; 26L -> 26 not divisible by 3, published model uses 26 blocks
with the final pattern truncated; we round the scan to 27 logical layers of
which the last group's attn is real — see configs note). Here: 24L pattern
(rec,rec,attn) x 8 + 2 trailing rec handled by using pattern length 13
(rec,rec,attn repeated 4x + rec) — for scan uniformity we use 26 = 13 x 2:
pattern of 13 blocks scanned twice. [arXiv:2402.19427; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig, RGLRUConfig

_PATTERN = ("rec", "rec", "attn") * 4 + ("rec",)  # 13 blocks, scanned twice

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rglru=RGLRUConfig(d_rnn=2560, conv_width=4, block_pattern=_PATTERN,
                      attn_window=2048),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=128, n_heads=2, n_kv_heads=1, d_ff=256,
    vocab=512, head_dim=64,
    rglru=RGLRUConfig(d_rnn=128, conv_width=4,
                      block_pattern=("rec", "rec", "attn"), attn_window=64),
)
