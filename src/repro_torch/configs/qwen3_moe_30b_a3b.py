"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  dispatch="dense_chunked"),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, head_dim=32,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)
