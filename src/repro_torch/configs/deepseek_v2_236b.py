"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
import dataclasses
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # dense-equivalent width for the (unused) dense path
    vocab=102400,
    head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  dispatch="dense_chunked"),
    # 236B on a 256x16GB pod: f32 weights+grads+Adam = 3.8TB of the 4TB HBM
    # budget; bf16 weight storage (f32 optimizer moments) is how the model
    # was trained and what fits.
    param_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=512, head_dim=32,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2),
)
