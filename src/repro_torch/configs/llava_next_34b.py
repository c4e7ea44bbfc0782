"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling (vision frontend stubbed: input_specs provides
pre-projected patch embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified — backbone config per assignment]"""
import dataclasses
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    vlm=VLMConfig(n_image_tokens=2880),
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    head_dim=32,
    vlm=VLMConfig(n_image_tokens=16),
)
