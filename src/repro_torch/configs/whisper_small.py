"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 — enc-dec; conv/audio frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356;
unverified]"""
import dataclasses
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    encdec=EncDecConfig(n_enc_layers=12, n_dec_layers=12, enc_seq_divisor=2),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=512, head_dim=32,
    encdec=EncDecConfig(n_enc_layers=2, n_dec_layers=2, enc_seq_divisor=2),
)
