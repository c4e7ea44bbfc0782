"""The LM substrate (port of ``repro/models``): the forward and decode
paths of all ten architectures (GQA or MLA attention, a SwiGLU MLP or an
MoE layer, RG-LRU blocks beside a local-window ring, RWKV-6 blocks, and
the whisper encoder-decoder with cross-attention), their parameter
descriptors, random init and the conversion of a numpy parameter tree."""
from repro_torch.models.attention import MLACache, cross_attention, mla
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.init import init_params, param_descriptors
from repro_torch.models.moe import (
    moe_dense,
    moe_dense_chunked,
    moe_layer,
    moe_ragged,
)
from repro_torch.models.recurrent import (
    RGLRUState,
    RWKVState,
    rglru_block_seq,
    rglru_block_step,
    rwkv_channelmix,
    rwkv_timemix_seq,
)
from repro_torch.models.transformer import (
    DecodeCache,
    compute_params,
    decode_step,
    forward_lm,
    init_cache,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "param_descriptors",
    "params_from_numpy",
    "compute_params",
    "forward_lm",
    "init_cache",
    "decode_step",
    "DecodeCache",
    "mla",
    "MLACache",
    "cross_attention",
    "RGLRUState",
    "RWKVState",
    "rglru_block_seq",
    "rglru_block_step",
    "rwkv_timemix_seq",
    "rwkv_channelmix",
    "moe_layer",
    "moe_dense",
    "moe_dense_chunked",
    "moe_ragged",
]
