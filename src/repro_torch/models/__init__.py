"""The LM substrate (port of ``repro/models``): the forward, loss and
decode paths of all ten architectures (GQA or MLA attention, a SwiGLU MLP
or an MoE layer, RG-LRU blocks beside a local-window ring, RWKV-6 blocks,
and the whisper encoder-decoder with cross-attention), their parameter
descriptors, random init, the abstract (meta) parameter and cache trees,
and the conversion of a numpy parameter tree and optimizer state."""
from repro_torch.models.attention import MLACache, cross_attention, mla
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.init import (
    abstract_params,
    init_params,
    param_descriptors,
)
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
    abstract_cache,
    compute_params,
    decode_step,
    forward_lm,
    init_cache,
    loss_fn,
)

__all__ = [
    "ModelConfig",
    "init_params",
    "abstract_params",
    "param_descriptors",
    "params_from_numpy",
    "opt_state_from_numpy",
    "compute_params",
    "forward_lm",
    "loss_fn",
    "init_cache",
    "abstract_cache",
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
