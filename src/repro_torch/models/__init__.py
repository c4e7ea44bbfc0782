"""The LM substrate (port of ``repro/models``): the dense, VLM and MoE
families' forward and decode paths (GQA or MLA attention, a SwiGLU MLP or
an MoE layer), the parameter descriptors of all ten architectures, random
init and the conversion of a numpy parameter tree."""
from repro_torch.models.attention import MLACache, mla
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.init import init_params, param_descriptors
from repro_torch.models.moe import (
    moe_dense,
    moe_dense_chunked,
    moe_layer,
    moe_ragged,
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
    "moe_layer",
    "moe_dense",
    "moe_dense_chunked",
    "moe_ragged",
]
