"""Input shape cells and their meta-device stand-ins for the dry run (port
of ``repro/launch/specs.py``).

The four assigned cells per LM arch:
  train_4k     seq=4096   global_batch=256  -> train_step
  prefill_32k  seq=32768  global_batch=32   -> prefill (forward, no grad)
  decode_32k   seq=32768  global_batch=128  -> serve_step (1 new token,
                                               KV/recurrent cache at 32k)
  long_500k    seq=524288 global_batch=1    -> serve_step; ONLY for
               sub-quadratic archs (recurrentgemma, rwkv6); full-attention
               archs skip by design.

Modality frontends are stubs: llava gets pre-projected patch embeddings,
whisper gets precomputed frame embeddings (enc_len = seq//2, dec = seq//2).
Where the reference returns ``jax.ShapeDtypeStruct``s, these are tensors
on the ``meta`` device: shapes and dtypes, no memory.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import abstract_cache

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, (
            "skipped by design: full attention is O(S^2) at S=524288 "
            "(KV + score memory infeasible); run only for SSM/hybrid archs"
        )
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """Meta stand-ins for every model input of the cell. For decode cells
    this includes the cache (``abstract_cache``)."""
    info = SHAPES[shape]
    s, b, kind = info["seq"], info["batch"], info["kind"]
    i32 = torch.int32
    cd = getattr(torch, cfg.compute_dtype)

    if kind in ("train", "prefill"):
        if cfg.encdec is not None:
            div = cfg.encdec.enc_seq_divisor
            enc = s // div
            dec = s - enc
            return {
                "enc_frames": _meta((b, enc, cfg.d_model), cd),
                "dec_tokens": _meta((b, dec), i32),
            }
        batch = {}
        if cfg.vlm is not None:
            p = cfg.vlm.n_image_tokens
            batch["image_embeds"] = _meta((b, p, cfg.d_model), cd)
            batch["tokens"] = _meta((b, s - p), i32)
        else:
            batch["tokens"] = _meta((b, s), i32)
        return batch

    # decode: one new token + cache of length s
    batch = {"tokens": _meta((b, 1), i32)}
    cache = abstract_cache(cfg, b, s)
    return {"batch": batch, "cache": cache}
