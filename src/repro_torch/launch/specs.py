"""Input stand-ins per (arch x shape) as meta tensors (the reference's
`launch/specs.py`).

Nothing here allocates: every spec is a `torch.empty(..., device="meta")`
tensor with the reference's shape and dtype.  The reference's sharding
specs say which part of each input a device holds; on one card it holds
all of it, so `batch_specs`, `cache_specs` and `token_spec` give the whole
shapes (what the reference's shardings give over a 1 x 1 mesh).  They
take no `env`, as the port's models take none.
"""
from __future__ import annotations

import torch

from .. import tree as _tree

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_struct(cfg, model) -> dict:
    """Parameter tree as meta tensors (no draws, no allocation)."""
    with META:
        return model.init(torch.Generator().manual_seed(0), cfg, META)


def _side_inputs(cfg, B: int) -> dict:
    out = {}
    if cfg.family == "encdec":
        out["frames"] = _meta((B, cfg.audio_frames, cfg.d_model),
                              torch.bfloat16)
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((B, cfg.vision_tokens,
                                      cfg.vision_embed_dim), torch.bfloat16)
    return out


def input_specs(cfg, shape, model=None) -> dict:
    """Model inputs as meta tensors for the given shape."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        return {"batch": {"tokens": _meta((B, S), i32),
                          "labels": _meta((B, S), i32),
                          **_side_inputs(cfg, B)}}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, S), i32), **_side_inputs(cfg, B)}
    # decode: one new token against a KV/state cache of length S
    if model is None:
        raise ValueError("decode specs need the model (for its cache)")
    with META:
        cache = model.init_cache(cfg, B, S, torch.bfloat16, META)
    return {"token": _meta((B,), i32), "cache": cache,
            "cur_len": _meta((), i32)}


def batch_specs(cfg, shape) -> dict:
    """What the card holds of the train / prefill inputs: all of them."""
    return input_specs(cfg, shape)


def cache_specs(cfg, shape, cache_struct) -> dict:
    """What the card holds of a decode cache: every leaf whole."""
    return _tree.map(lambda a: _meta(a.shape, a.dtype), cache_struct)


def token_spec(shape) -> torch.Tensor:
    """What the card holds of the decode tokens: all B of them."""
    return _meta((shape.global_batch,), torch.int32)
