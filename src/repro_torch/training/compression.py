"""int8 gradient compression with error feedback (the reference's
`training/compression.py`).

Each leaf is quantised to int8 with a per-leaf scale (its largest
magnitude over 127, at least 1e-12 / 127), rounded half to even (as
`jnp.round` and `torch.round` both do) and clipped to +-127; the
quantisation residual is fed back into the next step's gradient.  On one
card there is no all-reduce for the int8 values to shrink: the transform
keeps the reference's numbers, what every worker would reconstruct.
"""
from __future__ import annotations

import torch

from .. import tree as _tree


def init_error_state(params):
    return _tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)


def quantize_leaf(g: torch.Tensor):
    """(int8 values, float32 scale) of a float32 leaf."""
    # a tensor divisor: CUDA takes `tensor / number` as a reciprocal product
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, error):
    """Returns (the decompressed gradients, the new error state)."""
    def one(g, e):
        g32 = g.float() + e
        q, scale = quantize_leaf(g32)
        deq = dequantize_leaf(q, scale)
        return deq, g32 - deq

    flat = [one(g, e) for g, e in zip(_tree.leaves(grads),
                                      _tree.leaves(error))]
    return (_tree.unflatten(grads, [o[0] for o in flat]),
            _tree.unflatten(error, [o[1] for o in flat]))
