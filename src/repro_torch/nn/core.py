"""Minimal functional NN substrate (the reference's `nn/core.py`).

Parameters are plain nested dicts of tensors with the reference's names
and layouts, so a parameter tree crosses between the packages leaf by
leaf.  Initializers take an explicit `torch.Generator` (on the device the
tensors are made on) and a `device` that defaults to ``"cuda"``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import device as _device

# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, tree):
        """Every tensor of a nested dict in `compute_dtype`."""
        if isinstance(tree, dict):
            return {k: self.cast(v) for k, v in tree.items()}
        return tree.to(self.compute_dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def trunc_normal(gen: torch.Generator, shape, dtype, stddev: float,
                 device="cuda") -> torch.Tensor:
    """Normal(0, stddev) truncated at two standard deviations."""
    x = torch.empty(shape, dtype=torch.float32,
                    device=_device.resolve(device))
    torch.nn.init.trunc_normal_(x, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                generator=gen)
    return x.to(dtype)


def dense_init(gen, shape, dtype, fan_in: int | None = None,
               device="cuda"):
    """LeCun-normal style init over the contracting dimension."""
    if fan_in is None:
        fan_in = shape[0]
    return trunc_normal(gen, shape, dtype, 1.0 / math.sqrt(max(fan_in, 1)),
                        device)


def embed_init(gen, shape, dtype, device="cuda"):
    return trunc_normal(gen, shape, dtype, 1.0, device)


def rmsnorm_init(dim: int, dtype, device="cuda") -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=_device.resolve(device))}


def mlp_init(gen, d_model: int, d_ff: int, dtype, device="cuda") -> dict:
    return {"wi": dense_init(gen, (d_model, d_ff), dtype, device=device),
            "wo": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff,
                             device=device),
            "wg": dense_init(gen, (d_model, d_ff), dtype, device=device)}


def embed_init_params(gen, vocab: int, d_model: int, dtype,
                      device="cuda") -> dict:
    return {"table": embed_init(gen, (vocab, d_model), dtype, device)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm_apply(params: dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, returned in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def nonparametric_layernorm(x: torch.Tensor,
                            eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style LayerNorm without learnable scale/bias
    [arXiv:2402.00838], in float32; the population variance, as
    `jnp.var` takes it (torch's default would be the unbiased one)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def norm_init(kind: str, dim: int, dtype, device="cuda") -> dict:
    if kind == "nonparametric_ln":
        return {}
    return rmsnorm_init(dim, dtype, device)


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "nonparametric_ln":
        return nonparametric_layernorm(x)
    return rmsnorm_apply(params, x)


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: ``silu(x @ wg) * (x @ wi) @ wo``."""
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = F.silu(x @ params["wg"].to(x.dtype)) * h
    else:
        h = F.silu(h)
    return h @ params["wo"].to(x.dtype)


def embed_apply(params: dict, tokens: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def unembed_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: h @ table.T."""
    return h @ table.to(h.dtype).T


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_params(params: dict) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))
