"""Minimal functional NN substrate (the reference's `nn/core.py`).

Parameters are plain nested dicts of tensors with the reference's names
and layouts, so a parameter tree crosses between the packages leaf by
leaf.  Initializers take an explicit `torch.Generator` and a `device`
that defaults to ``"cuda"``.  The generator lies on the CPU whatever
`device` says: every draw is made there and the result moved, so one
seed gives bit-equal weights on the CPU and the card (a generator on
another device raises `ValueError`).
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


def host_generator(gen: torch.Generator) -> torch.Generator:
    """`gen`, which must be a CPU generator: initializers draw on the
    host and move the result, so the weights do not depend on the
    device they are made for."""
    if gen.device.type != "cpu":
        raise ValueError(f"initializers draw on a CPU torch.Generator and "
                         f"move the result to the device; got a generator "
                         f"on {gen.device} (use torch.Generator()"
                         f".manual_seed(seed))")
    return gen


def trunc_normal(gen: torch.Generator, shape, dtype, stddev: float,
                 device="cuda") -> torch.Tensor:
    """Normal(0, stddev) truncated at two standard deviations, drawn on
    the CPU from `gen`, rounded to `dtype` there and moved to `device`."""
    device = _device.resolve(device)
    x = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                                generator=host_generator(gen))
    return x.to(dtype).to(device)


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


def mlp_init(gen, d_model: int, d_ff: int, dtype, gated: bool = True,
             device="cuda") -> dict:
    """`wi`, `wo` and, when `gated`, the gate `wg` (the reference's
    names)."""
    p = {"wi": dense_init(gen, (d_model, d_ff), dtype, device=device),
         "wo": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff,
                          device=device)}
    if gated:
        p["wg"] = dense_init(gen, (d_model, d_ff), dtype, device=device)
    return p


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


# the reference's activations: jax.nn.gelu defaults to the tanh
# approximation, torch's gelu to the exact erf
ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "relu": F.relu}


def mlp_apply(params: dict, x: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    """Gated MLP ``act(x @ wg) * (x @ wi) @ wo``, or without a gate
    ``act(x @ wi) @ wo``; `activation` is "silu", "gelu" (tanh
    approximation) or "relu"."""
    act = ACTIVATIONS[activation]
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = act(x @ params["wg"].to(x.dtype)) * h
    else:
        h = act(h)
    return h @ params["wo"].to(x.dtype)


def embed_apply(params: dict, tokens: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


def unembed_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: h @ table.T."""
    return h @ table.to(h.dtype).T


def chunked_softmax_xent(table: torch.Tensor, h: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor | None = None,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of the tied unembedding over (B, S) positions
    without holding (B, S, V) logits at once: per sequence chunk, the
    (B, chunk, V) logits in float32, their log-sum-exp minus the gold
    logit, masked and summed; over max(sum(mask), 1)."""
    B, S, D = h.shape
    assert S % chunk == 0, (S, chunk)
    n = S // chunk
    hs = h.reshape(B, n, chunk, D).transpose(0, 1)            # (n, B, c, D)
    ls = labels.reshape(B, n, chunk).transpose(0, 1).long()   # (n, B, c)
    if mask is None:
        ms = torch.ones((n, B, chunk), dtype=torch.float32, device=h.device)
    else:
        ms = mask.reshape(B, n, chunk).transpose(0, 1).float()
    w = table.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        logits = (hs[i] @ w.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ls[i][..., None])[..., 0]
        total = total + ((lse - gold) * ms[i]).sum()
    return total / torch.clamp(ms.sum(), min=1.0)


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
