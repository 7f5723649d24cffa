"""AdamW + global-norm clipping + warmup-cosine schedule (the reference's
`training/optimizer.py`).

The optimizer state mirrors the parameter tree: float32 moments `m` and
`v` and an int32 step `count`.  Every constant enters the arithmetic as
a float32 tensor, as the reference's weakly typed Python floats do under
jax's float32 default, and the step count is float32 where it is used.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import tree as _tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `lr` over `warmup_steps`, then a cosine down to
    `min_lr_ratio` x `lr` at `total_steps`."""
    step = step.to(torch.float32)
    warm = step / _f32(max(cfg.warmup_steps, 1), step)
    prog = (step - _f32(cfg.warmup_steps, step)) / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), step)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = _f32(cfg.min_lr_ratio, step) + _f32(
        (1 - cfg.min_lr_ratio) * 0.5, step) * (
        _f32(1.0, step) + torch.cos(_f32(math.pi, step) * prog))
    return _f32(cfg.lr, step) * torch.where(
        step < _f32(cfg.warmup_steps, step), warm, cos)


def init(params) -> dict:
    """Zero moments (float32, like each leaf) and a zero int32 count."""
    zeros = _tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
    dev = _tree.leaves(params)[0].device
    return {"m": zeros, "v": _tree.map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (flatten order) of sum(g^2), float32."""
    total = None
    for g in _tree.leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: OptConfig, grads, state: dict, params):
    """One AdamW step; returns (new_params, new_state, metrics) with
    metrics {"grad_norm", "lr"}."""
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), _f32(cfg.clip_norm, gnorm)
                          / torch.maximum(gnorm, _f32(1e-9, gnorm)))
    count = state["count"] + 1
    lr = schedule(cfg, count)
    c = count.to(torch.float32)
    b1, b2 = _f32(cfg.b1, c), _f32(cfg.b2, c)
    b1c = _f32(1.0, c) - torch.pow(b1, c)
    b2c = _f32(1.0, c) - torch.pow(b2, c)
    one_b1, one_b2 = _f32(1 - cfg.b1, c), _f32(1 - cfg.b2, c)
    eps, wd = _f32(cfg.eps, c), _f32(cfg.weight_decay, c)

    def one(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + one_b1 * g
        v = b2 * v + one_b2 * torch.square(g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        upd = upd + wd * p.float()
        return (p.float() - lr * upd).to(p.dtype), m, v

    flat = [one(*xs) for xs in zip(_tree.leaves(grads),
                                   _tree.leaves(state["m"]),
                                   _tree.leaves(state["v"]),
                                   _tree.leaves(params))]
    new_p = _tree.unflatten(params, [o[0] for o in flat])
    new_m = _tree.unflatten(state["m"], [o[1] for o in flat])
    new_v = _tree.unflatten(state["v"], [o[2] for o in flat])
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
