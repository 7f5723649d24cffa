"""Mixture-of-Experts substrate (the reference's `nn/moe.py`, one card).

``moe_apply_dense`` is the reference's oracle: every expert runs on every
token and the outputs combine with the top-k weights.  ``moe_apply``
computes the same function the way a card should: the (token, slot)
pairs are sorted by expert with a stable sort (their rows come from
``_dispatch_indices``, as in the reference's dispatch), each expert
runs its ``wi`` / ``wg`` / ``wo`` products once over its own rows, and
the top-p-weighted outputs are summed in float32 over the k slots in
rank order (the reference's sharded combine).  No token is dropped: the reference's single-device
model takes the dense oracle, which has no capacity, so the port's model
takes ``moe_apply`` with none either (``capacity_factor`` is read only by
the reference's mesh path, ``moe_apply_sharded``, which the port does not
have).  The expert products stay `torch.matmul`: the reference computes
them as einsums outside any Pallas kernel.

Routing follows ``lax.top_k``: ties go to the lower expert id
(``_route`` takes the first k of a stable descending sort; `torch.topk`
promises no order among ties).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .core import dense_init


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, dtype,
             device="cuda") -> dict:
    """The router stays float32 whatever `dtype`, as in the reference."""
    return {
        "router": dense_init(gen, (d_model, n_experts), torch.float32,
                             device=device),
        "wi": dense_init(gen, (n_experts, d_model, d_ff), dtype,
                         fan_in=d_model, device=device),
        "wg": dense_init(gen, (n_experts, d_model, d_ff), dtype,
                         fan_in=d_model, device=device),
        "wo": dense_init(gen, (n_experts, d_ff, d_model), dtype,
                         fan_in=d_ff, device=device),
    }


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x_flat: (T, D) -> probs (T, k) f32, idx (T, k) int64, full probs
    (T, E).  Ties go to the lower expert id, as in `lax.top_k`."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss [arXiv:2101.03961]: E * <f_e> . <p_e>."""
    T, k = top_i.shape
    f = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    f = f.index_add(0, top_i.reshape(-1),
                    torch.ones(T * k, dtype=torch.float32,
                               device=probs.device)) / (T * k)
    return n_experts * torch.sum(f * probs.mean(dim=0))


def moe_apply_dense(params: dict, x: torch.Tensor, top_k: int):
    """Oracle: run every expert on every token, combine with top-k
    weights.  x: (B, S, D) -> (y (B, S, D) in x's dtype, aux)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    xf = x.reshape(-1, D)
    top_p, top_i, probs = _route(xf, params["router"], top_k)
    dt = x.dtype
    h = torch.einsum("td,edf->tef", xf, params["wi"].to(dt))
    g = torch.einsum("td,edf->tef", xf, params["wg"].to(dt))
    out_e = torch.einsum("tef,efd->ted", F.silu(g) * h,
                         params["wo"].to(dt))                     # (T,E,D)
    onehot = F.one_hot(top_i, E).float()                          # (T,k,E)
    w_full = torch.einsum("tk,tke->te", top_p, onehot)
    y = torch.einsum("te,ted->td", w_full, out_e.float())
    aux = load_balance_loss(probs, top_i, E)
    return y.reshape(B, S, D).to(dt), aux


def _dispatch_indices(top_i: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Sort-based positions.  top_i: (T, k) -> each pair's position among
    its expert's pairs (T, k), in (token, slot) order.  `capacity` is the
    reference's argument; positions are not clamped to it."""
    T, k = top_i.shape
    flat = top_i.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(T * k, device=flat.device)
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    return (ranks - starts[flat]).reshape(T, k)


def moe_apply(params: dict, x: torch.Tensor, top_k: int):
    """`moe_apply_dense`'s function with each expert run on its own rows
    only: x (B, S, D) -> (y (B, S, D) in x's dtype, aux).  One host sync
    (the per-expert row counts)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    top_p, top_i, probs = _route(xf, params["router"], top_k)
    dt = x.dtype
    flat = top_i.reshape(-1)                      # pair t * k + j
    counts = torch.bincount(flat, minlength=E)
    # each pair's row among the pairs sorted stably by expert
    slot = (_dispatch_indices(top_i, E, T * top_k).reshape(-1)
            + (torch.cumsum(counts, 0) - counts)[flat])
    rows = torch.empty((T * top_k, D), dtype=dt, device=x.device)
    rows[slot] = xf.repeat_interleave(top_k, dim=0)
    out = torch.empty_like(rows)
    start = 0
    # repro: ignore[R002]: the documented host sync of a MoE layer: the
    # per-expert row counts size each expert's product
    for e, n in enumerate(counts.tolist()):
        if n:
            r = rows[start:start + n]
            h = r @ params["wi"][e].to(dt)
            g = r @ params["wg"][e].to(dt)
            out[start:start + n] = (F.silu(g) * h) @ params["wo"][e].to(dt)
            start += n
    pairs = out[slot].reshape(T, top_k, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        y = y + pairs[:, j].float() * top_p[:, j:j + 1]
    aux = load_balance_loss(probs, top_i, E)
    return y.reshape(B, S, D).to(dt), aux
