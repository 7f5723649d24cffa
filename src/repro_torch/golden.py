"""Holding a language model's logits to reference logits: a golden file
written from the reference (`data/golden_*.json`), or the float32
forward that a served token's logits must reproduce.

Under the tied embedding each row's top-1 logit is the row's own last
token and dwarfs the others (zamba2-1.2b ~550 against ~170, gemma3-4b
~2234 against ~206), whatever the layers do, so top-1 ids catch nothing.
The other logits are held to a multiple of their spread (`spread`).
Where the top-1 is so large that its float32 rounding, which scales with
its own size, passes that absolute tolerance (gemma3-4b's, under its
sqrt(D)-scaled embedding), it is held to a relative tolerance of its own
(`top1_apart`; a golden says so with a `top1_rtol` entry).

Each function takes numpy arrays or tensors on any device.
"""
from __future__ import annotations

import torch


def spread(logits) -> float:
    """The smallest over rows of the standard deviation (population) of a
    row's logits (..., V) with its top-1 left out."""
    logits = torch.as_tensor(logits)
    rows = logits.reshape(-1, logits.shape[-1]).double()
    keep = torch.ones_like(rows, dtype=torch.bool)
    keep[torch.arange(len(rows)), rows.argmax(-1)] = False
    return float(rows[keep].reshape(len(rows), -1)
                 .std(-1, correction=0).min())


def logit_errors(got, want, is_top1, top1_apart: bool) -> tuple:
    """(max abs error of `got` against `want`, max relative error at the
    entries `is_top1` marks, each row's top-1).  With `top1_apart` the
    first leaves those entries out."""
    want = torch.as_tensor(want).double()
    diff = (torch.as_tensor(got, device=want.device).double() - want).abs()
    is_top1 = torch.as_tensor(is_top1, device=want.device)
    rel1 = float((diff[is_top1] / want[is_top1].abs()).max())
    if top1_apart:
        diff = diff.masked_fill(is_top1, 0.0)
    return float(diff.max()), rel1


def golden_errors(logits, golden: dict) -> tuple:
    """`logit_errors` of (B, V) logits at the golden's sampled and top-8
    ids; the top-1 apart when the golden has `top1_rtol`."""
    logits = torch.as_tensor(logits)
    dev = logits.device
    ids = torch.as_tensor(golden["sample_ids"], device=dev)
    top_ids = torch.as_tensor(golden["top8_ids"], device=dev)
    got = torch.cat([logits[:, ids], logits.gather(-1, top_ids)], -1)
    want = torch.cat([torch.as_tensor(golden["logits_at_sample"]),
                      torch.as_tensor(golden["top8_logits"])], -1).to(dev)
    first = torch.zeros_like(top_ids, dtype=torch.bool)
    first[:, 0] = True
    is_top1 = torch.cat([ids[None, :] == top_ids[:, :1], first], -1)
    return logit_errors(got, want, is_top1, "top1_rtol" in golden)


def rank_miss(logits, golden: dict, tol: float):
    """The first (row, rank) of the top-8 whose id is neither the golden's
    nor tied with the golden's logit at that rank within 2 tol, or
    None."""
    logits = torch.as_tensor(logits)
    top_ids = torch.as_tensor(golden["top8_ids"])
    top_vals = torch.as_tensor(golden["top8_logits"], dtype=torch.float64)
    K = top_ids.shape[1]
    order = torch.sort(logits, dim=-1, descending=True,
                       stable=True).indices[:, :K]
    vals = logits.gather(-1, order).double().cpu()
    order = order.cpu()
    for r in range(len(order)):
        for k in range(K):
            if order[r, k] != top_ids[r, k] and \
                    abs(vals[r, k] - top_vals[r, k]) > 2 * tol:
                return r, k
    return None
