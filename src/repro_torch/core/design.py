"""Forward halves of the design core's discrete relaxations.

The reference package's day scan compares throttle states through
straight-through estimators and indexes level tables with a float
level.  Their FORWARD values are exact: `ste_gt`/`ste_lt` forward the
hard 0/1 comparison, and `take_linear` at an integer level returns the
table entry (`a * 1 + b * 0`).  The port runs forward only, so these are
plain tensor functions; the surrogate gradients belong to the gradient
path, which the port does not carry yet.
"""
from __future__ import annotations

import torch


def ste_gt(x, thresh):
    """Forward of the straight-through `x > thresh`: 0.0 / 1.0."""
    return (x > thresh).to(x.dtype)


def ste_lt(x, thresh):
    """Forward of the straight-through `x < thresh`: 0.0 / 1.0."""
    return (x < thresh).to(x.dtype)


def take_linear(table, idx_f):
    """Index the last axis of `table` at float position `idx_f`:
    exact lookup at integer positions, linear between them."""
    n = table.shape[-1]
    l0 = torch.clamp(torch.floor(idx_f), 0, n - 1)
    frac = idx_f - l0
    i0 = l0.long()
    i1 = torch.clamp_max(i0 + 1, n - 1)
    return (torch.gather(table, -1, i0.unsqueeze(-1)).squeeze(-1)
            * (1.0 - frac)
            + torch.gather(table, -1, i1.unsqueeze(-1)).squeeze(-1) * frac)
