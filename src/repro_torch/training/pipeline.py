"""GPipe fill-drain pipeline schedule (the reference's
`training/pipeline.py`), on one device.

The reference runs the stages on a mesh axis (`shard_map` + `ppermute`):
T = n_micro + n_stages - 1 ticks; at tick t stage s processes
microbatch t - s and hands its activation to stage s + 1.  On one card
`pipeline_apply` walks the same ticks over one device: its result is the
sequential run (`reference_apply`), which is the reference's own
correctness contract.  It takes no mesh.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree as _tree


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage(stage_params, s: int):
    return _tree.map(lambda a: a[s], stage_params)


def pipeline_apply(layer_fn: Callable, stage_params, x_micro):
    """layer_fn(params_slice, x) -> x; stage_params: a tree whose leaves
    have a leading n_stages axis; x_micro: (n_micro, mb, ...).  Returns
    (n_micro, mb, ...), what the last stage produced."""
    n_stages = _tree.leaves(stage_params)[0].shape[0]
    n_micro = x_micro.shape[0]
    params = [_stage(stage_params, s) for s in range(n_stages)]
    inbox = [None] * n_stages      # the activation each stage receives
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue                       # a bubble
            out = layer_fn(params[s], x_micro[mb] if s == 0 else inbox[s])
            if s == n_stages - 1:
                outs[mb] = out
            else:
                sent[s + 1] = out
        inbox = sent
    return torch.stack(outs)


def reference_apply(layer_fn: Callable, stage_params, x_micro):
    """Oracle: every microbatch through all stages in order."""
    n_stages = _tree.leaves(stage_params)[0].shape[0]
    outs = []
    for x in x_micro:
        for s in range(n_stages):
            x = layer_fn(_stage(stage_params, s), x)
        outs.append(x)
    return torch.stack(outs)
