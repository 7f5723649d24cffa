"""The guard of a CUDA kernel that has no backward yet.

A kernel launched through ctypes writes into a tensor that autograd
knows nothing of: its output has no `grad_fn`, so a loss computed from
it would give the kernel's inputs no gradient and raise nothing.  A
wrapper whose kernel has no backward calls `refuse_grad` before it
launches: while autograd records (grad mode on), an input that requires
a gradient raises instead.

Flash attention and the SSD scan have backward kernels behind their
autograd functions (`FlashAttention`, `SSDScan`).  The day scan
(`day_scan._day_scan_cuda`) is the one kernel that still lacks a
backward and calls this guard.
"""
from __future__ import annotations

import torch


def _tensors(items):
    for x in items:
        if isinstance(x, dict):
            yield from _tensors(x.values())
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)
        elif isinstance(x, torch.Tensor):
            yield x


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise if autograd would need the gradient of `kernel` through any
    of `inputs` (tensors, or dicts / lists / tuples of them)."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in _tensors(inputs)):
        raise RuntimeError(
            f"{kernel}: an input requires a gradient, and the CUDA kernel "
            f"has no backward yet (its output would carry none); run this "
            f"call under torch.no_grad(), or on the CPU, where the plain "
            f"version is differentiable.  ROADMAP.md lists the backward "
            f"kernels still to write")
