"""Mamba2 SSD chunked scan from a zero state, returning y only.

`ssd_scan(x, dt, A, B, C, *, chunk)` is the dispatch.  Tensors on the CPU
go to `ssd_scan_plain`, the reference's `ssd_chunked` (`nn.ssd`), which
pads a ragged tail with dt = 0.  Tensors on a CUDA device go to the
hand-written kernel `csrc/ssd_scan.cu` or raise: there is no fallback
from the card to the plain version.  The kernel takes a ragged sequence
length too (it reads the tail as dt = 0), unlike the Pallas launcher's
``assert s % cl == 0``: mamba layers call the scan at any prompt length.

The kernel replaces `src/repro/kernels/ssd_scan.py:_ssd_kernel`: one
thread block per (batch, head) walks the chunks in order with the
(P, N) float32 state in shared memory.  At the zamba2-1.2b prefill shape
(b = 2, s = 4096, h = 64, p = 64, n = 64) it is bound by bytes; b * h =
128 blocks is under one wave of the 132 SMs.  See the source's header
note.

Shapes: x (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
(b, s, g, n) with x's dtype (float32 or bfloat16); y (b, s, h, p) in x's
dtype.  On the card: chunk 64, p 64, n 64 or 128.  `LAUNCHES` counts
kernel launches (the plain version never bumps it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import ssd as _ssd

CHUNKS = (64,)              # chunk lengths the kernel takes
HEAD_DIMS = (64,)           # p
STATE_DIMS = (64, 128)      # n
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0                # kernel launches in this process


def _check(x, dt, A, B, C) -> None:
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"want x (b,s,h,p), B/C (b,s,g,n); got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (b, s) or h % B.shape[2]:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit x {tuple(x.shape)}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x/B/C of one "
                         f"dtype; got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32; got {dt.dtype}, "
                         f"{A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ssd_scan(x, dt, A, B, C, *, chunk=64):
    """x:(b,s,h,p) dt:(b,s,h) A:(h,) B/C:(b,s,g,n) -> y:(b,s,h,p).  The
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "cuda":
        return _ssd_cuda(x, dt, A, B, C, chunk=chunk)
    raise ValueError(f"ssd_scan runs on cpu or cuda tensors, got {x.device}")


def ssd_scan_plain(x, dt, A, B, C, *, chunk=64):
    """The plain PyTorch version: `ssd_chunked` from a zero state, y only."""
    return _ssd.ssd_chunked(x, dt, A, B, C, chunk=chunk)[0]


@functools.lru_cache(maxsize=1)
def _lib():
    from . import build
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ssd_cuda(x, dt, A, B, C, *, chunk=64):
    """Launch csrc/ssd_scan.cu on the current stream (no sync)."""
    global LAUNCHES
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if chunk not in CHUNKS or p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel takes chunk in {CHUNKS}, p in "
                         f"{HEAD_DIMS}, n in {STATE_DIMS}; got chunk={chunk}"
                         f", p={p}, n={n}")
    # the kernel reads dense row-major tiles; the model's x/B/C are views
    # into the conv output, so this copies them
    ins = [t.contiguous() for t in (x, dt, A, B, C)]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fn = _lib()
    # `ins` may hold copies freed when this returns while the kernel still
    # runs: the caching allocator hands their memory only to later work on
    # the same stream
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ins], y.data_ptr(), b, s, h, p, g,
                 n, chunk, DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
