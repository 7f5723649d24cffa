"""Blocked online-softmax attention: causal, sliding-window or
bidirectional, grouped-query, in the reference's (B, S, H, Dh) layout.

`flash_attention(q, k, v, *, causal, window, scale)` is the dispatch.
Tensors on the CPU go to `flash_attention_plain`, which picks between
`nn.attention.sdpa` (S <= 2048) and `nn.attention.chunked_attention`
(longer), the switch the reference's model makes.  Tensors on a CUDA
device go to the hand-written kernel `csrc/flash_attention.cu` or raise:
there is no fallback from the card to the plain version.

The kernel replaces `src/repro/kernels/flash_attention.py:_flash_kernel`.
At the zamba2-1.2b prefill shape (B = 2, S = 4096, H = 32, Dh = 64,
causal, bf16) it is bound by operations (~137 GFLOP of products against
~134 MB of traffic).  In bf16 both products run on the tensor cores
(mma.sync m16n8k16, FlashAttention-2's register layout: 128 query rows a
block, 64-key tiles double-buffered by cp.async, P kept in registers);
in float32 they run on the CUDA cores (64 x 64 tiles), since TF32 would
miss the float32 tolerance.  `TILES` gives each path's (query rows, keys)
per tile, the tiling on which the plain version keeps the kernel's
running max.  See the source's header note.

Inputs: float32 or bfloat16, all three alike, contiguous; Dh 64, 96, 128
or 256 on the card (phi-3-vision's heads are 96 wide, gemma3's 256).
The output has q's dtype.  `LAUNCHES` counts kernel launches (the plain
version never bumps it).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..nn import attention as _attn

HEAD_DIMS = (64, 96, 128, 256)   # head widths the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query rows, keys) of the kernel's tiles, by dtype: F32_BQ / F32_BK and
# BF_BQ / BF_BK in csrc/flash_attention.cu
TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 64)}

LAUNCHES = 0                # kernel launches in this process


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,Dh), k/v (B,Sk,KvH,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise ValueError(f"flash_attention takes float32 or bfloat16 "
                             f"q/k/v of one dtype; {name} is {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention needs contiguous inputs; "
                             f"{name} is not")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,Sq,H,Dh); k/v: (B,Sk,KvH,Dh) -> (B,Sq,H,Dh).  The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal=causal, window=window,
                           scale=scale)
    raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                     f"{q.device}")


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """The plain PyTorch version, on whatever device the tensors are on:
    `sdpa` up to 2048 query rows, `chunked_attention` beyond (the
    reference model's switch); no mask when neither causal nor windowed."""
    bidirectional = not causal and window is None
    fn = _attn.chunked_attention if q.shape[1] > 2048 else _attn.sdpa
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              bidirectional=bidirectional)


@functools.lru_cache(maxsize=1)
def _lib():
    from . import build
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_cuda(q, k, v, *, causal=True, window=None, scale=None):
    """Launch csrc/flash_attention.cu on the current stream (no sync)."""
    global LAUNCHES
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes Dh in {HEAD_DIMS}, "
                         f"got {Dh}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    # the bf16 kernel copies 16-byte rows with cp.async: a view that starts
    # off that alignment is copied first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KvH, Dh, int(bool(causal)),
                 -1 if window is None else int(window), float(scale),
                 DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
