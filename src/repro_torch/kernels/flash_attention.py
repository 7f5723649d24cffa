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
The output has q's dtype.  `LAUNCHES` counts forward kernel launches
(the plain version never bumps it).

The gradient.  The reference differentiates its attention in XLA,
outside the Pallas kernel; here the forward on the card is the kernel,
so its gradient is a hand-written kernel too
(`csrc/flash_attention_bwd.cu`, FlashAttention-2's recurrence from each
row's log-sum-exp, which the forward kernel writes when asked).  When
autograd needs a gradient (grad mode on and an input requiring one), the
dispatch sends CUDA tensors through `FlashAttention`, an autograd
function whose forward is the kernel with that output and whose backward
is the backward kernel; otherwise it launches the forward alone, as
serving does.  `BWD_LAUNCHES` counts backward calls (two kernels each
in bf16, three in float32).  `flash_attention_lse_plain` and `flash_attention_bwd_plain` are
their plain versions: the latter runs the same recurrence on the
backward kernel's tiles (`BWD_TILES`) and is held to autograd of the
plain forward by the CPU tests.  The backward kernel runs bf16 at every
Dh on the tensor cores (every product a wgmma chain, P and dS rounded to
bf16 once), float32 on the CUDA cores; every sum runs in a fixed order,
so a call repeats bit for bit.
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

# (query rows, keys) of the backward's tiles by dtype and head width: bf16
# 64 x 64 at every width (HB_ROWS in csrc/flash_attention_bwd.cu), float32
# BQ x bwd_bk<DH> (64 x 32 at Dh 256)
BWD_TILES = {torch.bfloat16: {64: (64, 64), 96: (64, 64), 128: (64, 64),
                              256: (64, 64)},
             torch.float32: {64: (64, 64), 96: (64, 64), 128: (64, 64),
                             256: (64, 32)}}

LAUNCHES = 0                # forward kernel launches in this process
BWD_LAUNCHES = 0            # backward kernel calls (two or three launches)


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window, scale)
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


def _scores(q, k, q0, q1, k0, k1, causal, window, scale):
    """Scaled scores of query rows [q0, q1) against keys [k0, k1) in
    float32, (B, KvH, G, q1 - q0, k1 - k0), and the mask (True = seen)."""
    B, _, H, Dh = q.shape
    KvH = k.shape[2]
    qg = q[:, q0:q1].reshape(B, q1 - q0, KvH, H // KvH, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, k0:k1].float()) * scale
    qi = torch.arange(q0, q1, device=q.device)[:, None]
    kj = torch.arange(k0, k1, device=q.device)[None, :]
    ok = torch.ones_like(s[0, 0, 0], dtype=torch.bool)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return s, ok


def flash_attention_lse_plain(q, k, *, causal=True, window=None,
                              scale=None):
    """Each query row's log-sum-exp of its scaled, masked scores, (B, H,
    Sq) float32: what the forward kernel writes for its backward."""
    B, Sq, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    s, ok = _scores(q, k, 0, Sq, 0, k.shape[1], causal, window, scale)
    s = s.masked_fill(~ok, _attn.NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal=True,
                              window=None, scale=None):
    """(dq, dk, dv) of attention from the forward's output `o`, the
    output gradient `do` and the row log-sum-exp `lse` (B, H, Sq), by the
    backward kernel's recurrence on its tiles (`BWD_TILES` of q's dtype;
    (64, 64) at other widths), in float32: delta = rowsum(dO o O);
    per tile P = exp(S scale - lse) (masked entries 0), dV += P^T dO,
    dS = P o (dO V^T - delta), dQ += dS K scale, dK += dS^T Q scale.
    P is rounded to q's dtype before its product and dS before its two,
    as the kernel's bf16 path rounds them once for the tensor cores
    (float32: no rounding); dS itself is formed from the unrounded P.
    Tiles no row of which sees a key are skipped, as the kernel skips
    them.  The gradients have the inputs' dtypes."""
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    bq, bk = BWD_TILES.get(q.dtype, BWD_TILES[torch.float32]) \
        .get(Dh, (64, 64))

    def operand(t):                   # a tensor-core operand's rounding
        return t.to(q.dtype).float()

    dof = do.reshape(B, Sq, KvH, G, Dh).float()
    delta = (dof * o.reshape(B, Sq, KvH, G, Dh).float()).sum(-1) \
        .permute(0, 2, 3, 1)                          # (B, KvH, G, Sq)
    lse = lse.reshape(B, KvH, G, Sq)
    qf, kf, vf = q.float(), k.float(), v.float()
    dq = torch.zeros((B, Sq, KvH, G, Dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Sk, KvH, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        for k0 in range(0, Sk, bk):
            k1 = min(k0 + bk, Sk)
            if (causal and k0 > q1 - 1) or \
                    (window is not None and k1 - 1 <= q0 - window):
                continue
            s, ok = _scores(qf, kf, q0, q1, k0, k1, causal, window, scale)
            p = torch.where(ok, torch.exp(s - lse[..., q0:q1, None]),
                            torch.zeros_like(s))
            d_o = dof[:, q0:q1]
            dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", operand(p),
                                         d_o)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", d_o, vf[:, k0:k1])
            ds = operand(p * (dp - delta[..., q0:q1, None]))
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                         kf[:, k0:k1])
            dk[:, k0:k1] += torch.einsum(
                "bhgqk,bqhgd->bkhd", ds,
                qf[:, q0:q1].reshape(B, q1 - q0, KvH, G, Dh))
    return ((dq * scale).reshape(B, Sq, H, Dh).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


@functools.lru_cache(maxsize=1)
def _lib():
    from . import build
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    from . import build
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_args(q, k, v, window, scale):
    """Shape checks of the CUDA path; returns (q, k, v aligned, scale)."""
    Dh = q.shape[3]
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
    return q, k, v, scale


def _flash_cuda(q, k, v, *, causal=True, window=None, scale=None,
                lse=False):
    """Launch csrc/flash_attention.cu on the current stream (no sync).
    Returns the output, or (output, lse (B, H, Sq) float32) when `lse`."""
    global LAUNCHES
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    q, k, v, scale = _kernel_args(q, k, v, window, scale)
    out = torch.empty_like(q)
    row_lse = torch.empty((B, H, Sq), dtype=torch.float32,
                          device=q.device) if lse else None
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if row_lse is None else row_lse.data_ptr(),
                 B, Sq, Sk, H, KvH, Dh, int(bool(causal)),
                 -1 if window is None else int(window), float(scale),
                 DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return (out, row_lse) if lse else out


def _flash_bwd_cuda(q, k, v, o, do, lse, *, causal=True, window=None,
                    scale=None):
    """Launch csrc/flash_attention_bwd.cu (three kernels in float32, two
    in bf16) on the current stream (no sync); returns (dq, dk, dv) in the
    inputs' dtype."""
    global BWD_LAUNCHES
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    q, k, v, scale = _kernel_args(q, k, v, window, scale)
    if Sq == 0 or B == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Sk, H, KvH, Dh, int(bool(causal)),
                 -1 if window is None else int(window), float(scale),
                 DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its row log-sum-exp, and the backward
    kernel as its gradient.  Saves q, k, v, o and the lse; the backward
    launches on a contiguous dO.  Under activation checkpointing the
    recompute runs (and counts) the forward kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _flash_cuda(q, k, v, causal=causal, window=window,
                             scale=scale, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = _flash_bwd_cuda(q, k, v, o, do.contiguous(), lse,
                                     causal=causal, window=window,
                                     scale=scale)
        return dq, dk, dv, None, None, None
