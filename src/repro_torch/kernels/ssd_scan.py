"""Mamba2 SSD chunked scan from a zero state, returning y only.

`ssd_scan(x, dt, A, B, C, *, chunk)` is the dispatch.  Tensors on the CPU
go to `ssd_scan_plain`, the reference's `ssd_chunked` (`nn.ssd`), which
pads a ragged tail with dt = 0.  Tensors on a CUDA device go to the
hand-written kernel `csrc/ssd_scan.cu` or raise: there is no fallback
from the card to the plain version.  The kernel takes a ragged sequence
length too (it reads the tail as dt = 0), unlike the Pallas launcher's
``assert s % cl == 0``: mamba layers call the scan at any prompt length.

The kernel replaces `src/repro/kernels/ssd_scan.py:_ssd_kernel`.  At
the zamba2-1.2b prefill shape (b = 2, s = 4096, h = 64, p = 64, n = 64)
its function is bound by bytes (~137 MB); its design is bound by float32
FMAs.  The chunk axis is split into groups of `GROUP_CHUNKS` chunks over
three launches: each group's end state from zero, the state passed from
group to group in order, then each group's scan from its incoming state
(`ssd_scan_split_plain` mirrors this in plain PyTorch for the tests).
The wrapper allocates the float32 group states (b, h, G, n, p) and
decays (b, h, G).  See the source's header note.

Shapes: x (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
(b, s, g, n) with x's dtype (float32 or bfloat16); y (b, s, h, p) in x's
dtype.  On the card: chunk 64, p 64, n 64 or 128.  `LAUNCHES` counts
kernel launches, `kernel_launches(s)` per call: 3, or 1 when one group
holds every chunk (the plain version never bumps it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import ssd as _ssd
from . import guard as _guard

CHUNKS = (64,)              # chunk lengths the kernel takes
HEAD_DIMS = (64,)           # p
STATE_DIMS = (64, 128)      # n
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# chunks per group of the kernel's split (GROUP in csrc/ssd_scan.cu): at
# the prefill shape 64 chunks make 8 groups, whose f32 states (16.8 MB)
# stay in the 50 MB L2
GROUP_CHUNKS = 8

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


def ssd_scan_rounded_plain(x, dt, A, B, C, *, chunk=64):
    """`ssd_chunked` from a zero state with x dt and W rounded to bf16
    before their product: the error a bf16 tensor-core shortcut of that
    float32 product would make.  The control of the card's bf16 check
    (the kernel must stay closer to `ssd_scan_plain` than this)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    pad = -s % chunk
    x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
               for t in (x, B, C))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    f32, bf16 = torch.float32, torch.bfloat16
    state = torch.zeros((b, h, p, B.shape[3]), dtype=f32, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c in range(x.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        cA = torch.cumsum(dt[:, sl].float() * A, dim=1)        # (b,L,h)
        Ldec = torch.where(tri[None, :, :, None],
                           torch.exp(cA[:, :, None] - cA[:, None]),
                           torch.zeros((), dtype=f32, device=x.device))
        Bh = B[:, sl].repeat_interleave(rep, dim=2).float()
        Ch = C[:, sl].repeat_interleave(rep, dim=2).float()
        xdt = x[:, sl].float() * dt[:, sl, :, None].float()
        w = torch.einsum("bihn,bjhn->bijh", Ch, Bh) * Ldec
        y = torch.einsum("bijh,bjhp->bihp", w.to(bf16).float(),
                         xdt.to(bf16).float())
        y = y + torch.einsum("bihn,bhpn->bihp", Ch, state) \
            * torch.exp(cA)[..., None]
        upd = torch.einsum("bjhn,bjhp,bjh->bhpn", Bh, xdt,
                           torch.exp(cA[:, -1:] - cA))
        state = state * torch.exp(cA[:, -1])[..., None, None] + upd
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1)[:, :s]


def n_groups(s: int, chunk: int = 64, group: int = GROUP_CHUNKS) -> int:
    """Groups of `group` chunks the kernel splits a length-s scan into."""
    return -(-(-(-s // chunk)) // group)


def _by_group(x, dt, B, C, chunk, group):
    """Pad to whole groups (dt = 0) and fold groups into the batch:
    (b, s, ...) -> (b*G, group*chunk, ...)."""
    b, s = x.shape[:2]
    G = n_groups(s, chunk, group)
    pad = G * group * chunk - s
    x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
               for t in (x, B, C))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    return [t.reshape(b * G, group * chunk, *t.shape[2:])
            for t in (x, dt, B, C)]


def ssd_split_states_plain(x, dt, A, B, C, *, chunk=64, group=GROUP_CHUNKS):
    """Passes 1-2 of the kernel's split in plain PyTorch: the incoming
    state of every group, (b, G, h, p, n) float32.  Pass 1: each group's
    end state from a zero state and its decay (the product over its
    chunks of exp(sum dA)); pass 2: the incoming states in order."""
    b, s, h, p = x.shape
    n = B.shape[3]
    G = n_groups(s, chunk, group)
    xg, dtg, Bg, Cg = _by_group(x, dt, B, C, chunk, group)
    _, end = _ssd.ssd_chunked(xg, dtg, A, Bg, Cg, chunk=chunk)
    dA = (dtg.float() * A).reshape(b * G, group, chunk, h).sum(2)
    decay = torch.exp(dA).prod(1).reshape(b, G, h)
    end = end.reshape(b, G, h, p, n)
    run = torch.zeros_like(end[:, 0])
    incoming = []
    for gi in range(G):
        incoming.append(run)
        run = run * decay[:, gi, :, None, None] + end[:, gi]
    return torch.stack(incoming, 1)


def ssd_scan_split_plain(x, dt, A, B, C, *, chunk=64, group=GROUP_CHUNKS):
    """The kernel's split in plain PyTorch (tests only): the chunks are cut
    into groups of `group`; `ssd_split_states_plain` gives each group's
    incoming state, then (3) each group scans from it.  A ragged tail,
    and the chunks that fill the last group, are read as dt = 0."""
    b, s, h, p = x.shape
    G = n_groups(s, chunk, group)
    state0 = ssd_split_states_plain(x, dt, A, B, C, chunk=chunk, group=group)
    xg, dtg, Bg, Cg = _by_group(x, dt, B, C, chunk, group)
    y, _ = _ssd.ssd_chunked(xg, dtg, A, Bg, Cg, chunk=chunk,
                            state0=state0.reshape(b * G, *state0.shape[2:]))
    return y.reshape(b, G * group * chunk, h, p)[:, :s]


def kernel_launches(s: int, chunk: int = 64) -> int:
    """Kernels one call at sequence length s launches: the three passes
    of the split, or the scan alone when one group holds every chunk."""
    return 1 if n_groups(s, chunk) == 1 else 3


@functools.lru_cache(maxsize=None)
def _lib(entry="ssd_scan_launch"):
    from . import build
    fn = getattr(build.load("ssd_scan"), entry)
    n_ptr = 8 if entry == "ssd_scan_launch" else 7
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _prepare(x, dt, A, B, C, chunk):
    """Checked, dense, 16-byte aligned inputs and the split's scratch."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if chunk not in CHUNKS or p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd_scan kernel takes chunk in {CHUNKS}, p in "
                         f"{HEAD_DIMS}, n in {STATE_DIMS}; got chunk={chunk}"
                         f", p={p}, n={n}")
    # the kernel copies dense row-major 16-byte rows with cp.async; the
    # model's x/B/C are views into the conv output, so this copies them
    ins = [t.contiguous() for t in (x, dt, A, B, C)]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    G = n_groups(s, chunk)
    states = decay = None
    if G > 1:                   # group states and decays of the split
        states = torch.empty((b, h, G, n, p), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((b, h, G), dtype=torch.float32, device=x.device)
    return ins, states, decay


def _call(entry, ins, outs, x, B, chunk):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    fn = _lib(entry)
    # `ins` and the scratch may be freed when this returns while the
    # kernels still run: the caching allocator hands their memory only to
    # later work on the same stream
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ins],
                 *[None if t is None else t.data_ptr() for t in outs],
                 b, s, h, p, g, n, chunk, GROUP_CHUNKS, DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")


def _ssd_cuda(x, dt, A, B, C, *, chunk=64):
    """Launch csrc/ssd_scan.cu on the current stream (no sync).  The
    kernel has no backward yet: an input that requires a gradient raises
    (`guard.refuse_grad`)."""
    global LAUNCHES
    _guard.refuse_grad("ssd_scan", x, dt, A, B, C)
    ins, states, decay = _prepare(x, dt, A, B, C, chunk)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _call("ssd_scan_launch", ins, (y, states, decay), x, B, chunk)
    LAUNCHES += kernel_launches(x.shape[1], chunk)
    return y


def ssd_group_states_cuda(x, dt, A, B, C, *, chunk=64):
    """The kernel's launches 1-2 alone on CUDA tensors: the float32
    incoming state of every group, (b, G, h, p, n) like
    `ssd_split_states_plain`.  For the card's checks of the split's
    state products; s must span more than one group.  Adds its two
    launches to `LAUNCHES`."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"ssd_group_states_cuda takes CUDA tensors, got "
                         f"{x.device}")
    _check(x, dt, A, B, C)
    if n_groups(x.shape[1], chunk) < 2:
        raise ValueError(f"s = {x.shape[1]} fits one group: no group states")
    ins, states, decay = _prepare(x, dt, A, B, C, chunk)
    _call("ssd_scan_states_launch", ins, (states, decay), x, B, chunk)
    LAUNCHES += 2
    return states.permute(0, 2, 1, 4, 3)
