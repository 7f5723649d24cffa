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

The gradient.  The reference differentiates `ssd_chunked` in XLA,
outside the Pallas kernel; here the forward on the card is the kernel,
so its gradient is a hand-written kernel too (`csrc/ssd_scan_bwd.cu`).
When autograd needs a gradient (grad mode on and an input requiring
one), the dispatch sends CUDA tensors through `SSDScan`, an autograd
function whose forward is the kernel keeping its group states (the
float32 incoming state of every group, which launch 2 writes anyway)
and whose backward is the backward kernel; otherwise it launches the
forward alone, as serving does.  `BWD_LAUNCHES` counts backward calls
(`bwd_kernel_launches(s)` kernels each).  `ssd_scan_bwd_plain` is the
backward's plain version, chunk by chunk from the gradient equations
(the tests hold it to autograd of `ssd_scan_plain` and to `jax.grad`
of the reference); `ssd_scan_bwd_split_plain` mirrors the kernel's
split.  The backward returns dx, dB, dC in x's dtype, ddt and dA in
float32.
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
# chunks per group of the kernel's split (GROUP in csrc/ssd_scan.cu): at
# the prefill shape 64 chunks make 8 groups, whose f32 states (16.8 MB)
# stay in the 50 MB L2
GROUP_CHUNKS = 8

LAUNCHES = 0                # kernel launches in this process
BWD_LAUNCHES = 0            # backward kernel calls in this process


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
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, dt, A, B, C)):
            return SSDScan.apply(x, dt, A, B, C, chunk)
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


def _bwd_chunks(x, dt, A, B, C, dy, S0, dS, chunk, rounded=False):
    """The backward of the scan over whole chunks (s a multiple of
    `chunk`) from the incoming state S0 (b, h, p, n), given the output
    gradient dy and the gradient dS of the final state.  Per chunk of L
    rows, with a = dt A, c its inclusive cumsum, u = dt x, S the chunk's
    incoming state, dS' its outgoing state's gradient and E_ij =
    exp(c_i - c_j) for i >= j (else 0):
      W = (C B^T) o E, G = dy u^T, GE = G o E
      du = W^T dy + exp(c_L - c) (B dS'^T)          dx = dt du
      dC = GE B + exp(c) (dy S)       dB = GE^T C + exp(c_L - c) (u dS')
      dc = rowsum(W o G) - colsum(W o G) + C.(dy S) exp(c) - r, with
           r_j = exp(c_L - c_j) u_j.(dS' B_j); the last row adds
           exp(c_L) <dS', S> + sum_j r_j
      da = reverse cumsum of dc; ddt = x.du + A da; dA += sum dt da
      dS <- exp(c_L) dS' + dy^T (exp(c) C)
    Returns float32 dx, ddt (b, s, h), dA (b, h) and per-head dB / dC
    (b, s, h, n).  `rounded` rounds W and GE to
    bf16 before the products that take them (a tensor-core shortcut:
    the control of the card's bf16 check)."""
    b, s, h, _ = x.shape
    rep = h // B.shape[2]
    xf, dyf, dtf = x.float(), dy.float(), dt.float()
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nc = s // chunk
    cuts = [slice(c * chunk, (c + 1) * chunk) for c in range(nc)]
    states, S = [], S0
    for sl in cuts:                     # each chunk's incoming state
        cA = torch.cumsum(dtf[:, sl] * A, dim=1)
        states.append(S)
        upd = torch.einsum("bjhn,bjhp,bjh->bhpn", Bh[:, sl],
                           xf[:, sl] * dtf[:, sl, :, None],
                           torch.exp(cA[:, -1:] - cA))
        S = S * torch.exp(cA[:, -1])[..., None, None] + upd
    dA = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    outs = []
    for sl, S in zip(reversed(cuts), reversed(states)):
        x_, dy_, dt_, B_, C_ = xf[:, sl], dyf[:, sl], dtf[:, sl], Bh[:, sl], \
            Ch[:, sl]
        cA = torch.cumsum(dt_ * A, dim=1)                       # (b,L,h)
        E = torch.where(tri[None, :, :, None],
                        torch.exp(cA[:, :, None] - cA[:, None]), zero)
        u = x_ * dt_[..., None]
        W = torch.einsum("bihn,bjhn->bijh", C_, B_) * E
        G = torch.einsum("bihp,bjhp->bijh", dy_, u)
        GE = G * E
        Wr, GEr = (t.to(torch.bfloat16).float() if rounded else t
                   for t in (W, GE))
        eca = torch.exp(cA)
        dec = torch.exp(cA[:, -1:] - cA)
        last = torch.exp(cA[:, -1])                             # (b,h)
        dus = dec[..., None] * torch.einsum("bjhn,bhpn->bjhp", B_, dS)
        du = torch.einsum("bijh,bihp->bjhp", Wr, dy_) + dus
        dCs = eca[..., None] * torch.einsum("bihp,bhpn->bihn", dy_, S)
        dC_ = torch.einsum("bijh,bjhn->bihn", GEr, B_) + dCs
        dB_ = torch.einsum("bijh,bihn->bjhn", GEr, C_) \
            + dec[..., None] * torch.einsum("bjhp,bhpn->bjhn", u, dS)
        M = W * G
        r = (u * dus).sum(-1)                                   # (b,L,h)
        dc = M.sum(2) - M.sum(1) + (C_ * dCs).sum(-1) - r
        dc[:, -1] += last * (dS * S).sum((-2, -1)) + r.sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dc, [1]), 1), [1])
        dA = dA + (dt_ * da).sum(1)
        outs.append((du * dt_[..., None], (x_ * du).sum(-1) + A * da,
                     dB_, dC_))
        dS = dS * last[..., None, None] + torch.einsum(
            "bihp,bihn->bhpn", dy_ * eca[..., None], C_)
    dx, ddt, dBh, dCh = (torch.cat(t[::-1], 1) for t in zip(*outs))
    return dx, ddt, dA, dBh, dCh


def _pad_rows(ts, rows):
    """Zero rows appended along axis 1 up to `rows` (the dt = 0 tail)."""
    return [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                    + (0, rows - t.shape[1])) for t in ts]


def _bwd_out(x, B, s, dx, ddt, dA, dBh, dCh):
    """The rows < s of the float32 results; dB / dC summed over the
    heads of each group; dx, dB, dC in x's dtype, ddt and dA float32."""
    b, _, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    dB, dC = (t[:, :s].reshape(b, s, g, h // g, n).sum(3).to(x.dtype)
              for t in (dBh, dCh))
    return dx[:, :s].to(x.dtype), ddt[:, :s], dA.sum(0), dB, dC


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, *, chunk=64, rounded=False):
    """(dx, ddt, dA, dB, dC) of `ssd_scan_plain` given dy, by the gradient
    equations chunk by chunk in float32 (`_bwd_chunks`, from a zero
    state).  A ragged tail reads as dt = 0 and x = B = C = dy = 0, as in
    the forward."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rows = -(-s // chunk) * chunk
    x, dt, B, C, dy = _pad_rows((x, dt, B, C, dy), rows)
    zero = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    return _bwd_out(x, B, s, *_bwd_chunks(x, dt, A, B, C, dy, zero, zero,
                                          chunk, rounded))


def ssd_scan_bwd_split_plain(x, dt, A, B, C, dy, states=None, *, chunk=64,
                             group=GROUP_CHUNKS):
    """The backward kernel's split in plain PyTorch: `states` are the
    forward's group states as the kernel keeps them, (b, h, G, n, p)
    float32 (None: computed here; zero when G = 1).  Launch 1: each
    group's gradient of its incoming state from its own rows (walking
    its chunks forward: the sum over chunks k of D_k exp(c) C^T dy, D_k
    the product of the decays of the group's chunks before k) and its
    decay; launch 2: the gradient of every group's outgoing state, from
    the last group to the first; launch 3: each group's backward from
    its incoming state and that gradient (`_bwd_chunks`)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    G = n_groups(s, chunk, group)
    rows = G * group * chunk
    if states is None:
        S0 = ssd_split_states_plain(x, dt, A, B, C, chunk=chunk, group=group)
    else:
        S0 = states.permute(0, 2, 1, 4, 3)
    S0 = S0.reshape(b * G, h, p, n)
    xg, dtg, Bg, Cg, dyg = _by_group((x, dt, B, C, dy), chunk, group)
    # launch 1
    Ch = Cg.repeat_interleave(h // g, dim=2).float()
    loc = torch.zeros_like(S0)
    dec = torch.ones((b * G, h), dtype=torch.float32, device=x.device)
    for c in range(group):
        sl = slice(c * chunk, (c + 1) * chunk)
        cA = torch.cumsum(dtg[:, sl].float() * A, dim=1)
        loc = loc + dec[..., None, None] * torch.einsum(
            "bihp,bihn->bhpn", dyg[:, sl].float() * torch.exp(cA)[..., None],
            Ch[:, sl])
        dec = dec * torch.exp(cA[:, -1])
    # launch 2
    loc, dec = loc.reshape(b, G, h, p, n), dec.reshape(b, G, h)
    run, out = torch.zeros_like(loc[:, 0]), [None] * G
    for gi in reversed(range(G)):
        out[gi] = run
        run = loc[:, gi] + dec[:, gi, :, None, None] * run
    dS_end = torch.stack(out, 1).reshape(b * G, h, p, n)
    # launch 3
    dx, ddt, dA, dBh, dCh = _bwd_chunks(xg, dtg, A, Bg, Cg, dyg, S0,
                                        dS_end, chunk)
    dx, ddt, dBh, dCh = (t.reshape(b, rows, *t.shape[2:])
                         for t in (dx, ddt, dBh, dCh))
    return _bwd_out(x, B, s, dx, ddt, dA, dBh, dCh)


def bwd_kernel_launches(s: int, chunk: int = 64) -> int:
    """Kernels one backward call at sequence length s launches: the
    chunk states and the groups' own state gradients, the pass over the
    groups, the scan; no pass when one group holds every chunk."""
    return 2 if n_groups(s, chunk) == 1 else 3


def n_groups(s: int, chunk: int = 64, group: int = GROUP_CHUNKS) -> int:
    """Groups of `group` chunks the kernel splits a length-s scan into."""
    return -(-(-(-s // chunk)) // group)


def _by_group(ts, chunk, group):
    """Pad each (b, s, ...) tensor of `ts` to whole groups (dt = 0) and
    fold the groups into the batch: (b*G, group*chunk, ...)."""
    b, s = ts[0].shape[:2]
    G = n_groups(s, chunk, group)
    return [t.reshape(b * G, group * chunk, *t.shape[2:])
            for t in _pad_rows(ts, G * group * chunk)]


def ssd_split_states_plain(x, dt, A, B, C, *, chunk=64, group=GROUP_CHUNKS):
    """Passes 1-2 of the kernel's split in plain PyTorch: the incoming
    state of every group, (b, G, h, p, n) float32.  Pass 1: each group's
    end state from a zero state and its decay (the product over its
    chunks of exp(sum dA)); pass 2: the incoming states in order."""
    b, s, h, p = x.shape
    n = B.shape[3]
    G = n_groups(s, chunk, group)
    xg, dtg, Bg, Cg = _by_group((x, dt, B, C), chunk, group)
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
    xg, dtg, Bg, Cg = _by_group((x, dt, B, C), chunk, group)
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


def _ssd_cuda(x, dt, A, B, C, *, chunk=64, states=False):
    """Launch csrc/ssd_scan.cu on the current stream (no sync).  Returns
    y, or with `states` (y, the group states): the float32 incoming state
    of every group, (b, h, G, n, p), which launch 2 writes into the
    split's scratch (None when one group holds every chunk: its state is
    zero).  Asking for them changes no launch."""
    global LAUNCHES
    ins, st, decay = _prepare(x, dt, A, B, C, chunk)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _call("ssd_scan_launch", ins, (y, st, decay), x, B, chunk)
    LAUNCHES += kernel_launches(x.shape[1], chunk)
    return (y, st) if states else y


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    from . import build
    fn = build.load("ssd_scan_bwd").ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ssd_bwd_cuda(x, dt, A, B, C, dy, states, *, chunk=64):
    """Launch csrc/ssd_scan_bwd.cu on the current stream (no sync):
    `bwd_kernel_launches(s)` kernels.  `states` are the forward's group
    states (`_ssd_cuda(..., states=True)`).  Returns (dx, ddt, dA, dB,
    dC): dx, dB, dC in x's dtype, ddt and dA float32; the kernel writes
    per-head dB / dC and per-group dA partials, summed here."""
    global BWD_LAUNCHES
    _check(x, dt, A, B, C)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not fit x {tuple(x.shape)} {x.dtype}")
    ins, _, _ = _prepare(x, dt, A, B, C, chunk)
    dy = dy.contiguous()
    dy = dy if dy.data_ptr() % 16 == 0 else dy.clone()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    G, nc = n_groups(s, chunk), -(-s // chunk)
    if G > 1 and (states is None or tuple(states.shape) != (b, h, G, n, p)
                  or states.dtype != torch.float32 or
                  not states.is_contiguous()):
        raise ValueError(f"the backward at s = {s} needs the forward's "
                         f"group states, float32 {(b, h, G, n, p)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    chunk_states = torch.empty((b, h, nc, n, p), **f32)
    dstates = torch.empty((b, h, G, n, p), **f32) if G > 1 else None
    gdecay = torch.empty((b, h, G), **f32)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dBh, dCh = (torch.empty((b, s, h, n), **f32) for _ in range(2))
    dAp = torch.empty((b, h, G), **f32)
    outs = (states if G > 1 else None, chunk_states, dstates, gdecay, dx,
            ddt, dBh, dCh, dAp)
    fn = _bwd_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ins], dy.data_ptr(),
                 *[None if t is None else t.data_ptr() for t in outs],
                 b, s, h, p, g, n, chunk, GROUP_CHUNKS, DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    BWD_LAUNCHES += 1
    dB, dC = (t.view(b, s, g, h // g, n).sum(3).to(x.dtype)
              for t in (dBh, dCh))
    return dx, ddt, dAp.sum((0, 2)), dB, dC


class SSDScan(torch.autograd.Function):
    """The forward kernel keeping its group states, and the backward
    kernel as its gradient.  Saves x, dt, A, B, C and the group states;
    the backward launches on a contiguous dy.  Under activation
    checkpointing the recompute runs (and counts) the forward again."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, states = _ssd_cuda(x, dt, A, B, C, chunk=chunk, states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, states = ctx.saved_tensors
        grads = _ssd_bwd_cuda(x, dt, A, B, C, dy.contiguous(), states,
                              chunk=ctx.chunk)
        return (*grads, None)


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
