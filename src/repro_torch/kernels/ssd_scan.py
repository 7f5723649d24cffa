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
dtype.  On the card: any p up to 64 and n up to 128, any chunk.  The
kernels are built for p 64 and n 64 or 128 (`HEAD_DIMS`, `STATE_DIMS`);
a narrower x is zero-padded to p 64 and narrower B / C to the next built
n (`kernel_widths`), and y (dx, dB, dC) sliced back.  The padded columns
add exact zeros to every sum (y's p columns are independent of each
other; the state's padded rows and columns stay zero), so the kept
columns, ddt and dA are the true widths'.  The group states of a padded
call are kept at the padded widths.  Widths the kernels are built for
launch as they are.  The chunk picks the
plain version's float32 sum order, not the function: y is the same
function of (x, dt, A, B, C) at every chunk, so the kernels run their own
`TILE`-row chunks whatever chunk the caller asks for.  `LAUNCHES` counts
kernel launches, `kernel_launches(s)` per call: 3, or 1 when one group
holds every tile (the plain version never bumps it).

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
of the reference); `ssd_scan_bwd_split_plain` mirrors the bf16
kernel's split (walks, pass, chunk blocks that sum the dB / dC of
`BWD_HEADS` heads of a B/C group), and `split=k` on the plain version
takes every operand the bf16 kernel splits as the sum of its first k
bf16 parts (`split_parts`).  The backward returns dx, dB, dC in x's dtype, ddt and
dA in float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import ssd as _ssd
from .build import launch as _call, pad_cols as _pad_cols

TILE = 64                   # rows of the kernels' chunk (L in the csrc/)
HEAD_DIMS = (64,)           # p the kernels are built for
STATE_DIMS = (64, 128)      # n the kernels are built for
# wider: ROADMAP.md queue 2, item 2 (y's p columns are independent, so a
# p above 64 can run in blocks of 64)
MAX_HEAD_DIM, MAX_STATE_DIM = HEAD_DIMS[-1], STATE_DIMS[-1]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# tiles per group of the kernel's split (GROUP in csrc/ssd_scan.cu): at
# the prefill shape 64 tiles make 8 groups, whose f32 states (16.8 MB)
# stay in the 50 MB L2
GROUP_CHUNKS = 8

# heads of one B/C group a block of the bf16 backward takes
# (csrc/ssd_scan_bwd.cu HEADS): it sums their dB and dC itself
BWD_HEADS = 8

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
            return SSDScan.apply(x, dt, A, B, C)
        return _ssd_cuda(x, dt, A, B, C)
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


def split_parts(t, parts):
    """The bf16 parts of the float32 tensor `t` as the backward kernel
    splits a float32 operand: the first is bf16(t), each next one bf16 of
    what the parts before leave.  Returned as float32 tensors; with three
    their sum is t, bit for bit, over float32's normal range."""
    out, rest = [], t.float()
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out.append(part)
        rest = rest - part
    return out


def _operand(t, split):
    """What an exact tensor-core product sees of the float32 operand t
    split into `split` bf16 parts (the sum of the parts); t itself when
    `split` is None."""
    if split is None:
        return t
    parts = split_parts(t, split)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _state_step(S, x_, dt_, A, B_, split=None):
    """One chunk forward: S (b, h, p, n) <- exp(c_L) S + sum_j (x_j dt_j
    exp(c_L - c_j)) B_j^T, the scaled x split as the kernel splits it."""
    cA = torch.cumsum(dt_ * A, dim=1)
    v = x_ * (dt_ * torch.exp(cA[:, -1:] - cA))[..., None]
    upd = torch.einsum("bjhp,bjhn->bhpn", _operand(v, split), B_)
    return S * torch.exp(cA[:, -1])[..., None, None] + upd


def _grad_step(dS, dy_, dt_, A, C_, split=None):
    """One chunk in reverse: the gradient of the chunk's outgoing state
    (b, h, p, n) to that of its incoming state, exp(c_L) dS + sum_i
    (exp(c_i) dy_i) C_i^T, the scaled dy split as the kernel splits it."""
    cA = torch.cumsum(dt_ * A, dim=1)
    v = dy_ * torch.exp(cA)[..., None]
    return dS * torch.exp(cA[:, -1])[..., None, None] + torch.einsum(
        "bihp,bihn->bhpn", _operand(v, split), C_)


def _chunk_grads(x_, dt_, A, B_, C_, dy_, S, dS, tri, rounded=False,
                 split=None):
    """One chunk's gradient, per head, float32: x_ / dy_ (b, L, h, p),
    dt_ (b, L, h), B_ / C_ repeated to the heads (b, L, h, n), S the
    chunk's incoming state and dS the gradient of its outgoing state
    (b, h, p, n).  With a = dt A, c its cumsum, u = dt x and E_ij =
    exp(c_i - c_j) for i >= j (else 0):
      W = (C B^T) o E, G = dy u^T, GE = G o E
      du = W^T dy + exp(c_L - c) (B dS'^T)          dx = dt du
      dC = GE B + exp(c) (dy S)       dB = GE^T C + exp(c_L - c) (u dS')
      dc = rowsum(W o G) - colsum(W o G) + C.(dy S) exp(c) - r, with
           r_j = exp(c_L - c_j) u_j.(dS' B_j); the last row adds
           exp(c_L) <dS', S> + sum_j r_j
      da = reverse cumsum of dc; ddt = x.du + A da; dA = sum dt da
    Returns dx, ddt (b, L, h), dA (b, h), dB, dC (b, L, h, n).
    `rounded` rounds W and GE to bf16 before the products that take them
    (a tensor-core shortcut: the control of the card's bf16 check);
    `split` takes W, GE, S and dS' as the sums of that many bf16 parts
    there, as the bf16 kernel does."""
    zero = torch.zeros((), dtype=torch.float32, device=x_.device)
    cA = torch.cumsum(dt_ * A, dim=1)                       # (b,L,h)
    E = torch.where(tri[None, :, :, None],
                    torch.exp(cA[:, :, None] - cA[:, None]), zero)
    u = x_ * dt_[..., None]
    W = torch.einsum("bihn,bjhn->bijh", C_, B_) * E
    G = torch.einsum("bihp,bjhp->bijh", dy_, u)
    GE = G * E
    if rounded:
        Wr, GEr = (t.to(torch.bfloat16).float() for t in (W, GE))
    else:
        Wr, GEr = _operand(W, split), _operand(GE, split)
    Sr, dSr = _operand(S, split), _operand(dS, split)
    eca = torch.exp(cA)
    dec = torch.exp(cA[:, -1:] - cA)
    last = torch.exp(cA[:, -1])                             # (b,h)
    dus = dec[..., None] * torch.einsum("bjhn,bhpn->bjhp", B_, dSr)
    du = torch.einsum("bijh,bihp->bjhp", Wr, dy_) + dus
    dCs = eca[..., None] * torch.einsum("bihp,bhpn->bihn", dy_, Sr)
    dC_ = torch.einsum("bijh,bjhn->bihn", GEr, B_) + dCs
    dB_ = torch.einsum("bijh,bihn->bjhn", GEr, C_) \
        + dec[..., None] * torch.einsum("bjhp,bhpn->bjhn", u, dSr)
    M = W * G
    r = (u * dus).sum(-1)                                   # (b,L,h)
    dc = M.sum(2) - M.sum(1) + (C_ * dCs).sum(-1) - r
    dc[:, -1] += last * (dS * S).sum((-2, -1)) + r.sum(1)
    da = torch.flip(torch.cumsum(torch.flip(dc, [1]), 1), [1])
    return (du * dt_[..., None], (x_ * du).sum(-1) + A * da,
            (dt_ * da).sum(1), dB_, dC_)


def _per_head(x, dt, B, C, dy):
    """x, dt, dy and B / C repeated to x's heads, in float32 (float64
    inputs stay float64)."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    rep = x.shape[2] // B.shape[2]
    return tuple(t.to(dtype) for t in (x, dt, B.repeat_interleave(rep, dim=2),
                                       C.repeat_interleave(rep, dim=2), dy))


def _bwd_chunks(x, dt, A, B, C, dy, S0, dS, chunk, rounded=False,
                split=None):
    """The backward of the scan over whole chunks (s a multiple of
    `chunk`) from the incoming state S0 (b, h, p, n), given the output
    gradient dy and the gradient dS of the final state: every chunk's
    incoming state forward, then the chunks in reverse (`_chunk_grads`),
    carrying the state gradient.  Returns float32 dx, ddt (b, s, h), dA
    (b, h) and per-head dB / dC (b, s, h, n) (float64 from float64
    inputs)."""
    xf, dtf, Bh, Ch, dyf = _per_head(x, dt, B, C, dy)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    cuts = [slice(c * chunk, (c + 1) * chunk)
            for c in range(x.shape[1] // chunk)]
    states, S = [], S0
    for sl in cuts:                     # each chunk's incoming state
        states.append(S)
        S = _state_step(S, xf[:, sl], dtf[:, sl], A, Bh[:, sl], split)
    dA = torch.zeros(dtf[:, 0].shape, dtype=xf.dtype, device=x.device)
    outs = []
    for sl, S in zip(reversed(cuts), reversed(states)):
        *o, dA_c, dB_, dC_ = _chunk_grads(xf[:, sl], dtf[:, sl], A, Bh[:, sl],
                                          Ch[:, sl], dyf[:, sl], S, dS, tri,
                                          rounded, split)
        dA = dA + dA_c
        outs.append((*o, dB_, dC_))
        dS = _grad_step(dS, dyf[:, sl], dtf[:, sl], A, Ch[:, sl], split)
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


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, *, chunk=64, rounded=False,
                       split=None):
    """(dx, ddt, dA, dB, dC) of `ssd_scan_plain` given dy, by the gradient
    equations chunk by chunk in float32 (`_bwd_chunks`, from a zero
    state), or in float64 from float64 inputs (the exact reference of
    the card's float32 checks).  A ragged tail reads as dt = 0 and x = B
    = C = dy = 0, as in the forward.  `rounded`: W and GE rounded to one
    bf16 before their products (the control of the card's bf16 check);
    `split`: every float32 operand the bf16 kernel splits (W, GE, S, dS',
    the scaled x and dy of the walks) taken as the sum of that many bf16
    parts."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rows = -(-s // chunk) * chunk
    x, dt, B, C, dy = _pad_rows((x, dt, B, C, dy), rows)
    zero = torch.zeros((b, h, p, n), device=x.device,
                       dtype=torch.promote_types(x.dtype, torch.float32))
    return _bwd_out(x, B, s, *_bwd_chunks(x, dt, A, B, C, dy, zero, zero,
                                          chunk, rounded, split))


def head_sets(t, g, heads=None):
    """Per-head rows (b, s, h, n) summed over sets of `heads` consecutive
    heads of each of the g B/C groups, the last set of a group short when
    heads does not divide h / g: (b, s, g, nsplit, n), nsplit =
    ceil((h / g) / heads).  The bf16 backward kernel's blocks sum their
    heads so."""
    heads = BWD_HEADS if heads is None else heads
    b, s, h, n = t.shape
    hpg = h // g
    nsplit = -(-hpg // heads)
    t = torch.nn.functional.pad(t.reshape(b, s, g, hpg, n),
                                (0, 0, 0, nsplit * heads - hpg))
    return t.reshape(b, s, g, nsplit, heads, n).sum(4)


def ssd_scan_bwd_split_plain(x, dt, A, B, C, dy, states=None, *, chunk=64,
                             group=GROUP_CHUNKS, heads=None):
    """The bf16 backward kernel's split in plain PyTorch: `states` are the
    forward's group states as the kernel keeps them, (b, h, G, n, p)
    float32 (None: computed here; zero when G = 1).  Launch 1, two walks
    per group: forward from the group's state, every chunk's incoming
    state; in reverse from a zero gradient, each chunk's local dS' (from
    the group's later rows) and the product of the decays after it, which
    end in the group's own incoming-state gradient and decay.  Launch 2:
    the gradient of every group's outgoing state, from the last group to
    the first.  Launch 3, per chunk: dS' = local + decay x its group's
    outgoing gradient, the chunk's gradient (`_chunk_grads`), dB and dC
    summed over sets of `heads` heads of a B/C group (`head_sets`), the
    sets summed after."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    G = n_groups(s, chunk, group)
    nc = -(-s // chunk)
    if states is None:
        S0 = ssd_split_states_plain(x, dt, A, B, C, chunk=chunk, group=group)
    else:
        S0 = states.permute(0, 2, 1, 4, 3).contiguous()
    xf, dtf, Bh, Ch, dyf = _per_head(*_pad_rows((x, dt, B, C, dy),
                                                nc * chunk))
    cut = [slice(c * chunk, (c + 1) * chunk) for c in range(nc)]
    spans = [range(gi * group, min(nc, (gi + 1) * group)) for gi in range(G)]
    # launch 1
    S_in, loc, fac, own, gdec = [None] * nc, [None] * nc, [None] * nc, [], []
    for gi, span in enumerate(spans):
        S = S0[:, gi]
        for c in span:
            S_in[c] = S
            S = _state_step(S, xf[:, cut[c]], dtf[:, cut[c]], A,
                            Bh[:, cut[c]])
        X, f = torch.zeros_like(S), torch.ones_like(S[..., 0, 0])
        for c in reversed(span):
            loc[c], fac[c] = X, f
            X = _grad_step(X, dyf[:, cut[c]], dtf[:, cut[c]], A,
                           Ch[:, cut[c]])
            f = f * torch.exp((dtf[:, cut[c]] * A).sum(1))
        own.append(X)
        gdec.append(f)
    # launch 2
    run, out = torch.zeros_like(own[0]), [None] * G
    for gi in reversed(range(G)):
        out[gi] = run
        run = own[gi] + gdec[gi][..., None, None] * run
    # launch 3
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    outs = [_chunk_grads(xf[:, sl], dtf[:, sl], A, Bh[:, sl], Ch[:, sl],
                         dyf[:, sl], S_in[c],
                         loc[c] + fac[c][..., None, None] * out[c // group],
                         tri)
            for c, sl in enumerate(cut)]
    dx, ddt, dA, dBh, dCh = zip(*outs)
    dx, ddt, dBh, dCh = (torch.cat(t, 1)[:, :s] for t in (dx, ddt, dBh, dCh))
    dB, dC = (head_sets(t, g, heads).sum(3).to(x.dtype) for t in (dBh, dCh))
    return dx.to(x.dtype), ddt, torch.stack(dA).sum((0, 1)), dB, dC


def bwd_kernel_launches(s: int) -> int:
    """Kernels one backward call at sequence length s launches: the
    tiles' states and the groups' own state gradients, the pass over the
    groups, the scan; no pass when one group holds every tile."""
    return 2 if n_groups(s) == 1 else 3


def n_groups(s: int, chunk: int = TILE, group: int = GROUP_CHUNKS) -> int:
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


def kernel_launches(s: int) -> int:
    """Kernels one call at sequence length s launches: the three passes
    of the split, or the scan alone when one group holds every tile."""
    return 1 if n_groups(s) == 1 else 3


@functools.lru_cache(maxsize=None)
def _lib(entry="ssd_scan_launch"):
    from . import build
    fn = getattr(build.load("ssd_scan"), entry)
    n_ptr = 8 if entry == "ssd_scan_launch" else 7
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_widths(p: int, n: int) -> tuple:
    """The (p, n) the kernels run a (p, n) scan at: the narrowest built
    widths that hold them (x, B and C zero-padded to them)."""
    if p > MAX_HEAD_DIM or n > MAX_STATE_DIM:
        raise ValueError(f"ssd_scan kernel takes p up to {MAX_HEAD_DIM} and "
                         f"n up to {MAX_STATE_DIM} (narrower ones are "
                         f"zero-padded to p in {HEAD_DIMS}, n in "
                         f"{STATE_DIMS}); got p={p}, n={n}; wider ones are "
                         f"ROADMAP.md queue 2, item 2")
    return (next(w for w in HEAD_DIMS if p <= w),
            next(w for w in STATE_DIMS if n <= w))


def _prepare(x, dt, A, B, C):
    """Checked, dense, 16-byte aligned inputs, x / B / C padded to the
    kernels' widths, and the split's scratch at those widths."""
    b, s, h, _ = x.shape
    p, n = kernel_widths(x.shape[3], B.shape[3])
    # the kernel copies dense row-major 16-byte rows with cp.async; the
    # model's x/B/C are views into the conv output, so this copies them
    ins = [_pad_cols(x, p), dt, A, _pad_cols(B, n), _pad_cols(C, n)]
    ins = [t.contiguous() for t in ins]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    G = n_groups(s)
    states = decay = None
    if G > 1:                   # group states and decays of the split
        states = torch.empty((b, h, G, n, p), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((b, h, G), dtype=torch.float32, device=x.device)
    return ins, states, decay


def _dims(x, B) -> tuple:
    """The launchers' int arguments: b, s, h, p, g, n, the chunk (always
    the kernels' `TILE`, never the caller's), the group, the dtype code."""
    b, s, h, p = x.shape
    return (b, s, h, p, B.shape[2], B.shape[3], TILE, GROUP_CHUNKS,
            DTYPES[x.dtype])


def _ssd_cuda(x, dt, A, B, C, *, states=False):
    """Launch csrc/ssd_scan.cu on the current stream (no sync).  Returns
    y, or with `states` (y, the group states): the float32 incoming state
    of every group, (b, h, G, n, p) at the kernels' widths, which launch
    2 writes into the split's scratch (None when one group holds every
    tile: its state is zero).  Asking for them changes no launch."""
    global LAUNCHES
    ins, st, decay = _prepare(x, dt, A, B, C)
    y = torch.empty_like(ins[0])
    _call(_lib("ssd_scan_launch"), (*ins, y, st, decay),
          _dims(ins[0], ins[3]), "ssd_scan")
    LAUNCHES += kernel_launches(x.shape[1])
    if y.shape[3] != x.shape[3]:
        y = y[..., :x.shape[3]].contiguous()
    return (y, st) if states else y


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    from . import build
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    heads = lib.ssd_scan_bwd_heads()
    if heads != BWD_HEADS:
        raise RuntimeError(f"csrc/ssd_scan_bwd.cu takes {heads} heads a "
                           f"block, BWD_HEADS says {BWD_HEADS}")
    return fn


def bwd_rows(h: int, g: int, dtype) -> int:
    """Rows per position of the backward kernel's float32 dB / dC: one
    per head in float32, one per block of `BWD_HEADS` heads of a B/C
    group in bf16 (the kernel sums its heads)."""
    if dtype == torch.float32:
        return h
    return g * -(-(h // g) // BWD_HEADS)


def _ssd_bwd_cuda(x, dt, A, B, C, dy, states):
    """Launch csrc/ssd_scan_bwd.cu on the current stream (no sync):
    `bwd_kernel_launches(s)` kernels.  `states` are the forward's group
    states (`_ssd_cuda(..., states=True)`, at the kernels' widths).
    Returns (dx, ddt, dA, dB, dC): dx, dB, dC in x's dtype, ddt and dA
    float32.  The kernel writes float32 dB / dC rows (`bwd_rows`) and dA
    parts per (batch, head, group) in float32 or per (batch, head, tile)
    in bf16, summed here.  A padded call pads dy with zeros as well, so
    the padded columns add nothing to ddt and dA."""
    global BWD_LAUNCHES
    _check(x, dt, A, B, C)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not fit x {tuple(x.shape)} {x.dtype}")
    p0, n0 = x.shape[3], B.shape[3]
    ins, _, _ = _prepare(x, dt, A, B, C)
    x, B = ins[0], ins[3]
    dy = _pad_cols(dy, x.shape[3]).contiguous()
    dy = dy if dy.data_ptr() % 16 == 0 else dy.clone()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    G, nc = n_groups(s), -(-s // TILE)
    if G > 1 and (states is None or tuple(states.shape) != (b, h, G, n, p)
                  or states.dtype != torch.float32 or
                  not states.is_contiguous()):
        raise ValueError(f"the backward at s = {s} needs the forward's "
                         f"group states, float32 {(b, h, G, n, p)}")
    bf = x.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=x.device)
    chunk_states = torch.empty((b, h, nc, n, p), **f32)
    dstates = torch.empty((b, h, G, n, p), **f32) if G > 1 else None
    gdecay = torch.empty((b, h, G), **f32)
    dsloc = torch.empty((b, h, nc, n, p), **f32) if bf else None
    facs = torch.empty((b, h, nc), **f32) if bf else None
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    rows = bwd_rows(h, g, x.dtype)
    dBp, dCp = (torch.empty((b, s, rows, n), **f32) for _ in range(2))
    dAp = torch.empty((b, h, nc if bf else G), **f32)
    _call(_bwd_lib(), (*ins, dy, states if G > 1 else None, chunk_states,
                       dstates, gdecay, dsloc, facs, dx, ddt, dBp, dCp, dAp),
          _dims(x, B), "ssd_scan backward")
    BWD_LAUNCHES += 1
    dB, dC = (t.view(b, s, g, rows // g, n).sum(3)[..., :n0].to(x.dtype)
              for t in (dBp, dCp))
    if p != p0:
        dx = dx[..., :p0].contiguous()
    return dx, ddt, dAp.sum((0, 2)), dB, dC


class SSDScan(torch.autograd.Function):
    """The forward kernel keeping its group states, and the backward
    kernel as its gradient, both at the kernels' `TILE` (the caller's
    chunk only orders the plain version's sums).  Saves x, dt, A, B, C
    and the group states; the backward launches on a contiguous dy.
    Under activation checkpointing the recompute runs (and counts) the
    forward again."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        y, states = _ssd_cuda(x, dt, A, B, C, states=True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, states = ctx.saved_tensors
        return _ssd_bwd_cuda(x, dt, A, B, C, dy.contiguous(), states)


def ssd_group_states_cuda(x, dt, A, B, C):
    """The kernel's launches 1-2 alone on CUDA tensors: the float32
    incoming state of every group, (b, G, h, p, n) like
    `ssd_split_states_plain` at chunk `TILE`.  For the card's checks of
    the split's state products; s must span more than one group.  A
    padded call's states come back at the true widths (the padded rows
    and columns are zero).  Adds its two launches to `LAUNCHES`."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"ssd_group_states_cuda takes CUDA tensors, got "
                         f"{x.device}")
    _check(x, dt, A, B, C)
    if n_groups(x.shape[1]) < 2:
        raise ValueError(f"s = {x.shape[1]} fits one group: no group states")
    ins, states, decay = _prepare(x, dt, A, B, C)
    _call(_lib("ssd_scan_states_launch"), (*ins, states, decay),
          _dims(ins[0], ins[3]), "ssd_scan")
    LAUNCHES += 2
    return states.permute(0, 2, 1, 4, 3)[..., :x.shape[3], :B.shape[3]]
