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
its function is bound by bytes (~138 MB).  The chunk axis is split into
groups of `GROUP_CHUNKS` chunks over three launches: each group's end
state from zero, the state passed from group to group in order, then
each group's scan from its incoming state (`ssd_scan_split_plain`
mirrors this in plain PyTorch for the tests).  In bf16 every product is
a wgmma with float32 operands split into three bf16 parts, dt folded
into W's columns, x / B / C copied by TMA, `HEADS` heads of one B/C
group a block (`STATE_HEADS` in launch 1; `launch_grids` gives each
launch's grid); `ssd_scan_fold_plain` mirrors its arithmetic.  The TMA
maps read bf16 x / B / C where they lie when their strides and base sit
on 16 bytes (`_tma_ready`): the model's views into the conv output are
not copied.  The wrapper allocates the float32 group states (b, h, G, n,
p) and decays (b, h, G).  See the source's header note.

Shapes: x (b, s, h, p), dt (b, s, h) float32, A (h,) float32, B/C
(b, s, g, n) with x's dtype (float32 or bfloat16); y (b, s, h, p) in x's
dtype.  On the card: any p and n, as the TPU kernel takes, at any chunk.
The kernels are built for p 64 and n 64 or 128 (`HEAD_DIMS`,
`STATE_DIMS`); other widths run in blocks of them (`ssd_blocked`,
`ssd_blocked_bwd`, written once for the card and the CPU tests, which hand
it the plain version).  x is zero-padded to a multiple of 64 columns and
its p-blocks run as heads of their own (y's p columns and the state's p
rows never mix); B / C run in n-blocks of up to 128 columns
(`state_blocks`), each zero-padded to the next built n, one call a block,
and y is the sum of the blocks' y (y is linear in the n-blocks of B and
C), taken in float32 and rounded once.  The padded columns add exact
zeros to every sum, so the kept columns, ddt and dA are the true widths';
y (dx, dB, dC) is sliced back.  The group states are kept at the
kernels' widths (`kernel_widths`).  Widths the kernels are built for
launch as they are.  The chunk picks the plain version's float32 sum
order, not the function: y is the same function of (x, dt, A, B, C) at
every chunk, so the kernels run their own `TILE`-row chunks whatever
chunk the caller asks for.  `LAUNCHES` counts kernel launches,
`kernel_launches(s, n)` per call: per n-block 3, or 1 when one group
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
(one an n-block, `bwd_kernel_launches(s)` kernels each).
`ssd_scan_bwd_plain` is the
backward's plain version, chunk by chunk from the gradient equations
(the tests hold it to autograd of `ssd_scan_plain` and to `jax.grad`
of the reference), and `split=k` on it takes every operand the bf16
kernel splits as the sum of its first k truncated bf16 parts
(`trunc_parts`: how many parts the card's limit needs).  The bf16
backward runs on wgmma with x / dy / B / C copied by TMA
(`bwd_launch_grids` gives its grids), reading the model's views where
they lie as the forward does; `ssd_scan_bwd_fold_plain` mirrors its
arithmetic in plain PyTorch and stands in for it in the CPU tests
(walks, pass, chunk blocks that sum the dB / dC of `BWD_HEADS` heads of
a B/C group in head order, the split operands in truncated parts).  The
backward returns dx, dB, dC in x's dtype, ddt and dA in float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..nn import ssd as _ssd
from .build import launch as _call, pad_cols as _pad_cols

TILE = 64                   # rows of the kernels' chunk (L in the csrc/)
HEAD_DIMS = (64,)           # p the kernels are built for (wider: blocks)
STATE_DIMS = (64, 128)      # n the kernels are built for (wider: blocks)
MAX_GRID_YZ = 65535         # the grid dimensions the card launches at most
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# tiles per group of the kernel's split (GROUP in csrc/ssd_scan.cu): at
# the prefill shape 64 tiles make 8 groups, whose f32 states (16.8 MB)
# stay in the 50 MB L2
GROUP_CHUNKS = 8

# heads of one B/C group a block of the bf16 forward takes
# (csrc/ssd_scan.cu SSD_HEADS; launch 1, the groups' end states:
# SSD_STATE_HEADS); a group's last block takes fewer when they do not
# divide its heads
HEADS = 2
STATE_HEADS = 1

# heads of one B/C group a block of the bf16 backward takes
# (csrc/ssd_scan_bwd.cu HEADS): it sums their dB and dC itself; the
# threads of its walk and chunk blocks, one warpgroup (HB_THREADS)
BWD_HEADS = 8
BWD_THREADS = 128

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


def trunc_parts(t, parts):
    """The bf16 parts of the float32 tensor `t` as the bf16 forward kernel
    splits an operand: the top 8 significant bits of t (its bits cut to a
    bf16), then of each remainder (exact in float32).  Returned as float32
    tensors; three sum to t bit for bit."""
    out, rest = [], t.float()
    for _ in range(parts):
        part = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def ssd_scan_fold_plain(x, dt, A, B, C, *, parts=3, group=GROUP_CHUNKS):
    """The bf16 forward kernel's arithmetic in plain PyTorch (tests only),
    float32, over `TILE`-row chunks in groups of `group`: each group's end
    state from zero, the states passed in order, then each group's scan
    from its incoming state S (n x p a head).  Per chunk, with cA the
    cumsum of dt A and every float32 operand taken as the sum of its first
    `parts` truncated bf16 parts (`trunc_parts`; three are the operand):
      W'_ij = (C_i . B_j) exp(cA_i - cA_j) dt_j (i >= j, else 0)
      y = (C S) exp(cA) + W' x
      S <- S exp(cA_last) + (B dt exp(cA_last - cA))^T x
    A ragged tail reads as dt = 0; y (b, s, h, p) in x's dtype."""
    b, s, h, p = x.shape
    L = TILE
    nc = -(-s // L)
    G = -(-nc // group)
    xf, dtf, Bh, Ch, _ = _per_head(*_pad_rows((x, dt, B, C, x), G * group * L))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    def op(t):
        out = trunc_parts(t, parts)
        return sum(out[1:], out[0])

    def chunk(S, c, want_y):
        sl = slice(c * L, (c + 1) * L)
        x_, dt_, B_, C_ = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        cA = torch.cumsum(dt_ * A, dim=1)                     # (b, L, h)
        last = cA[:, -1]
        y = None
        if want_y:
            E = torch.where(tri[None, :, :, None],
                            torch.exp(cA[:, :, None] - cA[:, None]),
                            torch.zeros((), device=x.device))
            W = torch.einsum("bihn,bjhn->bijh", C_, B_) * E * dt_[:, None]
            y = torch.einsum("bihn,bhnp->bihp", C_, op(S)) \
                * torch.exp(cA)[..., None] \
                + torch.einsum("bijh,bjhp->bihp", op(W), x_)
        dd = dt_ * torch.exp(last[:, None] - cA)
        S = S * torch.exp(last)[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", op(B_ * dd[..., None]), x_)
        return S, y, torch.exp(last)

    zero = torch.zeros((b, h, B.shape[3], p), dtype=torch.float32,
                       device=x.device)
    run, ys = zero, []
    for gi in range(G):
        end, decay = zero, torch.ones_like(zero[..., 0, 0])
        for c in range(gi * group, (gi + 1) * group):
            end, _, e = chunk(end, c, False)
            decay = decay * e
        S = run
        for c in range(gi * group, (gi + 1) * group):
            S, y, _ = chunk(S, c, True)
            ys.append(y)
        run = run * decay[..., None, None] + end
    return torch.cat(ys, 1)[:, :s].to(x.dtype)


def _operand(t, split):
    """What an exact tensor-core product sees of the float32 operand t
    split into `split` truncated bf16 parts (`trunc_parts`, the sum of the
    parts; three are t); t itself when `split` is None."""
    if split is None:
        return t
    parts = trunc_parts(t, split)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _state_step(S, x_, dt_, A, B_, split=None):
    """One chunk forward: S (b, h, p, n) <- exp(c_L) S + sum_j (x_j dt_j
    exp(c_L - c_j)) B_j^T, the scaled x split into `split` parts (the
    bf16 kernel splits the scaled B: the same product, exact at three)."""
    cA = torch.cumsum(dt_ * A, dim=1)
    v = x_ * (dt_ * torch.exp(cA[:, -1:] - cA))[..., None]
    upd = torch.einsum("bjhp,bjhn->bhpn", _operand(v, split), B_)
    return S * torch.exp(cA[:, -1])[..., None, None] + upd


def _grad_step(dS, dy_, dt_, A, C_, split=None):
    """One chunk in reverse: the gradient of the chunk's outgoing state
    (b, h, p, n) to that of its incoming state, exp(c_L) dS + sum_i
    (exp(c_i) dy_i) C_i^T, the scaled dy split into `split` parts (the
    bf16 kernel splits the scaled C: the same product, exact at three)."""
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
    `split` takes W, GE, S and dS' as the sums of that many truncated
    bf16 parts there, as the bf16 kernel does."""
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
    the walks' scaled x and dy) taken as the sum of that many truncated
    bf16 parts (`trunc_parts`)."""
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
    heads of each of the g B/C groups, in head order, the last set of a
    group short when heads does not divide h / g: (b, s, g, nsplit, n),
    nsplit = ceil((h / g) / heads).  The bf16 backward kernel's blocks sum
    their heads so."""
    heads = BWD_HEADS if heads is None else heads
    b, s, h, n = t.shape
    hpg = h // g
    nsplit = -(-hpg // heads)
    t = torch.nn.functional.pad(t.reshape(b, s, g, hpg, n),
                                (0, 0, 0, nsplit * heads - hpg))
    t = t.reshape(b, s, g, nsplit, heads, n)
    out = t[:, :, :, :, 0]
    for k in range(1, heads):
        out = out + t[:, :, :, :, k]
    return out


def ssd_scan_bwd_fold_plain(x, dt, A, B, C, dy, states=None, *, parts=3,
                            chunk=TILE, group=GROUP_CHUNKS, heads=None):
    """The bf16 backward kernels' arithmetic in plain PyTorch, float32: the
    CPU tests' stand-in for them.  Every float32 operand the kernels split
    (S, dS', W and G o E; in the walks the scaled x and dy, where the
    kernels split the scaled B and C) is taken as the sum of its first
    `parts` truncated bf16 parts (`trunc_parts`; three are the operand).  `states` are the forward's group
    states as the kernel keeps them, (b, h, G, n, p) float32 (None:
    computed here).  Launch 1, two walks per group: forward from the
    group's state, every chunk's incoming state; in reverse from a zero
    gradient, each chunk's local dS' (from the group's later rows) and the
    product of the decays after it, which end in the group's own
    incoming-state gradient and decay.  Launch 2: the gradient of every
    group's outgoing state, from the last group to the first.  Launch 3,
    per `chunk`-row chunk (the kernels' `TILE`): dS' = local + decay x its
    group's outgoing gradient, the chunk's gradient (`_chunk_grads`), dB
    and dC summed over sets of `heads` heads of a B/C group in head order
    (`head_sets`), the sets after.  A ragged tail reads as dt = 0.
    Returns dx, dB, dC in x's dtype, ddt and dA float32."""
    s, g = x.shape[1], B.shape[2]
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
                            Bh[:, cut[c]], parts)
        X, f = torch.zeros_like(S), torch.ones_like(S[..., 0, 0])
        for c in reversed(span):
            loc[c], fac[c] = X, f
            X = _grad_step(X, dyf[:, cut[c]], dtf[:, cut[c]], A,
                           Ch[:, cut[c]], parts)
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
                         tri, split=parts)
            for c, sl in enumerate(cut)]
    dx, ddt, dA, dBh, dCh = zip(*outs)
    dx, ddt, dBh, dCh = (torch.cat(t, 1)[:, :s] for t in (dx, ddt, dBh, dCh))
    dB, dC = (head_sets(t, g, heads).sum(3).to(x.dtype) for t in (dBh, dCh))
    return dx.to(x.dtype), ddt, torch.stack(dA).sum((0, 1)), dB, dC


def bwd_launch_grids(x, B) -> list:
    """The backward's launches of one call at p 64 and one n-block, as
    csrc/ssd_scan_bwd.cu makes them: (name, grid (x, y, z), threads a
    block, heads a block).  bf16: the walks over 2 G groups (forward and
    reverse), a head a block; the pass (G > 1); the chunk blocks over the
    nc tiles, sets of `BWD_HEADS` heads of one B/C group (grid y: g sets
    of ceil((h / g) / BWD_HEADS), `block_heads`); each bf16 block is one
    warpgroup, whose thread 0 also issues the TMA copies.  float32: a
    head a block over the G groups.  Shapes and dtype only: meta tensors
    will do."""
    b, s, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    G, nc = n_groups(s), -(-s // TILE)
    pas = [("pass", (n * 64 // 256, h, b), 256, 1)] if G > 1 else []
    if x.dtype == torch.float32:
        return [("state", (G, h, b), 256, 1), *pas, ("scan", (G, h, b), 256, 1)]
    sets = -(-(h // g) // BWD_HEADS)
    return [("walk", (2 * G, h, b), BWD_THREADS, 1), *pas,
            ("chunk", (nc, g * sets, b), BWD_THREADS, BWD_HEADS)]


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


def kernel_launches(s: int, n: int = 64) -> int:
    """Kernels one scan at sequence length s and n state columns launches:
    per n-block (`state_blocks`) the three passes of the split, or the
    scan alone when one group holds every tile."""
    return len(state_blocks(n)) * (1 if n_groups(s) == 1 else 3)


def launch_grids(x, B) -> list:
    """The launches of one call at p 64 and one n-block for x (b, s, h,
    64) and B (b, s, g, n), as csrc/ssd_scan.cu makes them: (name, grid
    (x, y, z), threads a block, heads a block).  bf16 blocks take the
    heads of one B/C group in sets of `STATE_HEADS` (launch 1) or `HEADS`
    (launch 3), a group's last set short when they do not divide h / g
    (grid y: g sets of ceil((h / g) / heads)), a warpgroup a head and a
    producer (launch 1 a warp, the scan a warpgroup); float32 blocks one
    head.  Shapes and dtype only: meta tensors will do."""
    b, s, h, _ = x.shape
    g, n = B.shape[2], B.shape[3]
    G, hpg = n_groups(s), h // g

    def per(heads, producer):
        if x.dtype == torch.float32:
            return h, 256, 1
        return g * -(-hpg // heads), heads * 128 + producer, heads
    out = []
    if G > 1:
        y1, t1, k1 = per(STATE_HEADS, 32)
        out += [("state", (G - 1, y1, b), t1, k1),
                ("pass", (n * 64 // 256, h, b), 256, 1)]
    y3, t3, k3 = per(HEADS, 128)
    return out + [("scan", (G, y3, b), t3, k3)]


def block_heads(h: int, g: int, heads: int, y: int) -> list:
    """The heads block y of a bf16 launch takes (`launch_grids`): set y %
    sets of B/C group y // sets, up to `heads` consecutive heads."""
    hpg = h // g
    sets = -(-hpg // heads)
    first = (y % sets) * heads
    return [(y // sets) * hpg + first + i
            for i in range(min(heads, hpg - first))]


@functools.lru_cache(maxsize=None)
def _lib(entry="ssd_scan_launch"):
    from . import build
    lib = build.load("ssd_scan")
    fn = getattr(lib, entry)
    n_ptr = 8 if entry == "ssd_scan_launch" else 7
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 \
        + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_heads.argtypes = [ctypes.c_int, ctypes.c_int]
    for launch, heads in ((1, STATE_HEADS), (3, HEADS)):
        for n in STATE_DIMS:
            if lib.ssd_scan_heads(launch, n) != heads:
                raise RuntimeError(
                    f"csrc/ssd_scan.cu takes {lib.ssd_scan_heads(launch, n)}"
                    f" heads a block in launch {launch} at n {n}, "
                    f"ssd_scan.py {heads}")
    return fn


def state_blocks(n: int) -> list:
    """The n-blocks a scan with n state columns runs as: (first column,
    end column, the built width the block is zero-padded to), 128 columns
    a block, the last narrower block padded to the next of `STATE_DIMS`."""
    top = STATE_DIMS[-1]
    return [(n0, min(n, n0 + top),
             next(w for w in STATE_DIMS if min(n, n0 + top) - n0 <= w))
            for n0 in range(0, max(n, 1), top)]


def kernel_widths(p: int, n: int) -> tuple:
    """The (p, n) the kernels run a (p, n) scan at: p zero-padded to a
    multiple of 64 (blocks of 64 columns, run as heads), n the sum of its
    blocks' built widths (`state_blocks`)."""
    top = HEAD_DIMS[-1]
    return -(-p // top) * top, sum(w for _, _, w in state_blocks(n))


def _p_view(t, k):
    """t (b, s, h, p) zero-padded to k blocks of 64 columns and viewed as
    (b, s, h k, 64)."""
    b, s, h, _ = t.shape
    t = _pad_cols(t, k * HEAD_DIMS[-1])
    return t if k == 1 else t.reshape(b, s, h * k, HEAD_DIMS[-1])


def _p_blocks(x, dt, A):
    """x in p-blocks of 64 columns run as heads (`_p_view`), dt and A
    repeated k times over the heads, and k.  Head h k + j reads B/C group
    h // rep, as head h does: y's p columns and the state's p rows never
    mix."""
    k = -(-x.shape[3] // HEAD_DIMS[-1])
    if k == 1:
        return _p_view(x, k), dt, A, k
    return (_p_view(x, k), dt.repeat_interleave(k, dim=2),
            A.repeat_interleave(k), k)


def ssd_blocked(x, dt, A, B, C, scan):
    """y of the scan at any p and n, from `scan(x, dt, A, B, C, f32) ->
    (y, aux)` run at the built widths: x in p-blocks of 64 folded into the
    heads (`_p_blocks`), B / C in n-blocks (`state_blocks`), one call a
    block.  y is linear in the n-blocks of (B, C) (C B^T and C state^T are
    sums over n, and the state's n columns evolve apart), so y is the sum
    of the blocks' y, taken in float32 (`f32` asks the block for a float32
    y) and rounded once to x's dtype.  Returns (y, [aux of each block]).
    On the card `scan` launches the kernel; the CPU tests hand it the
    plain version."""
    b, s, h, p = x.shape
    xv, dtv, Av, _ = _p_blocks(x, dt, A)
    blocks = state_blocks(B.shape[3])
    parts = [scan(xv, dtv, Av, B[..., n0:n1], C[..., n0:n1], len(blocks) > 1)
             for n0, n1, _ in blocks]
    y = parts[0][0]
    for part, _ in parts[1:]:
        y = y + part
    y = y.to(x.dtype).reshape(b, s, h, -1)
    if y.shape[3] != p:
        y = y[..., :p].contiguous()
    return y, [a for _, a in parts]


def ssd_blocked_bwd(x, dt, A, B, C, dy, bwd):
    """(dx, ddt, dA, dB, dC) at any p and n from `bwd(x, dt, A, B, C, dy,
    j, f32) -> the five gradients of n-block j` at the built widths, the
    blocks of `ssd_blocked`: dx, ddt and dA are summed over the n-blocks in
    float32 (dx rounded once), dB and dC are the blocks' side by side;
    then ddt and dA are summed over each head's p-blocks in float32 and dx
    viewed back."""
    b, s, h, p = x.shape
    xv, dtv, Av, k = _p_blocks(x, dt, A)
    dyv = _p_view(dy, k)
    blocks = state_blocks(B.shape[3])
    parts = [bwd(xv, dtv, Av, B[..., n0:n1], C[..., n0:n1], dyv, j,
                 len(blocks) > 1) for j, (n0, n1, _) in enumerate(blocks)]
    dx, ddt, dA, dB, dC = parts[0]
    for gx, gdt, gA, _, _ in parts[1:]:
        dx, ddt, dA = dx + gx, ddt + gdt, dA + gA
    if len(parts) > 1:
        dB, dC = (torch.cat([g[i] for g in parts], -1) for i in (3, 4))
    dx = dx.to(x.dtype).reshape(b, s, h, -1)
    if dx.shape[3] != p:
        dx = dx[..., :p].contiguous()
    if k > 1:
        ddt = ddt.reshape(b, s, h, k).sum(-1)
        dA = dA.reshape(h, k).sum(-1)
    return dx, ddt, dA, dB, dC


def _tma_ready(t) -> bool:
    """Whether the bf16 kernels' TMA maps read the (b, s, heads, cols)
    tensor t where it lies: the last axis dense, the other strides (of
    the axes longer than one) and the base on 16 bytes."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and t.stride(i) % 8 == 0
        for i in range(3) if t.shape[i] > 1)


def _strides(t) -> tuple:
    """The element strides (head, row, batch) of a (b, s, heads, cols)
    tensor as the launchers take them; an axis of one reads as dense."""
    b, s, k, c = t.shape
    dense = (c, k * c, s * k * c)
    return tuple(t.stride(i) if t.shape[i] > 1 else d
                 for i, d in zip((2, 1, 0), dense))


def _prepare(x, dt, A, B, C, views=False):
    """Checked, 16-byte aligned inputs of one block (x at p 64), B and C
    padded to the block's built width, and the split's scratch at those
    widths.  dt and A dense; x, B, C dense too, unless `views` and the
    bf16 kernels' TMA maps read them where they lie (`_tma_ready`)."""
    b, s, h, p = x.shape
    if max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"ssd_scan on the card: b = {b}, {h} heads (p-blocks "
                         f"of 64 counted as heads); a grid dimension above "
                         f"{MAX_GRID_YZ} does not launch")
    n = next(w for w in STATE_DIMS if B.shape[3] <= w)
    # the float32 kernels (and the backward) copy dense row-major 16-byte
    # rows with cp.async; the bf16 forward's maps take strided views, such
    # as the model's x/B/C, views into the conv output
    keep = views and x.dtype == torch.bfloat16
    ins = [x, dt, A, _pad_cols(B, n), _pad_cols(C, n)]
    ins = [t if keep and i in (0, 3, 4) and _tma_ready(t) else t.contiguous()
           for i, t in enumerate(ins)]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    G = n_groups(s)
    states = decay = None
    if G > 1:                   # group states and decays of the split
        states = ins[0].new_empty((b, h, G, n, p), dtype=torch.float32)
        decay = ins[0].new_empty((b, h, G), dtype=torch.float32)
    return ins, states, decay


def _dims(x, B, f32=False) -> tuple:
    """The launchers' int arguments: b, s, h, p, g, n, the chunk (always
    the kernels' `TILE`, never the caller's), the group, the dtype code
    (2: bf16 inputs with a float32 y, or dx, for a sum over n-blocks)."""
    b, s, h, p = x.shape
    code = 2 if f32 and x.dtype == torch.bfloat16 else DTYPES[x.dtype]
    return (b, s, h, p, B.shape[2], B.shape[3], TILE, GROUP_CHUNKS, code)


def _fwd_args(ins, f32=False) -> tuple:
    """The forward launchers' arguments after the pointers: `_dims`, then
    the element strides of x, B and C (`_strides`)."""
    return (*_dims(ins[0], ins[3], f32), *_strides(ins[0]),
            *_strides(ins[3]), *_strides(ins[4]))


def _ssd_cuda(x, dt, A, B, C, *, states=False):
    """Launch csrc/ssd_scan.cu on the current stream (no sync), one call
    (`kernel_launches(s)` kernels) an n-block (`ssd_blocked`).  Returns y,
    or with `states` (y, the group states): the float32 incoming state of
    every group, (b, h k, G, n', 64) at the kernels' widths (p in k blocks
    of 64 run as heads, n' the n-blocks' built widths side by side), which
    launch 2 writes into the split's scratch (None when one group holds
    every tile: its state is zero).  Asking for them changes no launch."""
    def block(x_, dt_, A_, B_, C_, f32):
        global LAUNCHES
        ins, st, decay = _prepare(x_, dt_, A_, B_, C_, views=True)
        y = torch.empty_like(ins[0],
                             dtype=torch.float32 if f32 else x_.dtype,
                             memory_format=torch.contiguous_format)
        _call(_lib("ssd_scan_launch"), (*ins, y, st, decay),
              _fwd_args(ins, f32), "ssd_scan")
        LAUNCHES += kernel_launches(x_.shape[1])
        return y, st

    y, st = ssd_blocked(x, dt, A, B, C, block)
    if states and st[0] is not None and len(st) > 1:
        st = [torch.cat(st, 3)]
    return (y, st[0]) if states else y


@functools.lru_cache(maxsize=1)
def _bwd_lib():
    from . import build
    lib = build.load("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 \
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
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


def _bwd_block(x, dt, A, B, C, dy, states, f32):
    """One backward call (`bwd_kernel_launches(s)` kernels) at p 64 and
    an n-block, from that block's group states.  Returns dx (float32 when
    `f32`, else x's dtype), ddt and dA float32, dB and dC in x's dtype at
    the block's true width.  bf16 x / B / C / dy are read where they lie
    when the TMA maps take them (`_tma_ready`, as the forward's), else
    copied dense.  The kernel writes float32 dB / dC rows (`bwd_rows`)
    and dA parts per (batch, head, group) in float32 or per (batch, head,
    tile) in bf16, summed here."""
    global BWD_LAUNCHES
    n0 = B.shape[3]
    ins, _, _ = _prepare(x, dt, A, B, C, views=True)
    x, B = ins[0], ins[3]
    if not (x.dtype == torch.bfloat16 and _tma_ready(dy)):
        dy = dy.contiguous()
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
    fl = dict(dtype=torch.float32, device=x.device)
    chunk_states = torch.empty((b, h, nc, n, p), **fl)
    dstates = torch.empty((b, h, G, n, p), **fl) if G > 1 else None
    gdecay = torch.empty((b, h, G), **fl)
    dsloc = torch.empty((b, h, nc, n, p), **fl) if bf else None
    facs = torch.empty((b, h, nc), **fl) if bf else None
    dx = torch.empty_like(x, dtype=torch.float32 if f32 else x.dtype,
                          memory_format=torch.contiguous_format)
    ddt = torch.empty((b, s, h), **fl)
    rows = bwd_rows(h, g, x.dtype)
    dBp, dCp = (torch.empty((b, s, rows, n), **fl) for _ in range(2))
    dAp = torch.empty((b, h, nc if bf else G), **fl)
    _call(_bwd_lib(), (*ins, dy, states if G > 1 else None, chunk_states,
                       dstates, gdecay, dsloc, facs, dx, ddt, dBp, dCp, dAp),
          (*_dims(x, B, f32), *_strides(x), *_strides(B), *_strides(ins[4]),
           *_strides(dy)), "ssd_scan backward")
    BWD_LAUNCHES += 1
    dB, dC = (t.view(b, s, g, rows // g, n).sum(3)[..., :n0].to(x.dtype)
              for t in (dBp, dCp))
    return dx, ddt, dAp.sum((0, 2)), dB, dC


def _ssd_bwd_cuda(x, dt, A, B, C, dy, states):
    """Launch csrc/ssd_scan_bwd.cu on the current stream (no sync), one
    call an n-block (`ssd_blocked_bwd`), each from its columns of the
    forward's group states (`_ssd_cuda(..., states=True)`, at the kernels'
    widths).  Returns (dx, ddt, dA, dB, dC): dx, dB, dC in x's dtype, ddt
    and dA float32.  A padded call pads dy with zeros as well, so the
    padded columns add nothing to ddt and dA."""
    _check(x, dt, A, B, C)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not fit x {tuple(x.shape)} {x.dtype}")
    blocks = state_blocks(B.shape[3])
    offs = [sum(w for *_, w in blocks[:j]) for j in range(len(blocks))]

    def block(x_, dt_, A_, B_, C_, dy_, j, f32):
        st = states
        if st is not None and len(blocks) > 1:
            st = st[:, :, :, offs[j]:offs[j] + blocks[j][2]].contiguous()
        return _bwd_block(x_, dt_, A_, B_, C_, dy_, st, f32)
    return ssd_blocked_bwd(x, dt, A, B, C, dy, block)


class SSDScan(torch.autograd.Function):
    """The forward kernel keeping its group states, and the backward
    kernel as its gradient, both at the kernels' `TILE` (the caller's
    chunk only orders the plain version's sums).  Saves x, dt, A, B, C
    (the model's views, uncopied) and the group states; the backward
    takes dy as it comes (the wrapper copies what its maps cannot read).
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
        return _ssd_bwd_cuda(x, dt, A, B, C, dy, states)


def ssd_group_states_cuda(x, dt, A, B, C):
    """The kernel's launches 1-2 alone on CUDA tensors, one call an
    n-block: the float32 incoming state of every group, (b, G, h, p, n)
    like `ssd_split_states_plain` at chunk `TILE`, at the true widths (the
    padded rows and columns are zero; the p-blocks' rows and the
    n-blocks' columns laid back side by side).  For the card's checks of
    the split's state products; s must span more than one group.  Adds
    its two launches an n-block to `LAUNCHES`."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"ssd_group_states_cuda takes CUDA tensors, got "
                         f"{x.device}")
    _check(x, dt, A, B, C)
    if n_groups(x.shape[1]) < 2:
        raise ValueError(f"s = {x.shape[1]} fits one group: no group states")
    b, _, h, p = x.shape
    xv, dtv, Av, k = _p_blocks(x, dt, A)
    out = []
    for n0, n1, _ in state_blocks(B.shape[3]):
        ins, states, decay = _prepare(xv, dtv, Av, B[..., n0:n1],
                                      C[..., n0:n1], views=True)
        _call(_lib("ssd_scan_states_launch"), (*ins, states, decay),
              _fwd_args(ins), "ssd_scan")
        LAUNCHES += 2
        G = states.shape[2]
        out.append(states.permute(0, 2, 1, 4, 3)
                   .reshape(b, G, h, k * HEAD_DIMS[-1], -1)[..., :n1 - n0])
    return torch.cat(out, -1)[..., :p, :]
