"""Mamba2 / SSD (state-space duality) substrate [arXiv:2405.21060] (the
reference's `nn/ssd.py`).

Two plain paths:
  * ``ssd_reference`` — direct sequential recurrence (oracle, O(S) steps);
  * ``ssd_chunked``   — chunkwise-parallel SSD: quadratic intra-chunk block
                        plus a loop over chunk states.
The Mamba2 block's `ssd_fn` hook defaults to ``ssd_chunked``; the model
(`models.mamba_lm`) passes `kernels.ssd_scan.ssd_scan`, whose plain
version is ``ssd_chunked`` and whose CUDA kernel replaces it on the card.

Plus the full Mamba2 block (in_proj -> causal depthwise conv -> SSD ->
gated RMSNorm -> out_proj) with a single-token ``mamba2_step`` for decode.

Numerics kept from the reference: the SSD math runs in float32;
``softplus`` is ``logaddexp(x, 0)`` (``jax.nn.softplus``; torch's own
switches to the identity above 20); the causal conv is K shifted
multiply-adds in float32, not ``F.conv1d``, which cuDNN runs in TF32 for
float32 inputs by default.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import device as _device
from . import core


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64       # P
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# core SSD math
# ---------------------------------------------------------------------------

def ssd_reference(x, dt, A, B, C, state0=None):
    """Sequential oracle.  x:(b,s,h,p) dt:(b,s,h) A:(h,) B/C:(b,s,g,n).

    Returns y:(b,s,h,p), final state:(b,h,p,n).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()       # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2).float()
    state = state0 if state0 is not None else torch.zeros(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        dA = torch.exp(dtt * A)                                 # (b,h)
        upd = dtt[..., None, None] * x[:, t, ..., None].float() \
            * Bh[:, t, :, None, :]                              # (b,h,p,n)
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x, dt, A, B, C, state0=None, chunk=64):
    """Chunkwise-parallel SSD (the 'dual' quadratic-within-chunk form).

    A ragged tail is padded with dt = 0, which leaves the state unchanged.
    Returns y:(b,s,h,p) in x's dtype and the final state:(b,h,p,n) f32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk
    f32 = torch.float32
    state = state0 if state0 is not None else torch.zeros(
        (b, h, p, n), dtype=f32, device=x.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        dA = dtc.float() * A                                  # (b,L,h)
        cA = torch.cumsum(dA, dim=1)                          # inclusive
        seg = cA[:, :, None, :] - cA[:, None, :, :]           # (b,i,j,h)
        # exp only below the diagonal: above it seg > 0 can overflow, and
        # inf there would make the masked entries' gradient 0 * inf = NaN
        # (the reference's where(tri, exp(seg), 0) has that fault); the
        # values are the reference's
        zero = torch.zeros((), dtype=f32, device=x.device)
        low = tri[None, :, :, None]
        Ldec = torch.where(low, torch.exp(torch.where(low, seg, zero)), zero)
        Bh = Bc.repeat_interleave(rep, dim=2).float()         # (b,L,h,n)
        Ch = Cc.repeat_interleave(rep, dim=2).float()
        xdt = xc.float() * dtc[..., None].float()             # (b,L,h,p)
        cb = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        w = cb * Ldec
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xdt)
        y_inter = torch.einsum("bihn,bhpn->bihp", Ch, state) * \
            torch.exp(cA)[..., None]
        decay_out = torch.exp(cA[:, -1:, :] - cA)             # (b,L,h)
        upd = torch.einsum("bjhn,bjhp,bjh->bhpn", Bh, xdt, decay_out)
        state = state * torch.exp(cA[:, -1, :])[..., None, None] + upd
        # repro: ignore[R006]: one output per chunk of the plain SSD,
        # concatenated once (the card runs the SSD kernel)
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :s_orig], state


def ssd_step(state, xt, dtt, A, Bt, Ct):
    """Single-token recurrence for decode.

    state:(b,h,p,n) xt:(b,h,p) dtt:(b,h) Bt/Ct:(b,g,n) -> (y, state).
    """
    h = xt.shape[1]
    rep = h // Bt.shape[1]
    Bh = Bt.repeat_interleave(rep, dim=1).float()
    Ch = Ct.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dtt.float() * A)
    upd = dtt[..., None, None].float() * xt[..., None].float() \
        * Bh[:, :, None, :]
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(xt.dtype), state


# ---------------------------------------------------------------------------
# full Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg: SSDConfig, dtype, device="cuda") -> dict:
    """Drawn on the CPU from `gen` (a CPU generator), with dt_bias and
    A_log computed there, then moved to `device`."""
    device = _device.resolve(device)
    di, h = cfg.d_inner, cfg.n_heads
    proj_out = 2 * di + 2 * cfg.n_groups * cfg.d_state + h
    u = torch.rand((h,), generator=core.host_generator(gen))
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min))
                   + math.log(cfg.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # inverse softplus
    u = torch.rand((h,), generator=gen)
    return {
        "in_proj": core.dense_init(gen, (cfg.d_model, proj_out), dtype,
                                   device=device),
        "conv_w": core.trunc_normal(gen, (cfg.d_conv, 1, cfg.conv_dim),
                                    dtype, 1.0 / math.sqrt(cfg.d_conv),
                                    device),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(1.0 + u * 15.0).to(device),
        "D": torch.ones((h,), device=device),
        "dt_bias": dt_bias.float().to(device),
        "norm": core.rmsnorm_init(di, dtype, device),
        "out_proj": core.dense_init(gen, (di, cfg.d_model), dtype, fan_in=di,
                                    device=device),
    }


def _split_proj(cfg: SSDConfig, zxbcdt):
    di = cfg.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di:di + cfg.conv_dim],
            zxbcdt[..., di + cfg.conv_dim:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d + SiLU.  xBC: (B,S,C); w: (K,1,C).

    K shifted multiply-adds in float32, rounded once to xBC's dtype
    (``F.conv1d`` would go to cuDNN, in TF32 for float32 by default)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC.float(), (0, 0, K - 1, 0))
    wf = w[:, 0, :].to(xBC.dtype).float()
    y = pad[:, 0:S] * wf[0]
    for k in range(1, K):
        y = y + pad[:, k:k + S] * wf[k]
    y = y.to(xBC.dtype)
    return F.silu(y + b.to(xBC.dtype))


def mamba2_apply(params, cfg: SSDConfig, x, *, ssd_fn=None):
    """x: (B,S,D) -> (B,S,D).

    `ssd_fn(x, dt, A, B, C) -> y` runs the scan from a zero state; the
    default is ``ssd_chunked``, as in the reference."""
    Bsz, S, _ = x.shape
    di, g, n, h, p = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    dt_ = x.dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs = xBC[..., :di].reshape(Bsz, S, h, p)
    B_ = xBC[..., di:di + g * n].reshape(Bsz, S, g, n)
    C_ = xBC[..., di + g * n:].reshape(Bsz, S, g, n)
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if ssd_fn is None:
        ssd_fn = lambda *a: ssd_chunked(*a, chunk=cfg.chunk)[0]  # noqa: E731
    y = ssd_fn(xs, dt, A, B_, C_)
    y = y + xs * params["D"][None, None, :, None].to(dt_)
    y = y.reshape(Bsz, S, di)
    y = core.rmsnorm_apply(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(dt_)


def mamba2_init_cache(cfg: SSDConfig, batch: int, dtype, device="cuda"):
    device = _device.resolve(device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_step(params, cfg: SSDConfig, x_t, cache):
    """Single token decode.  x_t: (B,D) -> (y_t, cache).

    As in the reference, a conv cache wider than x_t's dtype promotes the
    conv history (and what follows) to the cache's dtype."""
    Bsz = x_t.shape[0]
    di, g, n, h, p = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.head_dim)
    dt_ = x_t.dtype
    zxbcdt = x_t @ params["in_proj"].to(dt_)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    hist = torch.cat([cache["conv"], xBC[:, None, :].to(
        torch.promote_types(cache["conv"].dtype, xBC.dtype))], dim=1)
    new_conv = hist[:, 1:, :]
    w = params["conv_w"][:, 0, :].to(dt_)                     # (K,C)
    xBC = F.silu(torch.einsum("bkc,kc->bc", hist, w.to(hist.dtype))
                 + params["conv_b"].to(dt_))
    xs = xBC[..., :di].reshape(Bsz, h, p)
    B_ = xBC[..., di:di + g * n].reshape(Bsz, g, n)
    C_ = xBC[..., di + g * n:].reshape(Bsz, g, n)
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_ssd = ssd_step(cache["ssd"], xs, dt, A, B_, C_)
    y = y + xs * params["D"][None, :, None].to(dt_)
    y = y.reshape(Bsz, di)
    y = core.rmsnorm_apply(params["norm"], y * F.silu(z))
    y = y @ params["out_proj"].to(dt_).to(y.dtype)
    return y, {"conv": new_conv, "ssd": new_ssd}
