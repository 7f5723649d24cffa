"""Attention substrate (the reference's `nn/attention.py`).

Three plain prefill paths, numerically interchangeable:

1. ``sdpa``                    — direct softmax(QK^T)V, for short
                                 sequences;
2. ``chunked_attention``       — blocked online-softmax attention that
                                 never holds more than (B, H, chunk_q,
                                 chunk_k) scores, for long prefill;
3. ``local_chunked_attention`` — sliding window in O(S * window), the
                                 reference's static-window path.

The model's prefill calls neither directly: it goes through
`kernels.flash_attention.flash_attention`, whose plain version picks
between them as the reference's model does (`S > 2048`), and whose CUDA
kernel replaces both on the card.  ``decode_attention`` serves one new
token against a KV cache.  The reference's ``sharded_decode_attention``
exists only on a mesh of devices (a KV cache sharded over its sequence
axis): the port runs on one card and has no counterpart.

Products of low-precision inputs are taken in float32, as the
reference's ``preferred_element_type=jnp.float32`` does.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # large-but-finite; avoids NaN from (-inf) - (-inf)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding [arXiv:2104.09864], computed in float32.

    x: (..., S, H, Dh); positions: broadcastable to (..., S).
    """
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    angle = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    angle = angle[..., None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(angle), torch.sin(angle)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype, device="cuda") -> dict:
    from .core import dense_init
    return {
        "wq": dense_init(gen, (d_model, n_heads, head_dim), dtype,
                         fan_in=d_model, device=device),
        "wk": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype,
                         fan_in=d_model, device=device),
        "wv": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype,
                         fan_in=d_model, device=device),
        "wo": dense_init(gen, (n_heads, head_dim, d_model), dtype,
                         fan_in=n_heads * head_dim, device=device),
    }


def qkv_proj(params: dict, x: torch.Tensor):
    """x: (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KvH, Dh)."""
    out = []
    for name in ("wq", "wk", "wv"):
        w = params[name].to(x.dtype)
        d, h, dh = w.shape
        out.append((x @ w.reshape(d, h * dh)).reshape(*x.shape[:-1], h, dh))
    return tuple(out)


def out_proj(params: dict, o: torch.Tensor) -> torch.Tensor:
    """o: (B, S, H, Dh) -> (B, S, D)."""
    w = params["wo"].to(o.dtype)
    h, dh, d = w.shape
    return o.reshape(*o.shape[:-2], h * dh) @ w.reshape(h * dh, d)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: int | None):
    """Additive bias (0 / NEG_INF) from absolute positions.

    q_pos: (Sq,), k_pos: (Sk,) -> (Sq, Sk) float32.
    """
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


# ---------------------------------------------------------------------------
# direct SDPA (short sequences)
# ---------------------------------------------------------------------------

def sdpa(q, k, v, *, causal=True, window=None, q_offset=0, scale=None,
         bidirectional=False):
    """q: (B,Sq,H,Dh), k/v: (B,Sk,KvH,Dh) -> (B,Sq,H,Dh)."""
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, KvH, G, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if not bidirectional:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (long prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      chunk_q=512, chunk_k=1024, scale=None,
                      bidirectional=False):
    """Flash-style attention as plain loops over (q block, kv block).

    Ragged lengths are padded to block multiples and masked.  A kv block
    wholly above the causal diagonal is skipped: in the reference's scan
    such a block leaves (m, l, acc) bit-for-bit unchanged (p = 0, alpha =
    1), so skipping it changes nothing.
    """
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    chunk_q = min(chunk_q, Sq)
    chunk_k = min(chunk_k, Sk)
    dev = q.device
    kv_valid = Sk
    nk = -(-Sk // chunk_k)
    nq = -(-Sq // chunk_q)
    pad_k = nk * chunk_k - Sk
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    q_valid = Sq
    pad_q = nq * chunk_q - Sq
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    qf = q.reshape(B, nq * chunk_q, KvH, G, Dh).float()
    kf, vf = k.float(), v.float()
    skip = causal and not bidirectional
    blocks = []
    for qi in range(nq):
        q_blk = qf[:, qi * chunk_q:(qi + 1) * chunk_q]
        q_pos = q_offset + qi * chunk_q + torch.arange(chunk_q, device=dev)
        m = torch.full((B, KvH, G, chunk_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KvH, G, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KvH, G, chunk_q, Dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            if skip and ki * chunk_k > q_offset + (qi + 1) * chunk_q - 1:
                break
            k_blk = kf[:, ki * chunk_k:(ki + 1) * chunk_k]
            v_blk = v[:, ki * chunk_k:(ki + 1) * chunk_k]
            k_pos = ki * chunk_k + torch.arange(chunk_k, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            if not bidirectional:
                s = s + _mask_bias(q_pos, k_pos, causal=causal,
                                   window=window)
            if kv_valid != nk * chunk_k:
                s = torch.where(k_pos < kv_valid, s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                              v_blk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KvH, G, chunk_q, Dh) -> (B, chunk_q, H, Dh)
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, H, Dh)
                      .to(q.dtype))
    return torch.cat(blocks, dim=1)[:, :q_valid]


def local_chunked_attention(q, k, v, *, window: int, chunk_q=512,
                            q_offset=0, scale=None):
    """Sliding-window attention in O(S * window), static window: each q
    block attends to one kv slice of (window + chunk_q) keys.  A plain
    function (the reference's static-window path); the port's model
    reaches the same function through the flash dispatch with `window`,
    whose CUDA kernel skips the kv tiles before a block's window."""
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    chunk_q = min(chunk_q, Sq)
    if Sq % chunk_q:
        raise ValueError(f"Sq {Sq} is not a multiple of chunk_q {chunk_q}")
    W = min(window + chunk_q, Sk)
    qf = q.reshape(B, Sq, KvH, G, Dh).float()
    blocks = []
    for q_lo in range(0, Sq, chunk_q):
        start = min(max(q_lo + chunk_q - W, 0), Sk - W)
        ks, vs = k[:, start:start + W], v[:, start:start + W]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q_lo:q_lo + chunk_q],
                         ks.float()) * scale
        q_pos = q_offset + q_lo + torch.arange(chunk_q, device=q.device)
        k_pos = start + torch.arange(W, device=q.device)
        ok = (k_pos[None, :] <= q_pos[:, None]) & \
            (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vs.dtype).float(),
                         vs.float())
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, chunk_q, H, Dh)
                      .to(q.dtype))
    return torch.cat(blocks, dim=1)


# ---------------------------------------------------------------------------
# decode attention (one new token vs a KV cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, cur_len, *, window=None, k_offset=0,
                     scale=None):
    """q: (B,H,Dh); k/v: (B,S,KvH,Dh); cur_len: tokens valid (int or
    0-dim tensor).  Returns (B,H,Dh); cache entries at positions >=
    cur_len (or outside the sliding window) are masked."""
    B, H, Dh = q.shape
    S, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, KvH, G, Dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale
    k_pos = k_offset + torch.arange(S, device=q.device)
    ok = k_pos < cur_len
    if window is not None:
        ok &= k_pos > cur_len - 1 - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, Dh).to(q.dtype)
