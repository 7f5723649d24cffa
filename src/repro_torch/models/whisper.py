"""Whisper-medium encoder-decoder backbone [arXiv:2212.04356] (the
reference's `models/whisper.py`).

The conv audio frontend is a stub, as in the reference: callers give
precomputed frame embeddings (B, audio_frames, D).  The encoder is
bidirectional self-attention over the 1500 frames; the decoder is causal
self-attention, then cross-attention to the encoder output (no RoPE on
the encoder's K / V), then an ungated GELU MLP (tanh approximation, as
`jax.nn.gelu`).

Parameters are the reference's tree as tensors: `embed`, `pos_embed`
(audio_frames, D), `enc_layers` / `dec_layers` stacked on a leading
layer axis, `enc_norm`, `final_norm`.  Every full-sequence attention
(encoder self, decoder self, cross) goes through
`kernels.flash_attention.flash_attention`: the CUDA kernel on the card
(bidirectional at Sq = Sk = 1500, causal, and bidirectional at Sq !=
Sk), its plain version on the CPU, which takes the reference's `sdpa` up
to 2048 query rows.  `decode_step` is plain PyTorch, one token through
`decode_attention`, writing its K / V row into the cache in place as
`transformer.decode_step` does.

`loss_fn` is differentiable (grad mode on): on the card every attention
runs the flash kernel's autograd function, whose backward is the
backward kernel.  With `remat` each layer runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint`).  Single
card: no `env` and no `serve_shard`.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..kernels import flash_attention as _flash
from ..nn import attention as attn_lib
from ..nn import core


def _enc_layer_init(gen, cfg, dtype, device) -> dict:
    return {
        "norm1": core.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn_lib.attn_init(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, dtype,
                                   device),
        "norm2": core.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": core.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=False,
                             device=device),
    }


def _dec_layer_init(gen, cfg, dtype, device) -> dict:
    p = _enc_layer_init(gen, cfg, dtype, device)
    p["norm_x"] = core.rmsnorm_init(cfg.d_model, dtype, device)
    p["xattn"] = attn_lib.attn_init(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype,
                                    device)
    return p


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Random parameters with the reference `init`'s shapes and scales,
    drawn from `gen` (torch's stream, not the reference's) on the CPU and
    moved to `device`: `gen` is a CPU generator, and one seed gives the
    same weights on every device."""
    device = _device.resolve(device)
    dtype = cfg.param_dtype
    return {
        "embed": core.embed_init_params(gen, cfg.vocab, cfg.d_model, dtype,
                                        device),
        "pos_embed": core.trunc_normal(gen, (cfg.audio_frames, cfg.d_model),
                                       dtype, 0.02, device),
        "enc_layers": _stack([_enc_layer_init(gen, cfg, dtype, device)
                              for _ in range(cfg.n_layers)]),
        "enc_norm": core.rmsnorm_init(cfg.d_model, dtype, device),
        "dec_layers": _stack([_dec_layer_init(gen, cfg, dtype, device)
                              for _ in range(cfg.dec_layers)]),
        "final_norm": core.rmsnorm_init(cfg.d_model, dtype, device),
    }


def _heads(x, w):
    """x (B, S, D) @ w (D, H, Dh) -> (B, S, H, Dh)."""
    w = w.to(x.dtype)
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).reshape(*x.shape[:-1], h, dh)


def _self_attn(p, cfg, x, *, causal: bool):
    """Self-attention with RoPE from position 0; returns (y, k, v)."""
    q, k, v = attn_lib.qkv_proj(p, x)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q = attn_lib.rope(q, pos, cfg.rope_theta)
    k = attn_lib.rope(k, pos, cfg.rope_theta)
    o = _flash.flash_attention(q, k, v, causal=causal, window=None)
    return attn_lib.out_proj(p, o), k, v


def _enc_kv(p, enc):
    """The cross-attention's K / V of the encoder output (no RoPE)."""
    return _heads(enc, p["wk"]), _heads(enc, p["wv"])


def _cross_attn(p, x, enc_kv):
    k, v = enc_kv
    o = _flash.flash_attention(_heads(x, p["wq"]), k, v, causal=False,
                               window=None)
    return attn_lib.out_proj(p, o)


def _enc_layer(p, cfg, x):
    a, _, _ = _self_attn(p["attn"], cfg, core.rmsnorm_apply(p["norm1"], x),
                         causal=False)
    x = x + a
    return x + core.mlp_apply(p["mlp"], core.rmsnorm_apply(p["norm2"], x),
                              activation="gelu")


def _dec_layer(p, cfg, x, enc_kv):
    """One decoder layer; returns (x, k, v) with its self-attention's K /
    V after RoPE, as the cache holds them."""
    a, k, v = _self_attn(p["attn"], cfg, core.rmsnorm_apply(p["norm1"], x),
                         causal=True)
    x = x + a
    x = x + _cross_attn(p["xattn"], core.rmsnorm_apply(p["norm_x"], x),
                        enc_kv)
    x = x + core.mlp_apply(p["mlp"], core.rmsnorm_apply(p["norm2"], x),
                           activation="gelu")
    return x, k, v


def _dec_layer_train(p, cfg, x, enc):
    x, _, _ = _dec_layer(p, cfg, x, _enc_kv(p["xattn"], enc))
    return x


def _encode(params, cfg, frames, remat=False):
    h = frames.to(cfg.compute_dtype) + \
        params["pos_embed"].to(cfg.compute_dtype)[None]
    for i in range(cfg.n_layers):
        p = _layer(params["enc_layers"], i)
        h = checkpoint(_enc_layer, p, cfg, h, use_reentrant=False) \
            if remat else _enc_layer(p, cfg, h)
    return core.rmsnorm_apply(params["enc_norm"], h)


def _decode_train(params, cfg, tokens, enc, remat=False):
    h = core.embed_apply(params["embed"], tokens, cfg.compute_dtype)
    for i in range(cfg.dec_layers):
        p = _layer(params["dec_layers"], i)
        h = checkpoint(_dec_layer_train, p, cfg, h, enc, use_reentrant=False) \
            if remat else _dec_layer_train(p, cfg, h, enc)
    return core.rmsnorm_apply(params["final_norm"], h)


@torch.no_grad()
def encode(params, cfg, frames):
    """frames: (B, audio_frames, D) stub embeddings -> encoder states."""
    return _encode(params, cfg, frames)


@torch.no_grad()
def decode_train(params, cfg, tokens, enc):
    """Teacher-forced decoder pass: tokens (B, S) -> hidden (B, S, D)."""
    return _decode_train(params, cfg, tokens, enc)


@torch.no_grad()
def forward(params, cfg, tokens, *, frames):
    """(final decoder hidden (B, S, D), zero aux loss)."""
    h = _decode_train(params, cfg, tokens, _encode(params, cfg, frames))
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(params, cfg, batch, *, remat=True):
    """Chunked cross-entropy of the decoder's final hidden against
    `batch["labels"]` (masked by `batch["mask"]` where given), the
    encoder reading `batch["frames"]`."""
    enc = _encode(params, cfg, batch["frames"], remat)
    h = _decode_train(params, cfg, batch["tokens"], enc, remat)
    return core.chunked_softmax_xent(params["embed"]["table"], h,
                                     batch["labels"], batch.get("mask"),
                                     chunk=min(cfg.ce_chunk, h.shape[1]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> dict:
    """Decoder self-attention K / V (L, B, max_len, KvH, Dh) and the
    cross-attention's encoder K / V (L, B, audio_frames, KvH, Dh)."""
    device = _device.resolve(device)
    L, kvh, dh = cfg.dec_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(s):
        return torch.zeros((L, batch, s, kvh, dh), dtype=dtype,
                           device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.audio_frames), "xv": zeros(cfg.audio_frames)}


@torch.no_grad()
def prefill(params, cfg, tokens, frames, *, max_len: int | None = None):
    """Encoder + teacher-forced prompt pass; returns (last hidden (B, D),
    cache {"k", "v" (zero past S), "xk", "xv"})."""
    B, S = tokens.shape
    max_len = max_len or S
    enc = _encode(params, cfg, frames)
    h = core.embed_apply(params["embed"], tokens, cfg.compute_dtype)
    cache = {"k": [], "v": [], "xk": [], "xv": []}
    for i in range(cfg.dec_layers):
        p = _layer(params["dec_layers"], i)
        xk, xv = _enc_kv(p["xattn"], enc)
        h, k, v = _dec_layer(p, cfg, h, (xk, xv))
        for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
            # repro: ignore[R006]: one cross-attention cache entry per decoder
            # layer, stacked once after the loop
            cache[name].append(t)
    h = core.rmsnorm_apply(params["final_norm"], h)

    def stack(ts, length):
        out = torch.zeros((len(ts), B, length) + tuple(ts[0].shape[2:]),
                          dtype=ts[0].dtype, device=ts[0].device)
        for i, t in enumerate(ts):
            out[i, :, :t.shape[1]] = t
        return out

    return h[:, -1, :], {"k": stack(cache["k"], max_len),
                         "v": stack(cache["v"], max_len),
                         "xk": stack(cache["xk"], cfg.audio_frames),
                         "xv": stack(cache["xv"], cfg.audio_frames)}


@torch.no_grad()
def decode_step(params, cfg, token, cache, cur_len):
    """One decode step.  token: (B,) int; cur_len: count of valid cache
    positions (int or 0-dim tensor).  Writes position `cur_len` of every
    layer's K / V into `cache` in place and returns (logits (B, V),
    cache)."""
    # repro: ignore[R002]: cur_len is the caller's host position (the Server
    # passes an int); int() only normalises it
    cur_len = int(cur_len)
    h = core.embed_apply(params["embed"], token[:, None],
                         cfg.compute_dtype)[:, 0]
    pos = torch.full((1, 1), cur_len, device=h.device)
    for i in range(cfg.dec_layers):
        p = _layer(params["dec_layers"], i)
        hn = core.rmsnorm_apply(p["norm1"], h[:, None, :])
        q, k, v = attn_lib.qkv_proj(p["attn"], hn)
        q = attn_lib.rope(q, pos, cfg.rope_theta)
        k = attn_lib.rope(k, pos, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, cur_len] = k[:, 0].to(kc.dtype)
        vc[:, cur_len] = v[:, 0].to(vc.dtype)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, cur_len + 1)
        h = h + attn_lib.out_proj(p["attn"], o[:, None, :])[:, 0]
        # cross-attention against the fixed encoder K / V
        hx = core.rmsnorm_apply(p["norm_x"], h[:, None, :])
        qx = _heads(hx, p["xattn"]["wq"])
        xk = cache["xk"][i]
        ox = attn_lib.decode_attention(qx[:, 0], xk, cache["xv"][i],
                                       xk.shape[1])
        h = h + attn_lib.out_proj(p["xattn"], ox[:, None, :])[:, 0]
        hn = core.rmsnorm_apply(p["norm2"], h[:, None, :])
        h = h + core.mlp_apply(p["mlp"], hn, activation="gelu")[:, 0]
    h = core.rmsnorm_apply(params["final_norm"], h[:, None, :])[:, 0]
    logits = core.unembed_logits(params["embed"]["table"], h)
    return logits, cache
