"""Decoder-only transformer for the dense, local/global, VLM and MoE archs
(the reference's `models/transformer.py`).

Covers olmo-1b (non-parametric LayerNorm), gemma3-4b (5:1 local:global,
window 1024 on local layers, RoPE base 1e4 local / 1e6 global, embeddings
scaled by sqrt(D)), granite-3-2b, yi-34b, phi-3-vision-4.2b (projected
vision rows first), moonshot-v1-16b-a3b and dbrx-132b (MoE).

Parameters are the reference's tree as tensors: per-layer leaves stacked
on a leading layer axis.  The reference scans one layer body with traced
per-layer flags; here the layers run in a Python loop and the flags
(`layer_flags`) are plain numbers.  Every layer's prefill attention goes
through `kernels.flash_attention.flash_attention` (the CUDA kernel on the
card, its plain version on the CPU, which switches between `sdpa` and
`chunked_attention` at S > 2048 as the reference's `_attn_full` does); a
global layer passes no window (the reference's `BIG_WINDOW`), a local one
its window.  The kernel skips the kv tiles before a block's window, so
a local layer costs O(S * w) on this one path: `static_local_attn`
(gemma3's `tuned()`, the reference's grouped scan over static kv
slices) changes nothing here.  MoE layers take `nn.moe.moe_apply` (the reference's
single-device `moe_apply_dense`, computed per expert).  Decode is one
token through plain PyTorch ops.

Training: `loss_fn` (chunked cross-entropy + the MoE aux loss) is
differentiable; with `remat` each layer runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint`), and on the
card the flash dispatch runs the kernel's autograd function, whose
backward is the backward kernel (the recompute launches the forward
again).

Single card: the reference's sharding constraints are the identity
without a mesh, so the port takes no `env`, and `decode_step` no
`serve_shard` (the reference's `sharded_decode_attention` needs a mesh).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..kernels import flash_attention as _flash
from ..nn import attention as attn_lib
from ..nn import core
from ..nn import moe as moe_lib

BIG_WINDOW = 1 << 30  # the reference's "no window" sentinel


def _layer_init(gen, cfg, dtype, device) -> dict:
    p = {
        "norm1": core.norm_init(cfg.norm, cfg.d_model, dtype, device),
        "attn": attn_lib.attn_init(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, dtype,
                                   device),
        "norm2": core.norm_init(cfg.norm, cfg.d_model, dtype, device),
    }
    if cfg.n_experts:
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, dtype, device)
    else:
        p["mlp"] = core.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                 device=device)
    return p


def init(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Random parameters with the reference `init`'s shapes and scales,
    drawn from `gen` (torch's stream, not the reference's) on the CPU and
    moved to `device`: `gen` is a CPU generator, and one seed gives the
    same weights on every device."""
    device = _device.resolve(device)
    dtype = cfg.param_dtype
    params = {
        "embed": core.embed_init_params(gen, cfg.vocab, cfg.d_model, dtype,
                                        device),
        "layers": _stack([_layer_init(gen, cfg, dtype, device)
                          for _ in range(cfg.n_layers)]),
        "final_norm": core.norm_init(cfg.norm, cfg.d_model, dtype, device),
    }
    if cfg.vision_tokens:
        params["patch_proj"] = core.dense_init(
            gen, (cfg.vision_embed_dim, cfg.d_model), dtype, device=device)
    return params


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer `i` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def layer_flags(cfg) -> dict:
    """Per-layer window (`BIG_WINDOW` on global layers) and RoPE theta,
    as lists of numbers."""
    windows, thetas = [], []
    for i in range(cfg.n_layers):
        if cfg.local_global_pattern:
            pat = cfg.local_global_pattern + 1       # e.g. 5 local : 1 global
            is_global = i % pat == pat - 1
        else:
            is_global = True
        windows.append(BIG_WINDOW if is_global or not cfg.window
                       else cfg.window)
        thetas.append(float(cfg.rope_theta_global or cfg.rope_theta)
                      if is_global else float(cfg.rope_theta))
    return {"window": windows, "theta": thetas}


def _attn(p, cfg, x, window: int, theta: float):
    """Full-sequence attention (prefill) through the flash dispatch;
    returns (y, k, v) with k after RoPE, as the cache holds them."""
    S = x.shape[1]
    q, k, v = attn_lib.qkv_proj(p, x)
    pos = torch.arange(S, device=x.device)[None, :]
    q = attn_lib.rope(q, pos, theta)
    k = attn_lib.rope(k, pos, theta)
    o = _flash.flash_attention(q, k, v, causal=True,
                               window=None if window >= BIG_WINDOW
                               else window)
    return attn_lib.out_proj(p, o), k, v


def _layer_apply(p, cfg, x, window: int, theta: float):
    """One layer: returns (x, aux, k, v)."""
    h = core.norm_apply(cfg.norm, p["norm1"], x)
    a, k, v = _attn(p["attn"], cfg, h, window, theta)
    x = x + a
    h = core.norm_apply(cfg.norm, p["norm2"], x)
    if cfg.n_experts:
        m, aux = moe_lib.moe_apply(p["moe"], h, cfg.top_k)
    else:
        m = core.mlp_apply(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux, k, v


def _scale(h, cfg):
    """sqrt(D) rounded to h's dtype first, as the reference multiplies."""
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def embed_tokens(params, cfg, tokens, vision_embeds=None):
    """tokens (B, S) -> (B, S, D); with vision embeddings the projected
    vision rows come first and the last text positions are dropped."""
    h = _scale(core.embed_apply(params["embed"], tokens, cfg.compute_dtype),
               cfg)
    if cfg.vision_tokens and vision_embeds is not None:
        vis = vision_embeds.to(cfg.compute_dtype) @ \
            params["patch_proj"].to(cfg.compute_dtype)
        h = torch.cat([vis, h[:, : h.shape[1] - vis.shape[1]]], dim=1)
    return h


def _backbone(params, cfg, h, remat: bool = False):
    """All layers; returns (h, aux, ks, vs).  With `remat` each layer runs
    under activation checkpointing (the reference's
    `jax.checkpoint(nothing_saveable)`: only the layer's input is kept,
    the layer runs again in the backward pass) and no K / V is kept."""
    flags = layer_flags(cfg)
    auxes, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        args = (_layer(params["layers"], i), cfg, h, flags["window"][i],
                flags["theta"][i])
        if remat:
            h, aux = checkpoint(_layer_train, *args, use_reentrant=False)
        else:
            h, aux, k, v = _layer_apply(*args)
            # repro: ignore[R006]: one cache entry per layer, stacked once
            # after the loop
            ks.append(k)
            # repro: ignore[R006]: one cache entry per layer, stacked once
            # after the loop
            vs.append(v)
        # repro: ignore[R006]: one aux loss per layer, summed once after the
        # loop
        auxes.append(aux)
    return h, torch.stack(auxes).mean(), ks, vs


def _layer_train(p, cfg, x, window: int, theta: float):
    """One layer without its K / V: (x, aux)."""
    x, aux, _, _ = _layer_apply(p, cfg, x, window, theta)
    return x, aux


def _forward(params, cfg, tokens, vision_embeds=None, remat=False):
    h = embed_tokens(params, cfg, tokens, vision_embeds)
    h, aux, _, _ = _backbone(params, cfg, h, remat)
    return core.norm_apply(cfg.norm, params["final_norm"], h), aux


@torch.no_grad()
def forward(params, cfg, tokens, *, vision_embeds=None):
    """tokens (B, S) -> (final hidden (B, S, D), MoE aux loss (scalar))."""
    return _forward(params, cfg, tokens, vision_embeds)


def loss_fn(params, cfg, batch, *, remat=True):
    """Chunked cross-entropy of the final hidden against `batch["labels"]`
    (masked by `batch["mask"]` where given) plus `moe_aux_weight` x the
    MoE aux loss; the VLM reads `batch["vision_embeds"]`.  Differentiable
    (grad mode on): on the card the flash dispatch runs its autograd
    function."""
    h, aux = _forward(params, cfg, batch["tokens"],
                      batch.get("vision_embeds"), remat)
    ce = core.chunked_softmax_xent(params["embed"]["table"], h,
                                   batch["labels"], batch.get("mask"),
                                   chunk=min(cfg.ce_chunk, h.shape[1]))
    return ce + cfg.moe_aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> dict:
    device = _device.resolve(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(params, cfg, tokens, *, vision_embeds=None,
            max_len: int | None = None):
    """Run the full prompt; returns (last hidden (B, D), cache {"k", "v"}
    of (L, B, max_len, KvH, Dh), zero past S)."""
    B, S = tokens.shape
    max_len = max_len or S
    h = embed_tokens(params, cfg, tokens, vision_embeds)
    h, _, ks, vs = _backbone(params, cfg, h)
    h = core.norm_apply(cfg.norm, params["final_norm"], h)

    def stack(ts):
        out = torch.zeros((len(ts), B, max_len) + tuple(ts[0].shape[2:]),
                          dtype=ts[0].dtype, device=ts[0].device)
        for i, t in enumerate(ts):
            out[i, :, :S] = t
        return out

    return h[:, -1, :], {"k": stack(ks), "v": stack(vs)}


@torch.no_grad()
def decode_step(params, cfg, token, cache, cur_len):
    """One decode step.  token: (B,) int; cur_len: count of valid cache
    positions (int or 0-dim tensor).  Every layer masks with its flag's
    window (`BIG_WINDOW` on global layers).  Writes position `cur_len`
    of every layer's K / V into `cache` in place and returns (logits
    (B, V), cache)."""
    # repro: ignore[R002]: cur_len is the caller's host position (the Server
    # passes an int); int() only normalises it
    cur_len = int(cur_len)
    h = _scale(core.embed_apply(params["embed"], token[:, None],
                                cfg.compute_dtype), cfg)[:, 0]
    flags = layer_flags(cfg)
    pos = torch.full((1, 1), cur_len, device=h.device)
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        theta = flags["theta"][i]
        hn = core.norm_apply(cfg.norm, p["norm1"], h[:, None, :])
        q, k, v = attn_lib.qkv_proj(p["attn"], hn)
        q = attn_lib.rope(q, pos, theta)
        k = attn_lib.rope(k, pos, theta)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, cur_len] = k[:, 0].to(kc.dtype)
        vc[:, cur_len] = v[:, 0].to(vc.dtype)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, cur_len + 1,
                                      window=flags["window"][i])
        h = h + attn_lib.out_proj(p["attn"], o[:, None, :])[:, 0]
        hn = core.norm_apply(cfg.norm, p["norm2"], h[:, None, :])
        if cfg.n_experts:
            m, _ = moe_lib.moe_apply(p["moe"], hn, cfg.top_k)
        else:
            m = core.mlp_apply(p["mlp"], hn)
        h = h + m[:, 0]
    h = core.norm_apply(cfg.norm, params["final_norm"], h[:, None, :])[:, 0]
    logits = core.unembed_logits(params["embed"]["table"], h)
    return logits, cache
