"""Mamba2 (pure SSM) and Zamba2 (hybrid) language models (the reference's
`models/mamba_lm.py`).

mamba2-2.7b  [arXiv:2405.21060]: stacked SSD blocks, attention-free.
zamba2-1.2b  [arXiv:2411.15242]: Mamba2 backbone + ONE weight-shared
transformer block (full attention + MLP) invoked after every
``cfg.attn_every`` mamba layers; the trailing ``n_layers % attn_every``
mamba layers run after the last invocation (38 = 6 x 6 + 2).

Parameters are the reference's tree as tensors: per-layer leaves stacked
on a leading layer axis, ``shared`` holding ``norm1``/``attn``/``norm2``/
``mlp``.  Prefill runs every mamba layer's SSD scan through
`kernels.ssd_scan` and every shared-block attention through
`kernels.flash_attention` (CUDA kernels on the card, their plain versions
on the CPU).  Decode is one token through plain PyTorch ops.

Single-card: the reference's sharding constraints are the identity
without a mesh, so the port takes no `env`.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..kernels import flash_attention as _flash
from ..kernels import ssd_scan as _ssd_scan
from ..nn import attention as attn_lib
from ..nn import core, ssd


def init(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Random parameters with the reference `init`'s shapes and scales,
    drawn from `gen` (torch's stream, not the reference's) on the CPU and
    moved to `device`: `gen` is a CPU generator, and one seed gives the
    same weights on every device."""
    device = _device.resolve(device)
    dtype = cfg.param_dtype
    layers = [{"norm": core.rmsnorm_init(cfg.d_model, dtype, device),
               "mamba": ssd.mamba2_init(gen, cfg.ssm, dtype, device)}
              for _ in range(cfg.n_layers)]
    params = {
        "embed": core.embed_init_params(gen, cfg.vocab, cfg.d_model, dtype,
                                        device),
        "layers": _stack(layers),
        "final_norm": core.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if cfg.attn_every:                       # zamba2 shared block (tied)
        params["shared"] = {
            "norm1": core.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_lib.attn_init(gen, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim, dtype,
                                       device),
            "norm2": core.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": core.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                 device=device),
        }
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


def _mamba_layer(p, cfg, x):
    h = core.rmsnorm_apply(p["norm"], x)
    scan = functools.partial(_ssd_scan.ssd_scan, chunk=cfg.ssm.chunk)
    return x + ssd.mamba2_apply(p["mamba"], cfg.ssm, h, ssd_fn=scan)


def _shared_block(p, cfg, x, window):
    S = x.shape[1]
    h = core.rmsnorm_apply(p["norm1"], x)
    q, k, v = attn_lib.qkv_proj(p["attn"], h)
    pos = torch.arange(S, device=x.device)[None, :]
    q = attn_lib.rope(q, pos, cfg.rope_theta)
    k = attn_lib.rope(k, pos, cfg.rope_theta)
    # the kernel's plain version makes the reference's S > 2048 switch
    # between sdpa and chunked_attention
    o = _flash.flash_attention(q, k, v.contiguous(), causal=True,
                               window=window)
    x = x + attn_lib.out_proj(p["attn"], o)
    h = core.rmsnorm_apply(p["norm2"], x)
    return x + core.mlp_apply(p["mlp"], h)


def _backbone(params, cfg, h, window, remat=False):
    """Every mamba layer and shared-block call; with `remat` each mamba
    layer runs under activation checkpointing, as the reference's scan
    body does (the shared block is not checkpointed there either)."""
    n = cfg.n_layers
    k = cfg.attn_every
    n_full = n // k if k else 0

    def mamba(i, x):
        p = _layer(params["layers"], i)
        if remat:
            return checkpoint(_mamba_layer, p, cfg, x, use_reentrant=False)
        return _mamba_layer(p, cfg, x)

    for c in range(n_full):
        for i in range(c * k, (c + 1) * k):
            h = mamba(i, h)
        h = _shared_block(params["shared"], cfg, h, window)
    for i in range(n_full * k, n):           # trailing mamba layers
        h = mamba(i, h)
    return h


def _forward(params, cfg, tokens, window=None, remat=False):
    h = core.embed_apply(params["embed"], tokens, cfg.compute_dtype)
    h = _backbone(params, cfg, h, window, remat)
    h = core.rmsnorm_apply(params["final_norm"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


@torch.no_grad()
def forward(params, cfg, tokens, *, window=None):
    """tokens (B, S) int -> (final hidden (B, S, D), zero aux loss)."""
    return _forward(params, cfg, tokens, window)


def loss_fn(params, cfg, batch, *, remat=True):
    """Chunked cross-entropy of the final hidden against
    `batch["labels"]` (masked by `batch["mask"]` where given).  On the
    card every SSD scan's gradient comes from the backward kernel
    (`kernels.ssd_scan.SSDScan`) and every shared block's attention
    gradient from flash's (`FlashAttention`); on the CPU autograd runs
    through the plain versions."""
    h, _ = _forward(params, cfg, batch["tokens"], remat=remat)
    return core.chunked_softmax_xent(params["embed"]["table"], h,
                                     batch["labels"], batch.get("mask"),
                                     chunk=min(cfg.ce_chunk, h.shape[1]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device="cuda") -> dict:
    device = _device.resolve(device)
    s = cfg.ssm
    cache = {
        "conv": torch.zeros((cfg.n_layers, batch, s.d_conv - 1, s.conv_dim),
                            dtype=dtype, device=device),
        "ssd": torch.zeros((cfg.n_layers, batch, s.n_heads, s.head_dim,
                            s.d_state), dtype=torch.float32, device=device),
    }
    if cfg.attn_every:
        n_inv = cfg.n_layers // cfg.attn_every
        kv_len = min(max_len, cfg.long_context_window or max_len) \
            if max_len > 32_768 else max_len
        cache["k"] = torch.zeros((n_inv, batch, kv_len, cfg.n_kv_heads,
                                  cfg.head_dim), dtype=dtype, device=device)
        cache["v"] = torch.zeros_like(cache["k"])
    return cache


@torch.no_grad()
def decode_step(params, cfg, token, cache, cur_len):
    """One token (B,) at position `cur_len` through the SSM backbone (+ the
    shared attention for zamba2).  Returns (logits (B, V), new cache); the
    input cache is left as it was."""
    cur_len = int(cur_len)
    h = core.embed_apply(params["embed"], token[:, None],
                         cfg.compute_dtype)[:, 0]
    conv_out, ssd_out, k_out, v_out = [], [], [], []

    def mamba(i, x):
        p = _layer(params["layers"], i)
        hn = core.rmsnorm_apply(p["norm"], x[:, None, :])[:, 0]
        y, new = ssd.mamba2_step(p["mamba"], cfg.ssm, hn,
                                 {"conv": cache["conv"][i],
                                  "ssd": cache["ssd"][i]})
        conv_out.append(new["conv"])
        ssd_out.append(new["ssd"])
        return x + y

    n = cfg.n_layers
    k = cfg.attn_every
    n_full = n // k if k else 0
    sp = params.get("shared")
    for c in range(n_full):
        for i in range(c * k, (c + 1) * k):
            h = mamba(i, h)
        # shared attention block, one invocation's KV cache
        kv_len = cache["k"].shape[2]   # ring-buffer length (= window if long)
        hn = core.rmsnorm_apply(sp["norm1"], h[:, None, :])
        q, kq, vq = attn_lib.qkv_proj(sp["attn"], hn)
        pos = torch.full((1, 1), cur_len, device=h.device)
        q = attn_lib.rope(q, pos, cfg.rope_theta)
        kq = attn_lib.rope(kq, pos, cfg.rope_theta)
        slot = cur_len % kv_len
        kc = cache["k"][c].clone()
        vc = cache["v"][c].clone()
        kc[:, slot] = kq[:, 0].to(kc.dtype)
        vc[:, slot] = vq[:, 0].to(vc.dtype)
        o = attn_lib.decode_attention(q[:, 0], kc, vc,
                                      min(cur_len + 1, kv_len))
        h = h + attn_lib.out_proj(sp["attn"], o[:, None, :])[:, 0]
        hn = core.rmsnorm_apply(sp["norm2"], h[:, None, :])
        h = h + core.mlp_apply(sp["mlp"], hn)[:, 0]
        k_out.append(kc)
        v_out.append(vc)
    for i in range(n_full * k, n):
        h = mamba(i, h)
    h = core.rmsnorm_apply(params["final_norm"], h[:, None, :])[:, 0]
    logits = core.unembed_logits(params["embed"]["table"], h)
    new_cache = {"conv": torch.stack(conv_out), "ssd": torch.stack(ssd_out)}
    if k_out:
        new_cache["k"] = torch.stack(k_out)
        new_cache["v"] = torch.stack(v_out)
    return logits, new_cache
