"""gemma3-4b [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k.

head_dim=256 (decoupled from d_model), dual RoPE base (10k local / 1M
global), sliding window 1024 on local layers, embeddings scaled by sqrt(D).
Sub-quadratic eligible for long_500k: 5/6 of layers are windowed.
"""
import dataclasses

import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab=262144,
        window=1024, local_global_pattern=5,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        embed_scale=True, sub_quadratic=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        window=16, local_global_pattern=5,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        embed_scale=True, sub_quadratic=True, compute_dtype=torch.float32)


def tuned() -> ModelConfig:
    """SSPerf winner: static-window local attention (O(S*w) kv slices for
    the 28 sliding-window layers, grouped scans) + 2048 chunks.
    prefill_32k memory term 67.8s -> 6.59s (10.3x); train_4k 23.6 -> 9.9s."""
    return dataclasses.replace(config(), static_local_attn=True,
                               attn_chunk_q=2048, attn_chunk_k=2048)
