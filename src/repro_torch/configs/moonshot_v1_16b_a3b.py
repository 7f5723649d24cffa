"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — fine-grained
MoE, 64 experts top-6, d_ff=1408 per expert."""
import dataclasses

import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840,
        n_experts=64, top_k=6)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256,
        n_experts=8, top_k=2, capacity_factor=2.0,
        compute_dtype=torch.float32)


def tuned() -> ModelConfig:
    """SSPerf (dbrx recipe transfers): Megatron-SP + seq-sharded MoE IO +
    pinned head-sharded attention + 2048 chunks.  train_4k bound
    12.3s -> 5.26s (2.3x); fits 15.0 GB/chip."""
    return dataclasses.replace(config(), sequence_parallel=True,
                               attn_chunk_q=2048, attn_chunk_k=2048)
