"""yi-34b [arXiv:2403.04652; hf] — llama-arch GQA, largest dense arch."""
import dataclasses

import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab=64000)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab=256, compute_dtype=torch.float32)


def tuned() -> ModelConfig:
    """SSPerf winner: sequence-parallel residual + context-parallel
    attention (56 heads don't divide the 16-way tensor axis) + full-seq
    attention chunks.  Modeled step bound 209s -> 13.0s (16x) on train_4k."""
    return dataclasses.replace(
        config(), sequence_parallel=True, attn_seq_shard=True,
        attn_chunk_q=4096, attn_chunk_k=4096)
