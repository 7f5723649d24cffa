"""whisper-medium [arXiv:2212.04356; unverified] — encoder-decoder, conv
frontend stubbed (callers give precomputed frame embeddings).

24 encoder + 24 decoder layers, D 1024, 16 heads of 64, d_ff 4096, vocab
51 865, 1500 audio frames (Whisper's n_audio_ctx).
"""
import dataclasses

import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="encdec",
        n_layers=24, dec_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865, audio_frames=1500)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="encdec",
        n_layers=2, dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, audio_frames=32, compute_dtype=torch.float32)


def tuned() -> ModelConfig:
    """The reference's XLA-path chunk tuning; the chunks are carried and
    mean nothing on the card, where the flash kernel serves every
    attention."""
    return dataclasses.replace(config(), attn_chunk_q=2048,
                               attn_chunk_k=2048)
