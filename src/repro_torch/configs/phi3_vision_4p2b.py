"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct; hf] —
phi3-mini backbone + CLIP frontend (stub: input_specs provides patch
embeddings, 576 tokens @ 1024-d, projected into the text stream)."""
import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        vision_tokens=576, vision_embed_dim=1024)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        vision_tokens=8, vision_embed_dim=32, compute_dtype=torch.float32)
