"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base; hf] — dense GQA."""
import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=256, compute_dtype=torch.float32)
