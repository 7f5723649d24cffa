"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm."""
import torch

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, norm="nonparametric_ln")


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, norm="nonparametric_ln",
        compute_dtype=torch.float32)
