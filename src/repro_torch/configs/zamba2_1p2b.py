"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 backbone + weight-shared
attention block (invoked after every 6 mamba layers; 38 layers -> 6
invocations + 2 trailing mamba layers).  ssm_state=64.

long_500k: the shared attention uses a 4096 ring-buffer window.
"""
import torch

from ..nn.ssd import SSDConfig
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000,
        ssm=SSDConfig(d_model=2048, d_state=64, head_dim=64, expand=2,
                      n_groups=1, chunk=64),
        attn_every=6, sub_quadratic=True, long_context_window=4096)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ssm=SSDConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                      n_groups=1, chunk=8),
        attn_every=2, sub_quadratic=True, long_context_window=64,
        compute_dtype=torch.float32)
