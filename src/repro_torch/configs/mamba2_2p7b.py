"""mamba2-2.7b [arXiv:2405.21060; unverified] — pure SSD, attention-free."""
import dataclasses

import torch

from ..nn.ssd import SSDConfig
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=1,
        d_ff=0, vocab=50280,
        ssm=SSDConfig(d_model=2560, d_state=128, head_dim=64, expand=2,
                      n_groups=1, chunk=64),
        sub_quadratic=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, head_dim=1,
        d_ff=0, vocab=256,
        ssm=SSDConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                      n_groups=1, chunk=8),
        sub_quadratic=True, compute_dtype=torch.float32)


def tuned() -> ModelConfig:
    """The reference's tuned config: pure data parallelism (a mesh knob,
    inert on one card) and SSD chunk 128 (the plain version's sum order;
    the card's kernels run their own 64-row tile, `kernels/ssd_scan.py`)."""
    cfg = config()
    return dataclasses.replace(cfg, pure_dp=True,
                               ssm=dataclasses.replace(cfg.ssm, chunk=128))
