"""Architecture config schema (the reference's `configs/base.py` with torch
dtypes), cut to the fields the ported families read.

Every ported architecture has one file in this package with its published
configuration; ``smoke()`` returns a reduced same-family config for CPU
tests.  A later slice adds the reference's other fields (MoE, modality
frontends, sharding knobs) with the code that reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.ssd import SSDConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # ssm | hybrid (the ported families)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    # SSM / hybrid
    ssm: Optional[SSDConfig] = None
    attn_every: int = 0              # zamba2: shared attn after every k mamba
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # long-context behaviour
    long_context_window: Optional[int] = None   # hybrid attn fallback window

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), as the
        reference counts it for the ssm and hybrid families."""
        D, F, L = self.d_model, self.d_ff, self.n_layers
        ssm = self.ssm
        blk = D * (2 * ssm.d_inner + 2 * ssm.n_groups * ssm.d_state +
                   ssm.n_heads) + ssm.d_inner * D
        total = self.vocab * D + L * blk
        if self.family == "hybrid":              # + the one shared block
            total += D * (self.n_heads + 2 * self.n_kv_heads) * \
                self.head_dim + self.n_heads * self.head_dim * D + 3 * D * F
        return total
