"""Architecture config schema + input shape sets (the reference's
`configs/base.py` with torch dtypes).

Every ported architecture has one file in this package with its published
configuration; ``smoke()`` returns a reduced same-family config for CPU
tests.  Shapes follow the reference: train_4k / prefill_32k / decode_32k /
long_500k.

The distribution knobs (`sequence_parallel`, `attn_seq_shard`,
`remat_policy`, `pure_dp`, `ce_chunk`, `use_pallas`) and
`capacity_factor` are carried so that configs compare field for field
with the reference's; on one card they mean nothing: the port has no
mesh, no rematerialisation, no Pallas switch (the kernel dispatch goes by
device) and no capacity-clamped MoE dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.ssd import SSDConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None
    window: Optional[int] = None
    local_global_pattern: int = 0    # gemma3: 5 local per 1 global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25    # mesh dispatch only (inert here)
    moe_aux_weight: float = 0.01
    # SSM / hybrid
    ssm: Optional[SSDConfig] = None
    attn_every: int = 0              # zamba2: shared attn after every k mamba
    # modality frontends (stubs, as in the reference)
    vision_tokens: int = 0
    vision_embed_dim: int = 1024
    audio_frames: int = 0            # whisper encoder context
    dec_layers: int = 0
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    embed_scale: bool = False
    # scalable-attention chunking
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    # distribution knobs of the reference's mesh (inert on one card)
    sequence_parallel: bool = False
    attn_seq_shard: bool = False
    remat_policy: str = "nothing"
    ce_chunk: int = 512
    pure_dp: bool = False
    static_local_attn: bool = False  # local layers on a static window
    # long-context behaviour
    long_context_window: Optional[int] = None   # hybrid attn fallback window
    sub_quadratic: bool = False      # eligible for long_500k
    use_pallas: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * D
        attn = D * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim + \
            self.n_heads * self.head_dim * D
        if self.n_experts:
            mlp = 3 * D * F * self.n_experts + D * self.n_experts
        else:
            mlp = 3 * D * F
        if self.family in ("ssm", "hybrid"):
            ssm = self.ssm
            blk = D * (2 * ssm.d_inner + 2 * ssm.n_groups * ssm.d_state +
                       ssm.n_heads) + ssm.d_inner * D
            shared = attn + 3 * D * F if self.family == "hybrid" else 0
            return emb + L * blk + shared
        if self.family == "encdec":
            return emb + (self.n_layers + self.dec_layers) * (attn + mlp) + \
                self.dec_layers * attn
        return emb + L * (attn + mlp)

    @property
    def n_active_params(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense = self.n_params - L * 3 * D * F * self.n_experts
        return dense + L * 3 * D * F * self.top_k


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; long_500k needs sub-quadratic"
    return True, ""
