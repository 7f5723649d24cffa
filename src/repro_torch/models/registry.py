"""Architecture registry: arch id -> (config, model module).

Every arch of the reference's registry; an unknown id raises, naming
the ported ones.
"""
from __future__ import annotations

import importlib

from . import mamba_lm, transformer, whisper

ARCHS = {
    "olmo-1b":             ("repro_torch.configs.olmo_1b", transformer),
    "gemma3-4b":           ("repro_torch.configs.gemma3_4b", transformer),
    "granite-3-2b":        ("repro_torch.configs.granite_3_2b", transformer),
    "yi-34b":              ("repro_torch.configs.yi_34b", transformer),
    "zamba2-1.2b":         ("repro_torch.configs.zamba2_1p2b", mamba_lm),
    "mamba2-2.7b":         ("repro_torch.configs.mamba2_2p7b", mamba_lm),
    "whisper-medium":      ("repro_torch.configs.whisper_medium", whisper),
    "phi-3-vision-4.2b":   ("repro_torch.configs.phi3_vision_4p2b",
                            transformer),
    "moonshot-v1-16b-a3b": ("repro_torch.configs.moonshot_v1_16b_a3b",
                            transformer),
    "dbrx-132b":           ("repro_torch.configs.dbrx_132b", transformer),
}


def get(arch: str, smoke: bool = False):
    """Returns (ModelConfig, model module)."""
    if arch not in ARCHS:
        raise NotImplementedError(
            f"unknown arch {arch!r} (ported: {arch_names()})")
    mod_path, model = ARCHS[arch]
    cfg_mod = importlib.import_module(mod_path)
    return (cfg_mod.smoke() if smoke else cfg_mod.config()), model


def arch_names() -> list[str]:
    return list(ARCHS)
