"""Architecture registry: arch id -> (config, model module).

Only the ported architectures are here; any other id of the reference's
registry raises, naming ROADMAP.md, which lists what is still to port.
"""
from __future__ import annotations

import importlib

from . import mamba_lm

ARCHS = {
    "zamba2-1.2b": ("repro_torch.configs.zamba2_1p2b", mamba_lm),
    "mamba2-2.7b": ("repro_torch.configs.mamba2_2p7b", mamba_lm),
}


def get(arch: str, smoke: bool = False):
    """Returns (ModelConfig, model module)."""
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {arch_names()}); "
            f"see ROADMAP.md")
    mod_path, model = ARCHS[arch]
    cfg_mod = importlib.import_module(mod_path)
    return (cfg_mod.smoke() if smoke else cfg_mod.config()), model


def arch_names() -> list[str]:
    return list(ARCHS)
