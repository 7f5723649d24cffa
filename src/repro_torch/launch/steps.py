"""Prefill / decode steps (the reference's `launch/steps.py`, for the
ported SSM and hybrid families; single card, so no sharding)."""
from __future__ import annotations

_PORTED = ("ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; see "
            f"ROADMAP.md")


def make_prefill_step(cfg, model):
    """`prefill_step(params, inputs) -> last hidden (B, D)`.  SSM prefill
    == forward; the last position's hidden is what serving consumes."""
    _check_family(cfg)

    def prefill_step(params, inputs):
        h, _ = model.forward(params, cfg, inputs["tokens"])
        return h[:, -1, :]

    return prefill_step


def make_decode_step(cfg, model):
    """`decode_step(params, token, cache, cur_len) -> (logits, cache)`."""
    _check_family(cfg)

    def decode_step(params, token, cache, cur_len):
        return model.decode_step(params, cfg, token, cache, cur_len)

    return decode_step
