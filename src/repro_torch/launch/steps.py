"""Prefill / decode steps (the reference's `launch/steps.py`, single
card, so no sharding, no `env` and no `serve_shard`)."""
from __future__ import annotations

_PORTED = ("dense", "moe", "vlm", "ssm", "hybrid")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; see "
            f"ROADMAP.md")


def make_prefill_step(cfg, model):
    """`prefill_step(params, inputs)`: for the transformer families
    (last hidden (B, D), KV cache), as the reference returns; the VLM
    reads `inputs["vision_embeds"]`.  SSM / hybrid prefill == forward:
    the last position's hidden (B, D), what serving consumes."""
    _check_family(cfg)

    def prefill_step(params, inputs):
        if cfg.family == "vlm":
            return model.prefill(params, cfg, inputs["tokens"],
                                 vision_embeds=inputs["vision_embeds"])
        if cfg.family in ("ssm", "hybrid"):
            h, _ = model.forward(params, cfg, inputs["tokens"])
            return h[:, -1, :]
        return model.prefill(params, cfg, inputs["tokens"])

    return prefill_step


def make_decode_step(cfg, model):
    """`decode_step(params, token, cache, cur_len) -> (logits, cache)`."""
    _check_family(cfg)

    def decode_step(params, token, cache, cur_len):
        return model.decode_step(params, cfg, token, cache, cur_len)

    return decode_step
