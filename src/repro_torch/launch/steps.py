"""Train / prefill / decode steps (the reference's `launch/steps.py`,
single card, so no sharding, no `env` and no `serve_shard`)."""
from __future__ import annotations

import torch

from .. import tree as _tree
from ..training import optimizer as opt_lib

_PORTED = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _check_family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; see "
            f"ROADMAP.md")


def value_and_grad(loss_of, params):
    """(loss, gradient tree) of `loss_of(params)` (the reference's
    `jax.value_and_grad`): the leaves are detached copies that require a
    gradient, so `params` itself is left as it is.  A leaf the loss does
    not use gets a zero gradient, as in JAX (zamba2 cut below
    `attn_every` layers never calls its shared block)."""
    leaves = [p.detach().requires_grad_() for p in _tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_of(_tree.unflatten(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), _tree.unflatten(params, list(grads))


def make_train_step(cfg, model, opt_cfg: opt_lib.OptConfig | None = None):
    """`train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`: value and gradient of `model.loss_fn`, then one AdamW
    `update`; metrics {"grad_norm", "lr", "loss"}."""
    _check_family(cfg)
    opt_cfg = opt_cfg or opt_lib.OptConfig()

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: model.loss_fn(p, cfg, batch), params)
        new_params, new_opt, metrics = opt_lib.update(
            opt_cfg, grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg, model):
    """`prefill_step(params, inputs)`: for the transformer families
    (last hidden (B, D), KV cache), as the reference returns; the VLM
    reads `inputs["vision_embeds"]`, the encoder-decoder
    `inputs["frames"]`.  SSM / hybrid prefill == forward: the last
    position's hidden (B, D), what serving consumes."""
    _check_family(cfg)

    def prefill_step(params, inputs):
        if cfg.family == "encdec":
            return model.prefill(params, cfg, inputs["tokens"],
                                 inputs["frames"])
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
