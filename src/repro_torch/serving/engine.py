"""Batched serving engine: admission queue + prefill + decode slots (the
reference's `serving/engine.py`), and the admission-queue drain that the
design twin's micro-batching shares (`drain_microbatched`).

Continuous-batching-lite: a fixed number of decode slots; a batch of
queued requests is left-padded with token 0, its prompts are fed token
by token through the model's `decode_step` (teacher-forced), and it then
decodes greedily (argmax) until every request has its tokens.  The cache
is float32, as in the reference.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


def drain_microbatched(queue: list, window: int, eval_batch: Callable,
                       max_items: int | None = None, lock=None) -> list:
    """Generic admission-queue drain for batched serving: pop up to
    `window` queued items at a time, evaluate each micro-batch with ONE
    `eval_batch(batch) -> results` call, and collect the results in
    submission order (at most `max_items` items total).

    `lock`, when given, guards only the queue mutation — never the
    evaluation — so `eval_batch` may itself serialize on the same lock
    (the `DesignTwin.run` shape) and concurrent producers may keep
    submitting while a batch is in flight."""
    guard = lock if lock is not None else contextlib.nullcontext()
    finished: list = []
    budget = float("inf") if max_items is None else max_items
    while budget > 0:
        with guard:
            batch = queue[: int(min(window, budget))]
            del queue[: len(batch)]
        if not batch:
            break
        finished.extend(eval_batch(batch))
        budget -= len(batch)
    return finished


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0


class Server:
    """Single-card server; runs on the device that holds `params`.

    The reference builds its cache in float32 and concatenates the mamba
    layers' activations onto it, which promotes them: with a lower
    `compute_dtype` its SSM and hybrid families fail inside the decode
    step.  This port raises at construction in that case instead of
    promoting quietly."""

    def __init__(self, cfg, model, params, *, batch_slots: int = 4,
                 max_len: int = 256, eos: int = 1):
        if cfg.family in ("ssm", "hybrid") and \
                cfg.compute_dtype != torch.float32:
            raise ValueError(
                f"Server serves the {cfg.family} family ({cfg.name}) in "
                f"float32 only: its cache is float32 and compute_dtype "
                f"{cfg.compute_dtype} would be promoted inside the mamba "
                f"decode step (the reference fails there)")
        self.cfg, self.model, self.params = cfg, model, params
        self.max_len = max_len
        self.slots = batch_slots
        self.eos = eos
        self.queue: list[Request] = []
        self.stats = ServeStats()
        self.device = params["embed"]["table"].device

    def submit(self, req: Request):
        self.queue.append(req)

    def _decode(self, token, cache, cur_len):
        return self.model.decode_step(self.params, self.cfg, token, cache,
                                      cur_len)

    def _prefill_batch(self, reqs: list[Request]):
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt   # left-pad
        # repro: ignore[R002]: one push of a batch's prompts
        toks = torch.as_tensor(toks, device=self.device)
        cache = self.model.init_cache(self.cfg, B, self.max_len,
                                      torch.float32, self.device)
        # teacher-forced prompt pass token by token
        logits = None
        for t in range(S):
            logits, cache = self._decode(toks[:, t], cache, t)
        self.stats.prefills += B
        return logits, cache, S

    def run(self, max_steps: int = 512) -> list[Request]:
        finished: list[Request] = []
        while self.queue and max_steps > 0:
            batch = self.queue[: self.slots]
            self.queue = self.queue[self.slots:]
            logits, cache, pos = self._prefill_batch(batch)
            next_tok = torch.argmax(logits, dim=-1)
            for _ in range(max(r.max_new_tokens for r in batch)):
                max_steps -= 1
                # repro: ignore[R002]: greedy decode hands each step's tokens
                # to the host (EOS and length checks): the Server's one sync a
                # step
                toks = next_tok.tolist()
                for i, r in enumerate(batch):
                    if not r.done and len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(toks[i])
                        self.stats.tokens_out += 1
                        if toks[i] == self.eos:
                            r.done = True
                if all(r.done or len(r.out_tokens) >= r.max_new_tokens
                       for r in batch) or pos + 1 >= self.max_len:
                    break
                logits, cache = self._decode(next_tok, cache, pos)
                self.stats.decode_steps += 1
                pos += 1
                next_tok = torch.argmax(logits, dim=-1)
            finished.extend(batch)
        return finished
