"""Deterministic synthetic data pipeline (the reference's
`data/pipeline.py`).

A batch is a pure function of (seed, step, host): numpy's generator
seeded by `SeedSequence([seed, step, host_id])` makes the reference's
draws, so the batches equal the reference's bit for bit; they are handed
out as tensors on the requested device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .. import device as _device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def _put(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def lm_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Markov-ish synthetic tokens: int32 tokens and labels (the next
    token; 0 at the end) and a float32 mask (0 at the end), (B, S)."""
    dev = _device.resolve(device)
    rng = _batch_rng(cfg, step)
    B, S = cfg.host_batch, cfg.seq_len
    base = rng.integers(0, cfg.vocab, size=(B, 1))
    drift = rng.integers(-16, 17, size=(B, S)).cumsum(axis=1)
    tokens = (np.abs(base + drift) % cfg.vocab).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": _put(tokens, dev), "labels": _put(labels, dev),
            "mask": _put(mask, dev)}


def lm_batches(cfg: DataConfig, start_step: int = 0,
               device="cuda") -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, device)
        step += 1


def egocentric_batch(cfg: DataConfig, step: int, d_signal: int = 64,
                     device="cuda") -> dict:
    """Offloaded egocentric signal windows (gaze, pose, hands) and
    next-token narration targets (synthetic)."""
    dev = _device.resolve(device)
    rng = _batch_rng(cfg, step)
    B, S = cfg.host_batch, cfg.seq_len
    gaze = rng.standard_normal((B, S, 3)).cumsum(axis=1) * 0.01
    pose = rng.standard_normal((B, S, 6)).cumsum(axis=1) * 0.01
    hands = rng.standard_normal((B, S, 2, 21, 3)) * 0.1
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {
        "gaze": _put(gaze.astype(np.float32), dev),
        "pose": _put(pose.astype(np.float32), dev),
        "hands": _put(hands.reshape(B, S, -1).astype(np.float32), dev),
        "tokens": _put(tokens, dev), "labels": _put(labels, dev),
        "mask": torch.ones((B, S), dtype=torch.float32, device=dev),
    }
