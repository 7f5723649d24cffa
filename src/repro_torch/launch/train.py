"""Training driver: ``python -m repro_torch.launch.train --arch olmo-1b
--smoke --device cpu`` (the reference's `launch/train.py`, on one card).

Wires together the model zoo, the synthetic data pipeline, AdamW,
optional int8 gradient compression with error feedback, asynchronous
atomic checkpoints, restart from the latest one, SIGTERM handling and
the straggler watchdog.  The reference's mesh option has no counterpart:
one card.  The encoder-decoder's frames and the VLM's vision embeddings
are drawn per step from a CPU `torch.Generator` seeded by (17, step)
(the reference draws them from a threefry key folded by step), so runs
repeat and a resumed run sees the same inputs.  Every draw (weights and
side inputs) is made on the CPU and moved to the device, so one seed
gives the same run's inputs on the CPU and the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from .. import device as _device
from ..data.pipeline import DataConfig, lm_batch
from ..models import registry
from ..training import checkpoint as ckpt_lib
from ..training import compression as comp_lib
from ..training import optimizer as opt_lib
from ..training.elastic import StepWatchdog
from .steps import value_and_grad

DATA_SEED = 17                  # the side inputs' stream (the reference's)


def side_inputs(cfg, batch: int, step: int, device) -> dict:
    """The synthetic frames (encdec) or vision embeddings (vlm) of one
    step: standard normal, drawn on the CPU from a generator seeded by
    (DATA_SEED, step), then moved to `device`."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    seed = int(np.random.SeedSequence([DATA_SEED, step]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        shape, key = (batch, cfg.audio_frames, cfg.d_model), "frames"
    else:
        shape = (batch, cfg.vision_tokens, cfg.vision_embed_dim)
        key = "vision_embeds"
    return {key: torch.randn(shape, generator=gen).to(device)}


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 20, compress_grads: bool = False,
          lr: float = 3e-3, log_every: int = 10, device="cuda",
          on_step=None, layers: int | None = None):
    """Train `arch` for `steps` steps from seeded weights (a CPU
    `torch.Generator`, seed 0, drawn on the host and moved to `device`:
    the same weights on every device), or from the latest checkpoint
    under `ckpt_dir`; returns (params, losses of the steps run).
    `on_step(step, metrics)` sees each step's metrics ({"loss",
    "grad_norm", "lr"}).  `layers` cuts the depth to that many layers
    (the config's first `layers`, at full width)."""
    dev = _device.resolve(device)
    cfg, model = registry.get(arch, smoke=smoke)
    if layers is not None:
        if not 0 < layers <= cfg.n_layers:
            raise ValueError(f"layers must be in 1..{cfg.n_layers}, got "
                             f"{layers}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.family == "encdec":
        seq = max(seq, 16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), cfg, dev)
    print(f"init: {arch} weights drawn on the host and moved to {dev} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opt_cfg = opt_lib.OptConfig(lr=lr, warmup_steps=10, total_steps=steps)
    opt_state = opt_lib.init(params)
    err_state = comp_lib.init_error_state(params) if compress_grads \
        else None
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    start = 0
    ck = None
    if ckpt_dir:
        ck = ckpt_lib.AsyncCheckpointer(ckpt_dir)
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), start = ckpt_lib.restore(
                ckpt_dir, (params, opt_state), last)
            print(f"resumed from step {start}")

    def step_fn(p, o, e, b):
        loss, grads = value_and_grad(
            lambda q: model.loss_fn(q, cfg, b, remat=False), p)
        if e is not None:
            grads, e = comp_lib.compress_grads(grads, e)
        p, o, metrics = opt_lib.update(opt_cfg, grads, o, p)
        metrics["loss"] = loss
        return p, o, e, metrics

    stop = {"flag": False}
    prev = signal.signal(signal.SIGTERM,
                         lambda *_: stop.__setitem__("flag", True))
    wd = StepWatchdog()
    losses = []
    try:
        for s in range(start, steps):
            wd.start()
            b = {**lm_batch(dcfg, s, dev), **side_inputs(cfg, batch, s, dev)}
            params, opt_state, err_state, m = step_fn(params, opt_state,
                                                      err_state, b)
            losses.append(float(m["loss"]))
            wd.stop(s)
            if on_step is not None:
                on_step(s, m)
            if s % log_every == 0 or s == steps - 1:
                print(f"step {s:5d} loss {float(m['loss']):8.4f} "
                      f"gnorm {float(m['grad_norm']):8.3f} "
                      f"lr {float(m['lr']):.2e}", flush=True)
            if ck and (s + 1) % ckpt_every == 0:
                ck.submit((params, opt_state), s + 1)
            if stop["flag"]:
                print("SIGTERM: checkpoint + clean exit")
                if ck:
                    ck.submit((params, opt_state), s + 1)
                break
    finally:
        if ck:
            ck.wait()
            ck.close()
        signal.signal(signal.SIGTERM, prev)
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=registry.arch_names())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.time()
    _, losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                      batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir,
                      compress_grads=args.compress_grads,
                      device=args.device)
    print(f"done in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
