"""Measured cells: run one (arch x shape) step on the card (the
reference's `launch/dryrun.py`, which lowers and compiles each cell for a
TPU mesh and reads XLA's cost analysis).

For each cell this writes `<out>/<arch>__<shape>__<tag>.json` (tag
"single" unless a perf variant names it) with the reference's artifact
fields wherever they mean something on one card:
  * the model at full width from seeded weights (the model's `init` on a
    seeded CPU generator; serving in bf16, training in f32 with bf16
    compute, as the reference);
  * the global batch cut to the largest power of two whose analytical
    memory (`resident_bytes`) fits in MEM_LIMIT, recorded under `reduced`
    (halved again if the card runs out of memory); a cell that fits at no
    batch is written as `skipped` with the reason;
  * one warm-up call, then STEPS timed calls on the host clock, each
    ending in a synchronize; `memory.peak_bytes` is
    `torch.cuda.max_memory_allocated`;
  * `flops_per_dev`: the products `FlopCounterMode` counts over the same
    step's plain path on meta tensors (a ctypes kernel is invisible to the
    counter, so counting the card run would leave out attention and the
    SSD; the plain SSD runs at the kernels' tile, so the config's chunk
    does not enter the count); the memory term is the analytical one
    (there is no HLO byte count), the collective term 0 (one card);
  * `terms`, `dominant`, `roofline_fraction`, `model_flops_*` and
    `useful_flops_ratio` as the reference writes them, and
    `achieved_fraction`: the roofline's bound over the measured step.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .. import device as _device
from ..configs.base import SHAPES, shape_applicable
from ..models import registry
from ..training import optimizer
from . import specs, steps as steps_lib, sweep
from .sweep import HBM_BW, PEAK_FLOPS  # noqa: F401  (re-exported)

MEM_LIMIT = 70e9             # bytes of the card's 80 GB a cell may plan on
STEPS = 2                    # timed calls after the warm-up
SEED = 0


def model_flops(cfg, shape) -> float:
    n = cfg.n_active_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


def resident_bytes(cfg, kind: str, batch: int, seq: int) -> float:
    """First-order device memory of one step (the batch cut's yardstick).
    Training: f32 parameters, gradients, AdamW m and v, and the update's
    new parameters, m and v before the old ones go (32 B a parameter);
    per token each layer's input kept for the recompute (f32), the
    cross-entropy's f32 logits and their gradient, one layer's f32
    working set.  Serving: bf16 weights, one layer's working set per
    token in flight, the bf16 KV cache / SSM state."""
    D, L = cfg.d_model, cfg.n_layers + cfg.dec_layers
    wide = max(D, cfg.d_ff * max(cfg.top_k, 1))
    if cfg.ssm is not None:
        s = cfg.ssm
        wide = max(wide, 2 * s.d_inner + 2 * s.n_groups * s.d_state
                   + s.n_heads)
    work = 4.0 * (12 * D + 3 * wide)
    cache_tok, state = sweep._cache_terms(cfg)
    if kind == "train":
        tokens = batch * seq
        return 32.0 * cfg.n_params + tokens * (4.0 * D * L + 8.0 * cfg.vocab
                                               + work)
    tokens = batch * (seq if kind == "prefill" else 1)
    return 2.0 * cfg.n_params + tokens * work + batch * (cache_tok * seq
                                                         + state)


def fitted_batch(cfg, shape, limit: float = MEM_LIMIT):
    """The largest power of two <= the shape's global batch whose
    `resident_bytes` fit in `limit`; None if batch 1 does not."""
    b = 1 << (shape.global_batch.bit_length() - 1)
    while b >= 1:
        if resident_bytes(cfg, shape.kind, b, shape.seq_len) <= limit:
            return b
        b //= 2
    return None


@contextlib.contextmanager
def plain_kernels(at_tile: bool = False):
    """Within the block the models call the flash and SSD dispatches'
    plain versions whatever the device (autograd differentiates them):
    the plain reference of a step the card checks hold the kernels to
    (the SSD at the config's chunk) and, with `at_tile`, the FLOP
    counter's view of a step on meta tensors.  The kernels compute the
    same products; the SSD kernels at their own `TILE` whatever chunk
    the config asks, and the quadratic work inside a chunk grows with
    the chunk, so `at_tile` runs the plain SSD at `TILE` too and the
    config's chunk does not enter the count."""
    from ..kernels import flash_attention as fa, ssd_scan as ss
    real = fa.flash_attention, ss.ssd_scan
    fa.flash_attention = fa.flash_attention_plain
    ss.ssd_scan = ((lambda *a, chunk=None: ss.ssd_scan_plain(
        *a, chunk=ss.TILE)) if at_tile else ss.ssd_scan_plain)
    try:
        yield
    finally:
        fa.flash_attention, ss.ssd_scan = real


def _serving(cfg, shape):
    """Serving runs on bf16 weights (no optimizer masters needed)."""
    if shape.kind != "train":
        return dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    return cfg


def _step_call(cfg, model, shape, params, inputs):
    """The cell's step as a no-argument call on these params / inputs."""
    if shape.kind == "train":
        step = steps_lib.make_train_step(cfg, model)
        state = optimizer.init(params)
        return lambda: step(params, state, inputs["batch"])
    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, model)
        return lambda: step(params, inputs)
    step = steps_lib.make_decode_step(cfg, model)
    return lambda: step(params, inputs["token"], inputs["cache"],
                        inputs["cur_len"])


def count_flops(cfg, model, shape, params=None, inputs=None) -> float:
    """Products of one step (2 flops a multiply-add) by `FlopCounterMode`
    over the plain path: on meta tensors, or on `params` / `inputs` where
    given (a step whose work follows its data, such as MoE routing, has
    no meta kernels)."""
    from torch.utils.flop_counter import FlopCounterMode
    if params is None and cfg.family == "ssm" and cfg.n_layers > 2:
        # every mamba layer does the same work, so the count is affine in
        # the depth and two shallow counts give it exactly (the plain
        # scan's Python loop over chunks makes a deep count take minutes)
        one, two = (count_flops(dataclasses.replace(cfg, n_layers=k), model,
                                shape) for k in (1, 2))
        return one + (cfg.n_layers - 1) * (two - one)
    if params is None:
        params = specs.param_struct(cfg, model)
        inputs = specs.input_specs(cfg, shape, model)
        if shape.kind == "decode":
            inputs["cur_len"] = shape.seq_len - 1
    counter = FlopCounterMode(display=False)
    with plain_kernels(at_tile=True), counter:
        _step_call(cfg, model, shape, params, inputs)()
    return float(counter.get_total_flops())


def _inputs(cfg, model, shape, dev) -> dict:
    """Seeded inputs of the cell's step on `dev`."""
    from ..data.pipeline import DataConfig, lm_batch
    from .train import side_inputs
    B, S = shape.global_batch, shape.seq_len
    side = side_inputs(cfg, B, 0, dev)
    side = {k: v.to(torch.bfloat16) for k, v in side.items()}
    if shape.kind == "decode":
        cache = model.init_cache(cfg, B, S, torch.bfloat16, dev)
        # repro: ignore[R003]: seeded synthetic tokens for a measured cell,
        # drawn once on the host
        tok = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, B), dtype=torch.int32, device=dev)
        return {"token": tok, "cache": cache, "cur_len": S - 1}
    batch = lm_batch(DataConfig(cfg.vocab, S, B), 0, dev)
    if shape.kind == "train":
        return {"batch": {**batch, **side}}
    return {"tokens": batch["tokens"], **side}


def _measure(cfg, model, shape, dev) -> dict:
    """Weights, inputs, one warm-up and STEPS timed calls; then the
    step's products (`count_flops`: on meta tensors, else on these
    weights and inputs)."""
    cuda = dev.type == "cuda"
    params = model.init(torch.Generator().manual_seed(SEED), cfg, dev)
    inputs = _inputs(cfg, model, shape, dev)
    call = _step_call(cfg, model, shape, params, inputs)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    call()
    sync()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        call()
        sync()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del call
    try:
        flops, where = count_flops(cfg, model, shape), "meta"
    except NotImplementedError:
        flops = count_flops(cfg, model, shape, params, inputs)
        where = str(dev)
    return {"warmup_s": warm, "step_ms": [t * 1e3 for t in times],
            "peak_bytes": peak, "flops": flops, "flops_counted_on": where}


def run_cell(arch: str, shape_name: str, out_dir=sweep.RESULTS, *,
             force: bool = False, cfg=None, tag: str = "single",
             device="cuda", limit: float = MEM_LIMIT) -> dict:
    """Measure one cell on `device` and write its artifact; `cfg`
    replaces the registry's config (a tuned config, a perf variant, a
    smoke config), `tag` the artifact's mesh field and name."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = sweep.cell_path(out_dir, arch, shape_name, tag)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    reg_cfg, model = registry.get(arch)
    cfg = _serving(cfg or reg_cfg, SHAPES[shape_name])
    full = SHAPES[shape_name]
    dev = _device.resolve(device)
    rec = {"arch": arch, "shape": shape_name, "mesh": tag, "config":
           cfg.name, "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else str(dev))}
    ok, why = shape_applicable(cfg, full)
    batch = fitted_batch(cfg, full, limit) if ok else None
    if not ok or batch is None:
        why = why or (f"{arch} at {shape_name} does not fit {limit / 1e9:g}"
                      f" GB even at batch 1: "
                      f"{resident_bytes(cfg, full.kind, 1, full.seq_len) / 1e9:.1f}"
                      f" GB analytical ({cfg.n_params / 1e9:.2f} B "
                      f"parameters, {'f32 AdamW' if full.kind == 'train' else 'bf16'})")
        rec.update({"ok": False, "skipped": True, "reason": why})
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    reduced = []
    try:
        while True:
            shape = dataclasses.replace(full, global_batch=batch)
            try:
                meas = _measure(cfg, model, shape, dev)
                break
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
            torch.cuda.empty_cache()        # the failed try's tensors
            reduced.append(f"out of memory at batch {batch}: halved")
            batch //= 2
        if batch != full.global_batch:
            reduced.insert(0, (
                f"global_batch {full.global_batch} -> {batch}: the largest "
                f"power of two whose analytical memory "
                f"({resident_bytes(cfg, full.kind, batch, full.seq_len) / 1e9:.1f}"
                f" GB) fits in {limit / 1e9:g} GB"))
        flops = meas["flops"]
        table = sweep.CellTable.of([((arch, shape_name), cfg, shape)])
        ana = sweep.analytical_terms(table)
        terms = {"compute_s": flops / PEAK_FLOPS,
                 "memory_s": float(ana["memory_s"][0]), "collective_s": 0.0}
        bound = max(terms.values())
        step_s = float(np.median(meas["step_ms"])) / 1e3
        mf = model_flops(cfg, shape)
        rec.update({
            "ok": True, "n_devices": 1, "batch": batch,
            "seq_len": shape.seq_len, "reduced": reduced,
            "warmup_s": meas["warmup_s"], "step_ms": meas["step_ms"],
            "step_s": step_s,
            "tokens_per_s": (batch * (shape.seq_len if shape.kind != "decode"
                                      else 1)) / step_s,
            "flops_per_dev": flops,
            "flops_counted_on": meas["flops_counted_on"],
            "analytical_compute_s": float(ana["compute_s"][0]),
            "memory": {"peak_bytes": meas["peak_bytes"],
                       "analytical_bytes": resident_bytes(
                           cfg, shape.kind, batch, shape.seq_len)},
            "model_flops_total": mf, "model_flops_per_dev": mf,
            "useful_flops_ratio": mf / flops if flops else 0.0,
            "terms": terms, "dominant": max(terms, key=terms.get),
            "roofline_fraction": terms["compute_s"] / bound if bound else 0.0,
            "achieved_fraction": bound / step_s})
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "reduced": reduced,
                    "traceback": traceback.format_exc()[-4000:]})
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=str(sweep.RESULTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    archs = registry.arch_names() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for arch in archs:
        for shape in shapes:
            t0 = time.time()
            rec = run_cell(arch, shape, args.out, force=args.force,
                           device=args.device)
            status = ("SKIP" if rec.get("skipped") else
                      "ok" if rec.get("ok") else "FAIL")
            extra = ""
            if rec.get("ok"):
                extra = (f" B={rec['batch']} step={rec['step_s'] * 1e3:.1f} ms"
                         f" dom={rec['dominant']}"
                         f" rf={rec['roofline_fraction']:.3f}"
                         f" achieved={rec['achieved_fraction']:.3f}")
            elif not rec.get("skipped"):
                extra = " " + rec.get("error", "")[:120]
            print(f"[{time.time() - t0:7.1f}s] {arch:22s} {shape:12s} "
                  f"{status}{extra}", flush=True)


if __name__ == "__main__":
    main()
