"""Config-variant harness: measure one cell with config-variant knobs
(hypothesis -> change -> measure -> validate), the reference's
`launch/perf.py` over the card's measured cells (`dryrun.run_cell`).

Variants are plain ModelConfig field overrides (the knobs in configs/base):
  baseline    the registry's config
  ce256       ce_chunk = 256 (the cross-entropy's row chunk)
Only knobs that change the work on one card are variants: the
reference's mesh knobs (sp, seqattn), its remat policy (dots) and its
plain attention's tiles (ck*) are read by no module of the port, and its
SSD chunk (ssd*) does not reach the SSD kernels, which run their own
64-row tile.  Results land in
results/torch_perf/<arch>__<shape>__<variant>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from ..models import registry
from . import dryrun

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_perf"


def apply_variant(cfg, overrides: dict):
    return dataclasses.replace(cfg, **overrides)


def run_variant(arch: str, shape_name: str, variant: str, overrides: dict,
                out_dir=RESULTS, device="cuda", force: bool = False) -> dict:
    cfg, _ = registry.get(arch)
    cfg = apply_variant(cfg, overrides)
    rec = dryrun.run_cell(arch, shape_name, out_dir, force=force, cfg=cfg,
                          tag=variant, device=device)
    if "variant" not in rec:
        rec.update({"variant": variant,
                    "overrides": {k: str(v) for k, v in overrides.items()}})
        dryrun.sweep.cell_path(out_dir, arch, shape_name, variant) \
            .write_text(json.dumps(rec, indent=1))
    return rec


VARIANTS = {
    "baseline": {},
    "ce256": {"ce_chunk": 256},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rec = run_variant(args.arch, args.shape, args.variant,
                      VARIANTS[args.variant], device=args.device)
    if rec.get("ok"):
        t = rec["terms"]
        print(f"{args.arch} {args.shape} {args.variant}: B={rec['batch']} "
              f"step={rec['step_s'] * 1e3:.1f} ms cmp={t['compute_s']:.3f} "
              f"mem={t['memory_s']:.3f} col={t['collective_s']:.3f} "
              f"rf={rec['roofline_fraction']:.3f}")
    else:
        print("SKIP" if rec.get("skipped") else "FAIL",
              rec.get("reason") or rec.get("error"))


if __name__ == "__main__":
    main()
