"""Host-clock prefill times on one NVIDIA card, for comparing two trees
of the port in one run.

    python3 scripts/prefill_timing.py [--root DIR] [--arch zamba2-1.2b]
                                      [--reps 10] [--batch 2] [--seq 4096]

Imports `repro_torch` from DIR/src (default: this checkout), builds the
flash and SSD kernels of that tree (one nvcc each, all started
together), then runs `launch.steps.make_prefill_step` at the arch's full
width and depth in bf16 (weights and compute; random weights from seed
0) on `batch` prompts of `seq` tokens: one warm call, then `reps` calls,
each from a synchronize to a synchronize, and prints their ms, the
median, minimum and mean, the flash and SSD launches of one call, and
the card's name and power limit (nvidia-smi).

Run it from the root of a checkout on a machine with a card; it exits
non-zero without one.  Two trees compared in one run alternate: parent,
change, change, parent, each in its own process.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("prefill_timing: no CUDA card")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    from repro_torch.launch import steps
    from repro_torch.models import registry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.build_all(("flash_attention", "ssd_scan"))
    dev = torch.device("cuda", 0)
    cfg, model = registry.get(args.arch)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    params = model.init(torch.Generator().manual_seed(0), cfg, dev)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    step = steps.make_prefill_step(cfg, model)
    with torch.no_grad():
        step(params, {"tokens": toks})
        f0, s0 = fa.LAUNCHES, ss.LAUNCHES
        ms = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, {"tokens": toks})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    print(f"{root}: {args.arch} bf16 prefill B={args.batch} S={args.seq}, "
          f"ms per call: " + ", ".join(f"{t:.2f}" for t in ms)
          + f"; median {statistics.median(ms):.2f}, min {min(ms):.2f}, "
          f"mean {statistics.mean(ms):.2f}; launches a call: flash "
          f"{(fa.LAUNCHES - f0) // args.reps}, SSD "
          f"{(ss.LAUNCHES - s0) // args.reps}")
    print(smi)


if __name__ == "__main__":
    main()
