"""Host-clock train-step times on one NVIDIA card, for comparing two trees
of the port in one run.

    python3 scripts/train_timing.py [--root DIR] [--arch zamba2-1.2b]
                                    [--steps 10] [--batch 4] [--seq 2048]

Imports `repro_torch` from DIR/src (default: this checkout), builds the
flash and SSD kernels of that tree (one nvcc each, all started
together), then runs `launch.train.train` at the arch's full width and
depth for `steps` AdamW steps with random weights from seed 0 and
prints:

  - each step's host-clock ms, from a synchronize after the previous
    step to a synchronize after this one (step 0 holds the first calls'
    set-up and is left out of the summary);
  - the median, minimum and mean of steps 1 to steps - 1;
  - the card's name and power limit (nvidia-smi).

Run it from the root of a checkout on a machine with a card; it exits
non-zero without one.  Two trees compared in one run alternate: parent,
change, change, parent, each in its own process.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_timing: no CUDA card")
    from repro_torch.kernels import build
    from repro_torch.launch import train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all(("flash_attention", "flash_attention_bwd", "ssd_scan",
                     "ssd_scan_bwd"))
    print(f"{root}: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    ms, last = [], {}

    def on_step(s, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms.append((now - last["t"]) * 1e3)
        last["t"] = now

    torch.cuda.synchronize()
    last["t"] = time.perf_counter()
    train.train(args.arch, smoke=False, steps=args.steps, batch=args.batch,
                seq=args.seq, device=dev, log_every=args.steps,
                on_step=on_step)
    steady = ms[1:]
    print(f"{root}: {args.arch} B={args.batch} S={args.seq}, ms per step: "
          + ", ".join(f"{t:.1f}" for t in ms)
          + f"; steps 1-{len(ms) - 1}: median {statistics.median(steady):.1f}"
          f", min {min(steady):.1f}, mean {statistics.mean(steady):.1f}")
    print(smi)


if __name__ == "__main__":
    main()
