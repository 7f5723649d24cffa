"""Warm design-twin query times on one NVIDIA card, for comparing two
trees of the port in one run.

    python3 scripts/twin_timing.py [--root DIR] [--reps 20] [--dt 10]

Imports `repro_torch` from DIR/src (default: this checkout), warms
`DesignTwin()` on the default grid at dt_s (the day-scan kernel builds
on first use) and prints:

  - the host-clock ms of `reps` warm queries, each from a synchronize to
    the copy of the summary to the host (mean, min, median);
  - device-busy ms and kernel count per warm query (torch.profiler over
    5 queries);
  - where the tree has `DesignTwin.query_batch`, the ms per item of warm
    batches of K = 1, 4 and 16 what-ifs of the thermal governor's
    temp_trip_c (mean of 5 each) and the device-busy ms and kernel count
    of one K = 16 batch;
  - the day-scan kernel's ms on the default grid's tables (CUDA events
    over 50 back-to-back launches, three times), in its default mode
    and, where the tree has it, its full-trace mode;
  - the card's name and power limit (nvidia-smi).

Run it from the root of a checkout on a machine with a card; it exits
non-zero without one.  Two trees compared in one run alternate: parent,
change, change, parent.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path


def profile(run, reps: int) -> tuple:
    """(device-busy ms, kernels) per call of `run`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
    busy = count = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            busy += dev_us
            count += e.count
    return busy / reps / 1e3, count / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=10.0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("twin_timing: no CUDA card")
    from repro_torch.core import daysim
    from repro_torch.serving.twin import DesignTwin

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    twin = DesignTwin(dt_s=args.dt)
    for _ in range(3):
        twin.query()

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    ms = [timed(twin.query) for _ in range(args.reps)]
    busy, kernels = profile(twin.query, 5)
    print(f"{root.name}: warm query ms mean {np.mean(ms):.3f}, min "
          f"{np.min(ms):.3f}, median {np.median(ms):.3f} over {args.reps}; "
          f"device busy {busy:.3f} ms in {kernels:g} kernels a query")
    if hasattr(twin, "query_batch"):
        gov = daysim.get_policy("thermal_governor")
        queries = [{"policies": ("none", dataclasses.replace(
            gov, name=f"v{i}", temp_trip_c=38.0 + 0.1 * i),
            "battery_saver")} for i in range(16)]
        per_item = {}
        for k in (1, 4, 16):
            twin.query_batch(queries[:k])
            per_item[k] = np.mean([timed(lambda: twin.query_batch(
                queries[:k])) for _ in range(5)]) / k
        busy, kernels = profile(lambda: twin.query_batch(queries), 3)
        print(f"{root.name}: warm batch ms per item "
              + ", ".join(f"K={k} {v:.3f}" for k, v in per_item.items())
              + f"; K=16 batch device busy {busy:.3f} ms in {kernels:g} "
              f"kernels")
    from repro_torch.kernels import day_scan as ds
    tables, _ = daysim.day_tables(daysim._fused_pipeline(
        torch.device("cuda"), dt_s=args.dt))
    modes = {"default": lambda: ds._day_scan_cuda(tables)}
    if hasattr(ds, "TRACE_OUTS"):
        modes["full-trace"] = lambda: ds._day_scan_cuda(tables, True)
    for name, launch in modes.items():
        launch()
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                launch()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 50)
        n, t, n_lvl = ds._shape(tables)
        print(f"{root.name}: day_scan {name} mode at N={n} T={t} "
              f"L={n_lvl}: " + " / ".join(f"{r:.4f}" for r in runs)
              + " ms (mean of 50 launches, 3 runs)")
    print(smi)


if __name__ == "__main__":
    main()
