"""End-to-end smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (any failure exits non-zero):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/day_scan.cu with nvcc (sm_90a) from the checkout;
  3. kernel vs its plain PyTorch version on the card, on the serving
     grid's day tables (N = 64 combos, T = 4320 steps, L = 3 levels) and
     on ragged N = 63 and N = 200: discrete outputs (level, shut) exactly
     equal, continuous ones within rtol 1e-6 / atol 1e-4;
  4. main path: `DesignTwin()` on the default grid at dt_s = 10 s (warm
     query, a repeat, then three what-ifs: another policy's thresholds,
     another battery, a single platform), each checked against the
     reference's golden answers in src/repro_torch/data/
     (front_mask / survives() / shutdown exactly, objectives rtol
     1e-5); the day-scan kernel must launch exactly once per query;
  5. timing: day-scan kernel ms (CUDA events over many launches), the
     plain version's ms, the bound, warm query and what-if ms.

The second-to-last lines are the `kernels` JSON object and the
nvidia-smi line; the last line is the result object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12          # H100 SXM float32, outside tensor cores
# float ops of one combo-step of csrc/day_scan.cu:day_thread (an exp or a
# division counted as one op)
OPS_PER_STEP = 104
RTOL, ATOL = 1e-6, 1e-4         # continuous day traces, as the reference
OBJ_RTOL = 1e-5                 # objectives vs the golden (sums of traces)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of `fn()` over `reps` back-to-back calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel: dict, plain: dict) -> float:
    """Kernel vs plain outputs: discrete exact, continuous to tolerance;
    returns the largest absolute error of the continuous outputs."""
    import numpy as np
    worst = 0.0
    for k in ("level", "shut"):
        if not np.array_equal(kernel[k].cpu().numpy(),
                              plain[k].cpu().numpy()):
            fail(f"day_scan kernel {k} differs from the plain version")
    for k in ("soc", "soc_p", "t_skin", "t_skin_p", "pods", "drain_mw",
              "drain_p_mw"):
        a = kernel[k].cpu().numpy().astype(np.float64)
        b = plain[k].cpu().numpy().astype(np.float64)
        if not np.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"day_scan kernel {k} off by {np.abs(a - b).max()}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def resize(tables: dict, n: int) -> dict:
    """Day tables cut or tiled to `n` combos along N; tiled copies get
    their ambient shifted by 0.5 K per copy so they differ."""
    import torch
    n0 = tables["step_mw"].shape[-1]
    idx = torch.arange(n, device=tables["step_mw"].device) % n0
    shift = (torch.arange(n, device=idx.device) // n0).float() * 0.5
    out = {k: v[..., idx].contiguous() for k, v in tables.items()
           if k != "const"}
    out["ambient"] = out["ambient"] + shift
    out["const"] = {k: v[idx].contiguous()
                    for k, v in tables["const"].items()}
    return out


def bound_ms(n: int, t: int, n_lvl: int) -> tuple:
    """(bound ms, "bytes" | "operations") of one day-scan call: the
    bytes it must move (each input read once — one throttle level of
    each table per step — and each output written once) over HBM
    bandwidth vs its float ops over the float32 peak."""
    f32 = 4
    read = (3 * t * n + 5 * t * n + n_lvl * n + 31 * n) * f32
    write = 9 * t * n * f32
    by_bytes = (read + write) / PEAK_BYTES_S * 1e3
    by_ops = n * t * OPS_PER_STEP / PEAK_F32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def profile_queries(twin, reps: int) -> str:
    """Device time of warm queries by kernel, from torch.profiler: the
    device-busy ms per query, the day-scan kernel's share and the
    number of kernels launched per query."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            twin.query()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / reps, e.count / reps, e.key))
    if not rows:
        return "profile: the profiler saw no device time (not measured)"
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    scan_us = sum(r[0] for r in rows if "day_scan" in r[2])
    top = "; ".join(f"{k[:48]} {us / 1e3:.3f} ms x{c:g}"
                    for us, c, k in rows[:5])
    return (f"profile (per warm query, {reps} queries): device busy "
            f"{busy_us / 1e3:.3f} ms in {sum(r[1] for r in rows):g} "
            f"kernels, day_scan {scan_us / 1e3:.3f} ms; top: {top}")


def check_golden(name: str, rep, want: dict) -> None:
    import numpy as np
    if rep.combos != want["combos"]:
        fail(f"{name}: combo labels differ from the golden")
    for k, got in (("front_mask", rep.front_mask),
                   ("survives", rep.survives()),
                   ("shutdown", rep.shutdown)):
        if not np.array_equal(np.asarray(got, bool),
                              np.asarray(want[k], bool)):
            fail(f"{name}: {k} differs from the golden")
    for k in ("time_to_empty_h", "peak_skin_c", "pod_hours"):
        if not np.allclose(getattr(rep, k), np.asarray(want[k]),
                           rtol=OBJ_RTOL, atol=0.0):
            fail(f"{name}: {k} outside rtol {OBJ_RTOL} of the golden")


def golden_overrides(spec: dict, daysim) -> dict:
    import dataclasses
    out = dict(spec)
    if "policy" in out:
        p = dict(out["policy"])
        out["policy"] = dataclasses.replace(daysim.get_policy(p.pop("base")),
                                            **p)
    if "battery" in out:
        out["battery"] = daysim.BatterySpec.from_dict(out["battery"])
    return out


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no card")
    from repro_torch.core import daysim
    from repro_torch.kernels import build, day_scan as ds
    from repro_torch.serving.twin import DesignTwin

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"device: {kind} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.load("day_scan")
    print(f"kernel build: day_scan {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_SECONDS.get('day_scan', 0.0):.2f} s)")

    # 3. kernel vs plain on the serving grid's tables
    golden = json.loads((ROOT / "src" / "repro_torch" / "data"
                         / "golden_day_pareto.json").read_text())
    dt_s = golden["dt_s"]
    pipe = daysim._fused_pipeline(dev, dt_s=dt_s)     # the default grid
    full, _ = daysim.day_tables(pipe)
    n, t, n_lvl = ds._shape(full)
    print(f"serving grid: N={n} combos ({pipe.asm.n_real} real), "
          f"T={t} steps, L={n_lvl} levels")
    worst = 0.0
    for size in (n, 63, 200):
        tb = full if size == n else resize(full, size)
        got = ds.day_scan(tb)
        torch.cuda.synchronize()
        worst = max(worst, compare(got, ds.day_scan_plain(tb)))
        print(f"day_scan kernel == plain at N={size}: level/shut exact, "
              f"max abs err {worst:.3g}")

    # 4. the main path through the user's entry point
    ds.LAUNCHES = 0
    twin = DesignTwin(dt_s=dt_s)                  # warm query
    if ds.LAUNCHES != 1:
        fail(f"warm query launched the kernel {ds.LAUNCHES} times")
    base = twin.query()
    check_golden("base", base, golden["queries"]["base"])
    warm_first_ms = twin.stats.last_ms
    what_if_ms = {}
    for name, q in golden["queries"].items():
        if name == "base":
            continue
        before = ds.LAUNCHES
        rep = twin.what_if(**golden_overrides(q["overrides"], daysim))
        what_if_ms[name] = twin.stats.last_ms
        if ds.LAUNCHES != before + 1:
            fail(f"what-if {name} launched the kernel "
                 f"{ds.LAUNCHES - before} times")
        check_golden(name, rep, q)
        print(f"what-if {name}: {len(rep)} combos, front "
              f"{int(rep.front_mask.sum())}, survive "
              f"{int(rep.survives().sum())}: matches the golden")
    launches = ds.LAUNCHES
    print(f"main path: {launches} day_scan launches for "
          f"{twin.stats.queries} queries; base front "
          f"{int(base.front_mask.sum())} matches the golden")

    # 5. timing (launches from here on are not the main path's)
    lib_fn = ds._day_scan_cuda
    for _ in range(3):
        lib_fn(full)
    kernel_ms = cuda_ms(lambda: lib_fn(full), 50)
    one = resize(full, 1)
    lib_fn(one)
    one_ms = cuda_ms(lambda: lib_fn(one), 20)
    ds.day_scan_plain(full)
    plain_ms = cuda_ms(lambda: ds.day_scan_plain(full), 2)
    b_ms, b_by = bound_ms(n, t, n_lvl)
    for _ in range(2):
        twin.query()
    q_ms = []
    for _ in range(10):
        twin.query()
        q_ms.append(twin.stats.last_ms)
    print(f"day_scan kernel: {kernel_ms:.4f} ms at N={n} T={t} L={n_lvl}; "
          f"one combo (N=1, the bare serial chain of {t} steps): "
          f"{one_ms:.4f} ms")
    print(f"day_scan plain version: {plain_ms:.1f} ms; bound "
          f"{b_ms:.5f} ms by {b_by}; library call: none")
    print(f"twin warm query: mean {np.mean(q_ms):.2f} ms, min "
          f"{np.min(q_ms):.2f} ms over 10 (first warm {warm_first_ms:.2f} "
          f"ms); what-if (new values: assembly + push + query): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in what_if_ms.items()))
    print(profile_queries(twin, 5))
    print(json.dumps({"kernels": [{
        "name": "day_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/day_scan.cu",
        "replaces": "src/repro/kernels/day_scan.py:47",
        "launches": launches, "max_abs_err": worst, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
