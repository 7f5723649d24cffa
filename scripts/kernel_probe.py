"""Kernel-only probes of the port's kernels on one NVIDIA card:
correctness at edge shapes and times at the main path's shapes, without
the model.  `chip_smoke.py` is the end-to-end run; this is the quick loop
for working on one kernel.

    python3 scripts/kernel_probe.py day              # day scan: designs x
                                                     # probe modes x N
    python3 scripts/kernel_probe.py flash            # ptxas lines, edges at
                                                     # Dh 64-256, times at
                                                     # the LM shapes vs SDPA
    python3 scripts/kernel_probe.py ssd              # edges, group states,
                                                     # time per launch
    python3 scripts/kernel_probe.py flash-bwd        # the backward kernel:
                                                     # ptxas, edges vs its
                                                     # plain version and
                                                     # autograd, times
    python3 scripts/kernel_probe.py flash-variants   # exp2 fold / 4 warps
    python3 scripts/kernel_probe.py flash-compare OTHER.cu   # another copy
                                                     # of the flash source
                                                     # vs this one, in turns
    python3 scripts/kernel_probe.py flash-bwd-compare OTHER.cu   # another
                                                     # copy of the flash
                                                     # backward's source vs
                                                     # this one, in turns
    python3 scripts/kernel_probe.py ssd-bwd          # the SSD backward:
                                                     # ptxas, edges vs its
                                                     # plain version and
                                                     # autograd, times
    python3 scripts/kernel_probe.py ssd-bwd-compare OTHER.cu   # another
                                                     # copy of the SSD
                                                     # backward's source
                                                     # vs this one, in turns
    python3 scripts/kernel_probe.py ssd-compare OTHER.cu     # the SSD
                                                     # forward's serving
                                                     # launch, another
                                                     # source vs this one
    python3 scripts/kernel_probe.py row-stage        # the first op of the
                                                     # row stage whose bits
                                                     # differ card vs CPU

Run from the root of a checkout.  Every line it prints is a reading of
the card named on its first line.  `day` builds csrc/day_scan.cu and the
one-thread-per-combo baseline csrc/day_scan_thread.cu with their probe
modes (as is; inputs held in registers; no loads or stores, the chain's
floor) and times each on the serving grid's tables at N = 1, 64 and 1024
combos, in ns and SM cycles per step.  `flash-variants` builds four
variants of csrc/flash_attention.cu (8 or 4 warps a block; `expf` or
scale·log2e folded into `exp2f`) into build/probe/ and times them in
turns.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import day_scan as ds  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402

DEV = torch.device("cuda")
SSD_KERNEL = re.compile(r"ssd_kernel_\w+<\d+>")   # launch names in a profile


def rn(gen, shape, dtype, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device=DEV)).to(dtype)


def rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DAY_SOURCES = ("day_scan_thread", "day_scan")   # baseline, current


def day_fdiv_source() -> Path:
    """csrc/day_scan.cu with both divisions as `__fdividef` (approximate:
    not bit-equal), to show what the exact division costs the chain."""
    s = (build.CSRC / "day_scan.cu").read_text()
    for node in ("g", "p"):
        old = f"float i_{node} = div_common(a_{node}, v_{node}, slow_{node});"
        if old not in s:
            raise RuntimeError(f"day_scan source changed: {old!r} not found")
        s = s.replace(old, f"float i_{node} = __fdividef(a_{node}, "
                      f"v_{node}); slow_{node} = false;")
    out = build.BUILD_DIR.parent / "probe" / "day_scan_fdiv.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(s)
    return out


def probe_day() -> None:
    """Both day-scan designs in each probe mode on the serving grid's
    tables (N = 64, T = 4320, L = 3 at dt_s = 10 s), cut to one combo and
    tiled to 1024 (16 grids, as the batched twin path would fold them):
    ms, ns and SM cycles per step, in turns (baseline, current, current,
    baseline).  "as is" must equal the production kernel's outputs."""
    from repro_torch.core import daysim
    src = day_fdiv_source()
    lib = src.with_suffix(".so")
    nvcc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS,
                             "-DDAY_SCAN_PROBE", "-o", str(lib), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    build.build_all([(s, ("DAY_SCAN_PROBE",)) for s in DAY_SOURCES]
                    + ["day_scan"])
    if nvcc.wait():
        raise RuntimeError(f"nvcc failed for {src.name}:\n{nvcc.stderr.read()}")
    fdiv = ctypes.CDLL(str(lib)).day_scan_probe_launch
    fdiv.argtypes = ds._argtypes(len(ds.OUTS)) + [ctypes.c_int]
    fdiv.restype = ctypes.c_int
    for label, log in sorted(build.BUILD_LOG.items()):
        if label.startswith("day_scan"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {label}: {line.strip()}")
    full, _ = daysim.day_tables(daysim._fused_pipeline(DEV, dt_s=10.0))
    n0, t, n_lvl = ds._shape(full)
    print(f"day tables: N={n0} T={t} L={n_lvl}; chunk_steps({n_lvl}) = "
          f"{ds.chunk_steps(n_lvl)}")
    busy = lambda: ds.probe_launch(full, "as is")  # noqa: E731
    mhz, max_mhz = chip_smoke.sm_clocks(busy, 1.5)
    print(f"SM clock under the day scan: {mhz} MHz (max {max_mhz} MHz)")
    for n in (1, 64, 1024):
        tb = full if n == n0 else chip_smoke.resize(full, n)
        want = ds._day_scan_cuda(tb)
        if n == n0:
            print(f"zero-power combo-steps (drain 0, a zero dividend) at "
                  f"N={n}: glasses "
                  f"{float((want['drain_mw'] == 0).float().mean()):.3f}, "
                  f"puck {float((want['drain_p_mw'] == 0).float().mean()):.3f}")
        for src in DAY_SOURCES:
            got = ds.probe_launch(tb, "as is", src)
            same = all(torch.equal(got[k].t(), want[k]) for k in ds.OUTS)
            print(f"day {src} N={n}: as is == csrc/day_scan.cu: {same}")
        times = {}
        for src in DAY_SOURCES + DAY_SOURCES[::-1]:
            for mode in ds.PROBE_MODES:
                ms = cuda_ms(lambda: ds.probe_launch(tb, mode, src))
                times.setdefault((src, mode), []).append(ms)
        for (src, mode), ms in times.items():
            per = min(ms) * 1e-3 / t
            print(f"day N={n} T={t} L={n_lvl} {src} {mode}: "
                  + " / ".join(f"{m:.4f}" for m in ms) + f" ms; "
                  f"{per * 1e9:.1f} ns/step, "
                  f"{per * float(mhz) * 1e6:.0f} SM cycles/step")
        floor = min(times[("day_scan", "no loads or stores")])
        b_ms, b_by = chip_smoke.bound_ms(n, t, n_lvl)
        print(f"day chain floor N={n} (csrc/day_scan.cu, no loads or "
              f"stores): {floor:.4f} ms; bound {b_ms:.5f} ms by {b_by}")
        approx = cuda_ms(lambda: ds._launch(
            fdiv, tb, ds.PROBE_MODES["no loads or stores"]))
        print(f"day chain floor N={n} with __fdividef for both divisions "
              f"(approximate, not bit-equal): {approx:.4f} ms; "
              f"{approx * 1e-3 / t * float(mhz) * 1e6:.0f} SM cycles/step")
    print(f"SM clock: {' / '.join(chip_smoke.sm_clocks(busy, 1.0))} MHz "
          f"(clocks.sm / clocks.max.sm)")


def probe_flash() -> None:
    """Kernel vs plain (max abs) and vs plain on the kernel's tiles
    (relative RMS) over edge shapes, then the prefill-shape time beside
    scaled_dot_product_attention's."""
    build.build("flash_attention")
    for line in build.BUILD_LOG.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas flash_attention: {line.strip()}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    for B, Sq, Sk, H, KvH, Dh, causal, window in (
            (1, 1100, 1100, 8, 4, 256, True, None),
            (1, 1100, 1100, 8, 4, 256, True, 1024),
            (1, 1000, 1000, 32, 32, 96, True, None),
            (1, 300, 300, 8, 2, 96, True, 96),
            (1, 130, 70, 4, 2, 256, False, None),
            (1, 70, 130, 4, 4, 96, True, None),
            (2, 257, 257, 8, 8, 256, True, 5),
            (2, 4096, 4096, 32, 32, 64, True, None),
            (1, 300, 300, 8, 2, 128, True, 96),
            (2, 200, 200, 4, 1, 64, False, None),
            (1, 37, 37, 4, 4, 64, True, None),
            (1, 1000, 1000, 16, 4, 128, True, 96),
            (1, 130, 70, 2, 2, 64, False, None),
            (1, 257, 257, 2, 1, 128, True, 5),
            (1, 70, 130, 2, 2, 64, True, None)):
        for dtype in (torch.bfloat16, torch.float32):
            q = rn(gen, (B, Sq, H, Dh), dtype)
            k, v = (rn(gen, (B, Sk, KvH, Dh), dtype) for _ in range(2))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            bq, bk = fa.TILES[dtype]
            tiled = attn.chunked_attention(
                q, k, v, causal=causal, window=window, chunk_q=bq,
                chunk_k=bk, bidirectional=not causal and window is None)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            print(f"flash B={B} Sq={Sq} Sk={Sk} H={H} KvH={KvH} Dh={Dh} "
                  f"causal={causal} window={window} {str(dtype)[6:]}: max "
                  f"abs err {float((got.float() - want.float()).abs().max()):.3g}"
                  f", rel RMS vs tiled {rel_rms(got, tiled):.3g}, finite "
                  f"{bool(torch.isfinite(got).all())}")
    for (H, KvH, Dh, window) in FLASH_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            q = rn(gen, (2, 4096, H, Dh), dtype)
            k, v = (rn(gen, (2, 4096, KvH, Dh), dtype) for _ in range(2))
            flash = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, causal=True, window=window)
            sdpa, backend = chip_smoke.sdpa_call(q, k, v, True, window)
            bound, by = chip_smoke.flash_bound(q, k, True, window)
            print(f"flash {str(dtype)[6:]} B=2 S=4096 H={H} KvH={KvH} "
                  f"Dh={Dh} causal window={window}: {cuda_ms(flash):.4f} ms;"
                  f" scaled_dot_product_attention {cuda_ms(sdpa):.4f} ms "
                  f"({backend}); bound {bound:.4f} ms "
                  f"by {by}", flush=True)


def autograd_plain(q, k, v, do, causal, window):
    """dq, dk, dv by autograd of `flash_attention_plain` (the yardstick
    of the backward kernel)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(o, (q, k, v), do)


def probe_flash_bwd() -> None:
    """The backward kernel: ptxas lines, then over edge shapes the
    forward's row lse against `flash_attention_lse_plain` and dq / dk / dv
    against `flash_attention_bwd_plain` (on the kernel's own o and lse)
    and autograd of the plain forward, relative to each gradient's
    largest magnitude; then times at olmo-1b's, whisper's and phi-3's
    shapes beside scaled_dot_product_attention's backward."""
    build.build_all(("flash_attention", "flash_attention_bwd"))
    for line in build.BUILD_LOG.get("flash_attention_bwd", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas flash_attention_bwd: {line.strip()}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    for B, Sq, Sk, H, KvH, Dh, causal, window in (
            (1, 300, 300, 4, 4, 64, True, None),
            (1, 300, 300, 8, 2, 128, True, 96),
            (2, 200, 200, 4, 1, 64, False, None),
            (1, 130, 70, 4, 2, 96, False, None),
            (1, 70, 130, 2, 2, 64, True, None),
            (1, 257, 257, 8, 4, 256, True, 5),
            (1, 300, 1500, 4, 4, 64, False, None),
            (1, 1100, 1100, 8, 4, 256, True, 1024),
            (1, 600, 600, 8, 4, 256, True, None),
            (1, 130, 200, 4, 2, 256, False, None),
            (1, 37, 37, 4, 4, 96, True, None)):
        for dtype in (torch.float32, torch.bfloat16):
            q = rn(gen, (B, Sq, H, Dh), dtype)
            k, v = (rn(gen, (B, Sk, KvH, Dh), dtype) for _ in range(2))
            do = rn(gen, (B, Sq, H, Dh), dtype)
            o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window,
                                    lse=True)
            got = fa._flash_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                     window=window)
            again = fa._flash_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                       window=window)
            lse_err = float((lse - fa.flash_attention_lse_plain(
                q, k, causal=causal, window=window)).abs().max())
            tiled = fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                 causal=causal, window=window)
            auto = autograd_plain(q, k, v, do, causal, window)
            torch.cuda.synchronize()
            repeat = all(chip_smoke.bits_equal(a, b)
                         for a, b in zip(got, again))

            def rel(a, b):
                return float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
            print(f"flash bwd B={B} Sq={Sq} Sk={Sk} H={H} KvH={KvH} "
                  f"Dh={Dh} causal={causal} window={window} "
                  f"{str(dtype)[6:]}: lse max abs err {lse_err:.3g}; "
                  f"dq/dk/dv max err / max |.| vs tiled plain "
                  + "/".join(f"{rel(a, b):.3g}" for a, b in zip(got, tiled))
                  + ", vs autograd "
                  + "/".join(f"{rel(a, b):.3g}" for a, b in zip(got, auto))
                  + f", finite {all(bool(torch.isfinite(g).all()) for g in got)}"
                  f", a repeat bit-equal {repeat}", flush=True)
    for name, B, Sq, Sk, H, KvH, Dh, causal, window in BWD_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            q = rn(gen, (B, Sq, H, Dh), dtype)
            k, v = (rn(gen, (B, Sk, KvH, Dh), dtype) for _ in range(2))
            do = rn(gen, (B, Sq, H, Dh), dtype)
            o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window,
                                    lse=True)
            bwd = lambda: fa._flash_bwd_cuda(  # noqa: E731
                q, k, v, o, do, lse, causal=causal, window=window)
            fwd = lambda: fa._flash_cuda(  # noqa: E731
                q, k, v, causal=causal, window=window, lse=True)
            sdpa, backend = chip_smoke.sdpa_call(q, k, v, causal, window)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa_g, _ = chip_smoke.sdpa_call(qs, ks, vs, causal, window)
            o_s = sdpa_g()
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                o_s, (qs, ks, vs), do.transpose(1, 2), retain_graph=True)
            bound, by = chip_smoke.flash_bound(q, k, causal, window)
            print(f"flash bwd {name} {str(dtype)[6:]} B={B} Sq={Sq} Sk={Sk} "
                  f"H={H} KvH={KvH} Dh={Dh}: backward {cuda_ms(bwd, 5):.3f} "
                  f"ms, forward with lse {cuda_ms(fwd, 5):.3f} ms; SDPA "
                  f"({backend}) backward {cuda_ms(sdpa_bwd, 5):.3f} ms; "
                  f"forward bound {bound:.4f} ms by {by}", flush=True)


# (name, B, Sq, Sk, H, KvH, Dh, causal, window) of the backward's times
BWD_TIMED = (("olmo-1b", 4, 2048, 2048, 16, 16, 128, True, None),
             ("whisper enc", 2, 1500, 1500, 16, 16, 64, False, None),
             ("phi-3", 1, 2048, 2048, 32, 32, 96, True, None))


# (H, KvH, Dh, window) timed at B = 2, S = 4096: zamba2's shared block,
# gemma3-4b's global and local layers, phi-3-vision's layers
FLASH_TIMED = ((32, 32, 64, None), (8, 4, 256, None), (8, 4, 256, 1024),
               (32, 32, 96, None))


def ssd_inputs(gen, b, s, h, g, n, dtype, dt_scale):
    x = rn(gen, (b, s, h, 64), dtype, 0.5)
    dt = dt_scale * F.softplus(rn(gen, (b, s, h), torch.float32))
    A = -torch.exp(rn(gen, (h,), torch.float32, 0.3))
    return x, dt, A, rn(gen, (b, s, g, n), dtype, 0.3), \
        rn(gen, (b, s, g, n), dtype, 0.3)


def probe_ssd() -> None:
    """Kernel vs plain over edge shapes (launches, max abs, relative RMS,
    and in bf16 the bf16-product control), group states vs
    `ssd_split_states_plain`, then the prefill-shape time and each
    launch's device time from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=DEV).manual_seed(0)
    for b, s, h, g, n in ((2, 4096, 64, 1, 64), (2, 1000, 64, 1, 64),
                          (1, 40, 1, 1, 64), (1, 512, 1, 1, 64),
                          (1, 600, 4, 2, 128), (1, 1024, 8, 2, 128),
                          (1, 1, 2, 1, 64), (3, 700, 6, 3, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            for dt_scale in (1.0, 0.05):
                ins = ssd_inputs(gen, b, s, h, g, n, dtype, dt_scale)
                before = ss.LAUNCHES
                got = ss.ssd_scan(*ins, chunk=64)
                launches = ss.LAUNCHES - before
                want = ss.ssd_scan_plain(*ins, chunk=64)
                line = (f"ssd b={b} s={s} h={h} g={g} n={n} "
                        f"{str(dtype)[6:]} dt x{dt_scale:g}: {launches} "
                        f"launches, max abs err "
                        f"{float((got.float() - want.float()).abs().max()):.3g}"
                        f" at max |y| {float(want.float().abs().max()):.3g},"
                        f" rel RMS {rel_rms(got, want):.3g}")
                if dtype == torch.bfloat16:
                    line += (", bf16-product control " + format(rel_rms(
                        ss.ssd_scan_rounded_plain(*ins, chunk=64), want),
                        ".3g"))
                if ss.n_groups(s) > 1:
                    st = ss.ssd_group_states_cuda(*ins)
                    want_st = ss.ssd_split_states_plain(*ins, chunk=64)
                    line += (", group states max abs err "
                             f"{float((st - want_st).abs().max()):.3g}")
                print(line, flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        ins = ssd_inputs(gen, 2, 4096, 64, 1, 64, dtype, 1.0)
        ms = cuda_ms(lambda: ss.ssd_scan(*ins, chunk=64))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ss.ssd_scan(*ins, chunk=64)
            torch.cuda.synchronize()
        per = "; ".join(
            f"{SSD_KERNEL.search(e.key).group(0)} "
            f"{e.self_device_time_total / e.count:.1f} us"
            for e in prof.key_averages() if "ssd_kernel" in e.key)
        print(f"ssd {str(dtype)[6:]} b=2 s=4096 h=64 n=64: {ms:.4f} ms; "
              f"per launch: {per}")


def rel_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def probe_ssd_bwd() -> None:
    """The SSD backward kernel: ptxas lines; over edge shapes (one chunk,
    one group, ragged s, g > 1, n = 128, several groups) in float32 and
    bf16 the five gradients against `ssd_scan_bwd_plain` and, in float32,
    autograd of `ssd_scan_plain`, relative to each gradient's largest
    magnitude (bf16: relative RMS beside the control with W and GE
    rounded to bf16), and a second run bit for bit; then times at
    zamba2's and mamba2-2.7b's shapes beside the forward, the plain
    version and the bound, with each launch's device time."""
    from torch.profiler import ProfilerActivity, profile
    build.build_all(("ssd_scan", "ssd_scan_bwd"))
    for line in build.BUILD_LOG.get("ssd_scan_bwd", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas ssd_scan_bwd: {line.strip()}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    names = ("dx", "ddt", "dA", "dB", "dC")
    for b, s, h, g, n in ((1, 40, 2, 1, 64), (1, 512, 2, 1, 64),
                          (2, 1000, 8, 2, 64), (1, 600, 4, 2, 128),
                          (1, 1, 2, 1, 64), (3, 700, 6, 3, 64),
                          (1, 1100, 4, 1, 128), (1, 4096, 4, 1, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 0.05)
            dy = rn(gen, (b, s, h, 64), dtype)
            before = ss.BWD_LAUNCHES
            got = chip_smoke.ssd_grads(ins, dy)
            calls = ss.BWD_LAUNCHES - before
            again = chip_smoke.ssd_grads(ins, dy)
            plain = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
            torch.cuda.synchronize()
            line = (f"ssd bwd b={b} s={s} h={h} g={g} n={n} "
                    f"{str(dtype)[6:]}: {calls} call(s); vs plain "
                    + " ".join(f"{k} {rel_max(a, w):.3g}"
                               for k, a, w in zip(names, got, plain)))
            if dtype == torch.float32:
                leaves = [t.clone().requires_grad_() for t in ins]
                with torch.enable_grad():
                    auto = torch.autograd.grad(
                        ss.ssd_scan_plain(*leaves, chunk=64), leaves, dy)
                line += "; vs autograd " + " ".join(
                    f"{k} {rel_max(a, w):.3g}"
                    for k, a, w in zip(names, got, auto))
            else:
                ctrl = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64, rounded=True)
                line += "; rel RMS " + " ".join(
                    f"{k} {rel_rms(a, w):.3g}"
                    for k, a, w in zip(names, got, plain)) + \
                    "; control " + " ".join(
                        f"{k} {rel_rms(a, w):.3g}"
                        for k, a, w in zip(names, ctrl, plain))
            line += (f"; repeat bit-equal "
                     f"{all(torch.equal(a, c) for a, c in zip(got, again))}"
                     f"; finite "
                     f"{all(bool(torch.isfinite(t).all()) for t in got)}")
            print(line, flush=True)
    for label, b, s, h, g, n in (("zamba2", 2, 4096, 64, 1, 64),
                                 ("mamba2-2.7b", 2, 4096, 80, 1, 128),
                                 ("zamba2 train", 4, 2048, 64, 1, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 1.0)
            dy = rn(gen, (b, s, h, 64), dtype)
            _, st = ss._ssd_cuda(*ins, states=True)
            bwd = lambda: ss._ssd_bwd_cuda(*ins, dy, st)  # noqa: E731
            fwd = lambda: ss._ssd_cuda(*ins, states=True)  # noqa
            ms, fwd_ms = cuda_ms(bwd, 10), cuda_ms(fwd, 10)
            plain_ms = cuda_ms(lambda: ss.ssd_scan_bwd_plain(*ins, dy), 1)
            bound, by = chip_smoke.ssd_bwd_bound(ins[0], ins[3], 64)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                bwd()
                torch.cuda.synchronize()
            per = "; ".join(f"{e.key[:40]} {e.self_device_time_total:.1f} us"
                            for e in prof.key_averages()
                            if "ssd_bwd" in e.key)
            print(f"ssd bwd {label} {str(dtype)[6:]} b={b} s={s} h={h} "
                  f"n={n}: {ms:.4f} ms (forward with states {fwd_ms:.4f} "
                  f"ms); plain {plain_ms:.2f} ms; bound {bound:.5f} ms by "
                  f"{by}; per launch: {per}", flush=True)
            del ins, dy, st


def probe_ssd_compare(other: str) -> None:
    """The forward kernel built from another copy of csrc/ssd_scan.cu
    (`other`, e.g. the parent commit's) against this checkout's serving
    launch (no group states asked for), bf16 and float32 at zamba2's
    prefill shape and mamba2-2.7b's: y compared bit for bit, timed in
    turns (other, this, this, other)."""
    lib = build.BUILD_DIR.parent / "probe" / "ssd_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).ssd_scan_launch
    fn.argtypes = ss._lib().argtypes
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=DEV).manual_seed(3)
    for b, s, h, g, n in ((2, 4096, 64, 1, 64), (2, 4096, 80, 1, 128)):
        for dtype, reps in ((torch.bfloat16, 50), (torch.float32, 10)):
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 1.0)

            def run_other():
                done, st, decay = ss._prepare(*ins)
                y = torch.empty_like(ins[0])
                err = fn(*[t.data_ptr() for t in done], y.data_ptr(),
                         st.data_ptr(), decay.data_ptr(), b, s, h, 64, g, n,
                         ss.TILE, ss.GROUP_CHUNKS, ss.DTYPES[dtype],
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
                return y

            this = lambda: ss._ssd_cuda(*ins)  # noqa: E731
            same = torch.equal(run_other(), this())
            for name in ("other", "this", "this", "other"):
                f = run_other if name == "other" else this
                print(f"ssd {str(dtype)[6:]} b={b} s={s} h={h} n={n}, {name} "
                      f"({other if name == 'other' else 'checkout'}): "
                      f"{cuda_ms(f, reps):.4f} ms", flush=True)
            print(f"ssd {str(dtype)[6:]} b={b} s={s} h={h} n={n}: y bit for "
                  f"bit equal: {same}", flush=True)


def record_ops(fn):
    """Run `fn()` recording each aten op in order: (op, host copies of its
    tensor inputs, host copies of its tensor outputs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def host(xs):
        return [x.detach().cpu().clone() for x in tree_leaves(xs)
                if isinstance(x, torch.Tensor)]

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append((str(func), host((args, kwargs or {})),
                             host(out)))
            return out

    with Record() as rec:
        fn()
    return rec.ops


def probe_row_stage() -> None:
    """The row stage (`scenarios._features` and `_row_loads`: the load
    rules, the rail losses, the row sums) of every registered platform
    on its default scenario grid, once on the card and once on the CPU
    from the same inputs, each aten op recorded; prints the first op
    whose output bits differ, with whether its inputs were bit-equal
    (then the op itself rounds differently on the card)."""
    from repro_torch.core import platform as registry
    from repro_torch.core import scenarios as sc
    for name in registry.names():
        plat = registry.get(name)
        sset = sc.ScenarioSet.grid()
        runs = []
        for dev in (DEV, torch.device("cpu")):
            vec, th = sset.vec(dev), sc._theta(plat, None, dev)
            tabs = sc._tables(plat, dev)
            rules = sc._rules(plat)
            n = vec["compression"].shape[0]
            run = lambda: sc._row_loads(  # noqa: E731
                rules, sc._features(plat, vec, tabs), th, tabs, n)
            run()                       # caches filled outside the record
            runs.append(record_ops(run))
        card, cpu = runs
        line = (f"row stage {name} ({len(card)} ops on the card, {len(cpu)} "
                f"on the CPU): ")
        for k, ((op, ins, outs), (op2, ins2, outs2)) in enumerate(
                zip(card, cpu)):
            if op != op2:
                line += f"op {k} differs in kind: {op} vs {op2}"
                break
            bad = [(a, b) for a, b in zip(outs, outs2)
                   if not chip_smoke.bits_equal(a, b)]
            if bad:
                a, b = bad[0]
                diff = (a.double() - b.double()).abs()
                same_in = all(chip_smoke.bits_equal(x, y)
                              for x, y in zip(ins, ins2))
                line += (f"first differing output at op {k} {op}: shape "
                         f"{tuple(a.shape)} {a.dtype}, {int((diff > 0).sum())}"
                         f" elements differ, max abs diff {float(diff.max()):.3g}"
                         f" at max |value| {float(b.double().abs().max()):.3g}; "
                         f"its inputs bit-equal: {same_in} (input shapes "
                         f"{[tuple(x.shape) for x in ins]})")
                break
        else:
            line += "every op's output bit-equal"
        print(line, flush=True)


def variant_source() -> Path:
    """csrc/flash_attention.cu with two knobs: FA_WARPS (warps a block)
    and FA_EXP2 (scale·log2e folded into exp2f)."""
    s = (build.CSRC / "flash_attention.cu").read_text()
    s = s.replace("constexpr int BF_WARPS = 8;",
                  "#ifndef FA_WARPS\n#define FA_WARPS 8\n#endif\n"
                  "constexpr int BF_WARPS = FA_WARPS;")
    s = s.replace("  const int r_first = q0 + 16 * warp;",
                  "  const float sl2 = a.scale * 1.4426950408889634f;\n"
                  "  const int r_first = q0 + 16 * warp;")
    s = s.replace("          float x = s[j][e] * a.scale;",
                  "#ifdef FA_EXP2\n          float x = s[j][e] * sl2;\n"
                  "#else\n          float x = s[j][e] * a.scale;\n#endif")
    for old in ("alpha[r] = expf(m[r] - m_new);",
                "s[j][2 * r] = expf(s[j][2 * r] - m_new);",
                "s[j][2 * r + 1] = expf(s[j][2 * r + 1] - m_new);"):
        if old not in s:
            raise RuntimeError(f"flash source changed: {old!r} not found")
        s = s.replace(old, "\n#ifdef FA_EXP2\n" + old.replace("expf", "exp2f")
                      + "\n#else\n" + old + "\n#endif\n")
    out = build.BUILD_DIR.parent / "probe" / "flash_variant.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(s)
    return out


def bind_forward(lib, with_lse: bool):
    """A library's `flash_attention_launch` as a call of the source's
    first ABI (q, k, v, o, B, ...): a build whose entry takes the row
    log-sum-exp pointer after o gets a null one, so parent and change
    run the same serving launch."""
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * (5 if with_lse else 4) \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if not with_lse:
        return fn
    return lambda q, k, v, o, *rest: fn(q, k, v, o, None, *rest)


def probe_flash_variants() -> None:
    """Four builds of the bf16 flash kernel, timed in turns at the prefill
    shape, each with its relative RMS against the plain version on its
    own tiles."""
    src = variant_source()
    variants = {"8 warps, expf": [], "8 warps, exp2f": ["-DFA_EXP2"],
                "4 warps, expf": ["-DFA_WARPS=4"],
                "4 warps, exp2f": ["-DFA_WARPS=4", "-DFA_EXP2"]}
    procs = {}
    for i, (name, flags) in enumerate(variants.items()):
        lib = src.parent / f"flash_variant{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(src)], stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fns[name] = bind_forward(ctypes.CDLL(str(lib)), True)
    gen = torch.Generator(device=DEV).manual_seed(2)
    q, k, v = (rn(gen, (2, 4096, 32, 64), torch.bfloat16) for _ in range(3))

    def run(fn):
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2,
                 4096, 4096, 32, 32, 64, 1, -1, 1 / math.sqrt(64), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o

    for turn in range(2):
        for name, fn in fns.items():
            line = f"flash variant {name}: {cuda_ms(lambda: run(fn)):.4f} ms"
            if turn == 0:
                bq = 64 if name.startswith("4") else 128
                tiled = attn.chunked_attention(q, k, v, causal=True,
                                               chunk_q=bq, chunk_k=64)
                line += f", rel RMS vs tiled {rel_rms(run(fn), tiled):.3g}"
            print(line, flush=True)


def probe_flash_compare(other: str) -> None:
    """The kernel built from another copy of csrc/flash_attention.cu
    (`other`, e.g. a parent commit's) against this checkout's, bf16 and
    float32, timed in turns (other, this, this, other) at the zamba2-1.2b
    prefill shape, outputs compared bit for bit."""
    lib = build.BUILD_DIR.parent / "probe" / "flash_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    fns = {"other": bind_forward(ctypes.CDLL(str(lib)),
                                 "void* lse" in Path(other).read_text()),
           "this": bind_forward(build.load("flash_attention"), True)}
    gen = torch.Generator(device=DEV).manual_seed(2)
    for dtype, reps in ((torch.bfloat16, 50), (torch.float32, 10)):
        q, k, v = (rn(gen, (2, 4096, 32, 64), dtype) for _ in range(3))

        def run(fn):
            o = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     2, 4096, 4096, 32, 32, 64, 1, -1, 1 / math.sqrt(64),
                     fa.DTYPES[dtype],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return o

        same = torch.equal(run(fns["other"]), run(fns["this"]))
        for name in ("other", "this", "this", "other"):
            print(f"flash {str(dtype)[6:]} B=2 S=4096 H=32 Dh=64 causal, "
                  f"{name} ({other if name == 'other' else 'checkout'}): "
                  f"{cuda_ms(lambda: run(fns[name]), reps):.4f} ms",
                  flush=True)
        print(f"{str(dtype)[6:]} outputs bit for bit equal: {same}")


def probe_flash_bwd_compare(other: str) -> None:
    """The backward kernel built from another copy of
    csrc/flash_attention_bwd.cu (`other`, e.g. the parent commit's)
    against this checkout's, at
    every bf16 shape of `chip_smoke.BWD_SHAPES` on the forward kernel's
    own o and lse: each build's largest gradient error against
    `flash_attention_bwd_plain` (over each gradient's largest magnitude),
    whether a repeat is bit-equal, and times in turns (other, this, this,
    other)."""
    lib = build.BUILD_DIR.parent / "probe" / "flash_bwd_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas other: {line.strip()}")
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
    fn.argtypes = fa._bwd_lib().argtypes
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=DEV).manual_seed(9)
    for name, B, Sq, Sk, H, KvH, Dh, causal, window in chip_smoke.BWD_SHAPES:
        q, do = (rn(gen, (B, Sq, H, Dh), torch.bfloat16) for _ in range(2))
        k, v = (rn(gen, (B, Sk, KvH, Dh), torch.bfloat16) for _ in range(2))
        o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window,
                                lse=True)

        def run_other():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty((B, H, Sq), dtype=torch.float32, device=DEV)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk,
                     H, KvH, Dh, int(causal),
                     -1 if window is None else window, 1 / math.sqrt(Dh), 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return dq, dk, dv

        this = lambda: fa._flash_bwd_cuda(  # noqa: E731
            q, k, v, o, do, lse, causal=causal, window=window)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=causal, window=window)
        label = (f"flash bwd {name} B={B} Sq={Sq} Sk={Sk} H={H} KvH={KvH} "
                 f"Dh={Dh} causal={causal} window={window} bf16")
        for who, f in (("other", run_other), ("this", this)):
            a, b = f(), f()
            torch.cuda.synchronize()
            rel = [float((x.float() - w.float()).abs().max()
                         / w.float().abs().max()) for x, w in zip(a, plain)]
            same = all(chip_smoke.bits_equal(x, y) for x, y in zip(a, b))
            print(f"{label}, {who}: dq/dk/dv max err / max |.| vs "
                  f"flash_attention_bwd_plain "
                  + "/".join(f"{r:.3g}" for r in rel)
                  + f"; a repeat bit-equal: {same}", flush=True)
        for who in ("other", "this", "this", "other"):
            f = run_other if who == "other" else this
            print(f"{label}, {who} ({other if who == 'other' else 'checkout'}"
                  f"): {cuda_ms(f, 10):.4f} ms", flush=True)
        del q, k, v, do, o, lse, plain


def bind_ssd_bwd(path: str):
    """Build another copy of csrc/ssd_scan_bwd.cu (with this checkout's
    entry point) into build/probe/ and return a call (x, dt, A, B, C, dy,
    states) -> (dx, ddt, dA, dB, dC) through the checkout's wrapper."""
    lib = build.BUILD_DIR.parent / "probe" / "ssd_bwd_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr}")
    print("ptxas other: " + "; ".join(chip_smoke.ptxas_kernels(proc.stderr)))
    fn = ctypes.CDLL(str(lib)).ssd_scan_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ss._bwd_lib().argtypes

    def run(x, dt, A, B, C, dy, states):
        saved = ss._bwd_lib
        ss._bwd_lib = lambda: fn
        try:
            return ss._ssd_bwd_cuda(x, dt, A, B, C, dy, states)
        finally:
            ss._bwd_lib = saved
    return run


def probe_ssd_bwd_compare(other: str) -> None:
    """The SSD backward built from another copy of csrc/ssd_scan_bwd.cu
    (`other`: the parent commit's, or an edited copy of this one) against
    this checkout's, at zamba2's and mamba2-2.7b's prefill shapes and phase
    24's step shape, bf16 and float32, on the forward kernel's own group
    states: each build's largest gradient error against
    `ssd_scan_bwd_plain` (over each gradient's largest magnitude; bf16
    also the relative RMS), whether a repeat is bit-equal, and times in
    turns (other, this, this, other)."""
    build.build_all(("ssd_scan", "ssd_scan_bwd"))
    print("ptxas this: " + "; ".join(chip_smoke.ptxas_kernels(
        build.BUILD_LOG.get("ssd_scan_bwd", ""))))
    run_other = bind_ssd_bwd(other)
    names = ("dx", "ddt", "dA", "dB", "dC")
    gen = torch.Generator(device=DEV).manual_seed(13)
    for label, b, s, h, g, n in (("zamba2", 2, 4096, 64, 1, 64),
                                 ("mamba2-2.7b", 2, 4096, 80, 1, 128),
                                 ("zamba2 train", 4, 2048, 64, 1, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 1.0)
            dy = rn(gen, (b, s, h, 64), dtype)
            _, st = ss._ssd_cuda(*ins, states=True)
            fns = {"other": lambda: run_other(*ins, dy, st),
                   "this": lambda: ss._ssd_bwd_cuda(*ins, dy, st)}
            plain = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
            tag = (f"ssd bwd {label} {str(dtype)[6:]} b={b} s={s} h={h} "
                   f"g={g} n={n}")
            for who, f in fns.items():
                a, c = f(), f()
                torch.cuda.synchronize()
                line = (f"{tag}, {who}: vs plain " + " ".join(
                    f"{k} {rel_max(x, w):.3g}"
                    for k, x, w in zip(names, a, plain)))
                if dtype == torch.bfloat16:
                    line += "; rel RMS " + " ".join(
                        f"{k} {rel_rms(x, w):.3g}"
                        for k, x, w in zip(names, a, plain))
                same = all(torch.equal(x, y) for x, y in zip(a, c))
                print(line + f"; a repeat bit-equal: {same}", flush=True)
            for who in ("other", "this", "this", "other"):
                where = other if who == "other" else "checkout"
                print(f"{tag}, {who} ({where}): "
                      f"{cuda_ms(fns[who], 10):.4f} ms", flush=True)
            del ins, dy, st, plain


def main() -> None:
    probes = {"day": probe_day, "flash": probe_flash, "ssd": probe_ssd,
              "flash-variants": probe_flash_variants,
              "flash-bwd": probe_flash_bwd, "ssd-bwd": probe_ssd_bwd,
              "row-stage": probe_row_stage}
    compare = {"flash-compare": probe_flash_compare,
               "flash-bwd-compare": probe_flash_bwd_compare,
               "ssd-compare": probe_ssd_compare,
               "ssd-bwd-compare": probe_ssd_bwd_compare}
    if len(sys.argv) == 3 and sys.argv[1] in compare:
        probes[sys.argv[1]] = lambda: compare[sys.argv[1]](sys.argv[2])
    elif len(sys.argv) != 2 or sys.argv[1] not in probes:
        sys.exit(f"usage: kernel_probe.py {{{'|'.join(probes)}}} | "
                 f"{{{'|'.join(compare)}}} OTHER.cu")
    if not torch.cuda.is_available():
        sys.exit("kernel_probe.py: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    probes[sys.argv[1]]()


if __name__ == "__main__":
    main()
