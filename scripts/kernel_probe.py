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
    python3 scripts/kernel_probe.py flash-bf16-variants  # the bf16
                                                     # forward at the built
                                                     # widths with one part
                                                     # of its design
                                                     # switched off, in
                                                     # turns
    python3 scripts/kernel_probe.py flash-compare OTHER.cu   # another copy
                                                     # of the flash source
                                                     # vs this one, in turns
    python3 scripts/kernel_probe.py flash-bwd-compare OTHER.cu   # another
                                                     # copy of the flash
                                                     # backward's source vs
                                                     # this one, in turns,
                                                     # built and wide widths
    python3 scripts/kernel_probe.py flash-bwd-variants   # the bf16 wide
                                                     # backward with one
                                                     # part of its step
                                                     # dropped, in turns
                                                     # (flash-bwd-f32-
                                                     # built-variants: the
                                                     # float32 clusters at
                                                     # Dh 128 and 256)
    python3 scripts/kernel_probe.py ssd-bwd          # the SSD backward:
                                                     # ptxas, edges vs its
                                                     # plain version and
                                                     # autograd, times
    python3 scripts/kernel_probe.py ssd-bwd-compare OTHER.cu   # another
                                                     # copy of the SSD
                                                     # backward's source
                                                     # vs this one, in turns
    python3 scripts/kernel_probe.py ssd-bwd-variants # the bf16 backward
                                                     # with one part of its
                                                     # design switched, in
                                                     # turns
    python3 scripts/kernel_probe.py ssd-compare OTHER.cu     # the SSD
                                                     # forward's serving
                                                     # launch, another
                                                     # source vs this one
    python3 scripts/kernel_probe.py day-compare OTHER.cu     # another copy
                                                     # of the day scan's
                                                     # source vs this one,
                                                     # in turns, and their
                                                     # SASS
    python3 scripts/kernel_probe.py row-stage        # the first op of the
                                                     # row stage whose bits
                                                     # differ card vs CPU
    python3 scripts/kernel_probe.py wide             # chip_smoke.py's
                                                     # phase 33 alone: the
                                                     # widths above the
                                                     # built ones

Run from the root of a checkout.  Every line it prints is a reading of
the card named on its first line.  `day` builds csrc/day_scan.cu and the
one-thread-per-combo baseline csrc/day_scan_thread.cu with their probe
modes (as is; inputs held in registers; no loads or stores, the chain's
floor) and times each on the serving grid's tables at N = 1, 64 and 1024
combos, in ns and SM cycles per step.  `flash-bf16-variants` builds
copies of csrc/flash_attention.cu with one switch of flash_fwd_hb's
design flipped (`BF16_VARIANTS`: the consumers' turns, the softmax
overlap, TMA, ex2.approx, the fma fold, the 128-key tile, the stages)
or the softmax or the products
dropped into build/probe/ and times them in turns at the prefill shapes.
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
# the SSD forward's launch names in a profile (ssd_kernel_scan_hb<64, false>)
SSD_KERNEL = re.compile(r"ssd_kernel_\w+<[^>]*>")


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
            bq, bk = fa.fwd_tile(Dh, dtype)
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


def ssd_inputs(gen, b, s, h, g, n, dtype, dt_scale, p=64):
    x = rn(gen, (b, s, h, p), dtype, 0.5)
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


def bind_ssd(path) -> tuple:
    """Build another copy of csrc/ssd_scan.cu (with this checkout's flags)
    into build/probe/ and return (its library path, run), run(x, dt, A,
    B, C) -> y through this checkout's `ssd_blocked` with that build's
    forward entry point: this design's (x / B / C strides after the ints,
    views read where they lie) or, from a source without
    `ssd_scan_heads`, PR 13's (dense inputs, the ints alone)."""
    name = Path(path).stem
    lib = build.BUILD_DIR.parent / "probe" / f"ssd_{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.ssd_scan_launch
    strided = hasattr(cdll, "ssd_scan_heads")
    fn.argtypes = ss._lib().argtypes if strided else \
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def block(x_, dt_, A_, B_, C_, f32):
        ins, st, decay = ss._prepare(x_, dt_, A_, B_, C_, views=strided)
        y = torch.empty_like(ins[0], dtype=torch.float32 if f32 else x_.dtype,
                             memory_format=torch.contiguous_format)
        args = ss._fwd_args(ins, f32) if strided else \
            ss._dims(ins[0], ins[3], f32)
        err = fn(*[None if t is None else t.data_ptr()
                   for t in (*ins, y, st, decay)], *args,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y, st
    return lib, proc.stderr, (lambda *ins: ss.ssd_blocked(*ins, block)[0])


# the forward's compared and timed shapes (label, b, s, h, g, n, p):
# zamba2-1.2b's and mamba2-2.7b's prefill, and phase 33 c's p 128 / n 256
SSD_COMPARED = (("zamba2-1.2b", 2, 4096, 64, 1, 64, 64),
                ("mamba2-2.7b", 2, 4096, 80, 1, 128, 64),
                ("p 128 n 256", *chip_smoke.WIDE_SSD_TIMED[:3],
                 chip_smoke.WIDE_SSD_TIMED[3], chip_smoke.WIDE_SSD_TIMED[4],
                 chip_smoke.WIDE_SSD_TIMED[6]))


def probe_ssd_compare(other: str) -> None:
    """The forward built from another copy of csrc/ssd_scan.cu (`other`,
    e.g. the parent commit's) against this checkout's serving launch (no
    group states asked for) at `SSD_COMPARED`: bf16 at every shape, each
    build's relative RMS and largest error against `ssd_scan_plain` and
    the two builds' largest difference (bf16 y is not bit-equal across
    designs); float32 at zamba2's and mamba2's, bit for bit; each build's
    repeat bit-equal; times in turns (other, this, this, other); then
    each kernel's SASS diffed."""
    other_lib, _, run_other = bind_ssd(other)
    gen = torch.Generator(device=DEV).manual_seed(3)
    for label, b, s, h, g, n, p in SSD_COMPARED:
        for dtype, reps in ((torch.bfloat16, 20), (torch.float32, 5)):
            if dtype == torch.float32 and p != 64:
                continue
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 1.0, p)
            runs = {"other": lambda: run_other(*ins),
                    "this": lambda: ss._ssd_cuda(*ins)}
            tag = (f"ssd {label} {str(dtype)[6:]} b={b} s={s} h={h} p={p} "
                   f"g={g} n={n}")
            ys = {who: f() for who, f in runs.items()}
            repeat = {who: torch.equal(f(), ys[who]) for who, f in runs.items()}
            if dtype == torch.float32:
                print(f"{tag}: y bit for bit equal: "
                      f"{torch.equal(ys['other'], ys['this'])}; repeats "
                      f"bit-equal {repeat}", flush=True)
            else:
                want = ss.ssd_scan_plain(*ins, chunk=64)
                errs = "; ".join(
                    f"{who} rel RMS {rel_rms(y, want):.3g}, max abs "
                    f"{float((y.float() - want.float()).abs().max()):.3g}"
                    for who, y in ys.items())
                diff = float((ys["other"].float() - ys["this"].float())
                             .abs().max())
                print(f"{tag}: vs ssd_scan_plain {errs} (max |y| "
                      f"{float(want.float().abs().max()):.3g}); the builds' "
                      f"largest difference {diff:.3g}; repeats bit-equal "
                      f"{repeat}", flush=True)
            for who in ("other", "this", "this", "other"):
                print(f"{tag}, {who} "
                      f"({other if who == 'other' else 'checkout'}): "
                      f"{cuda_ms(runs[who], reps):.4f} ms", flush=True)
            del ins, ys
    sass_diff(other_lib, build.library_path("ssd_scan"))


# builds of csrc/ssd_scan.cu with one switch of the bf16 forward's design
# flipped (levers a-e of its design), then two diagnostics that break the
# result to weigh a part: (name, [(old, new) text edits])
SSD_VARIANTS = {
    "as built": [],
    "a: each product waited for at once (no overlap)": [
        ("constexpr bool SSD_OVERLAP = true;",
         "constexpr bool SSD_OVERLAP = false;")],
    "b: dt not folded into W (x dt split, six part products)": [
        ("constexpr bool SSD_FOLD = true;", "constexpr bool SSD_FOLD = false;")],
    "c: cp.async by the producer warp in place of TMA": [
        ("constexpr bool SSD_TMA = true;", "constexpr bool SSD_TMA = false;")],
    "d: one head a block in the scan": [
        ("constexpr int SSD_HEADS = 2;", "constexpr int SSD_HEADS = 1;")],
    "d: three heads a block in the scan at n 64": [
        ("__host__ __device__ constexpr int hb_heads(int) { return SSD_HEADS; }",
         "__host__ __device__ constexpr int hb_heads(int n) {\n"
         "  return n == 64 ? 3 : SSD_HEADS;\n}")],
    "e: two heads a block in launch 1": [
        ("constexpr int SSD_STATE_HEADS = 1;",
         "constexpr int SSD_STATE_HEADS = 2;")],
    "expf in place of ex2.approx": [
        ("constexpr bool SSD_EXP2 = true;", "constexpr bool SSD_EXP2 = false;")],
    # where the time goes (wrong outputs: they only time what is left)
    "no exps (every decay 1)": [
        ("constexpr bool SSD_NO_EXP = false;",
         "constexpr bool SSD_NO_EXP = true;")],
    "no products (no wgmma issued)": [
        ("constexpr bool SSD_NO_PRODUCTS = false;",
         "constexpr bool SSD_NO_PRODUCTS = true;")],
}


def ssd_variant_sources(variants=None) -> dict:
    """{variant name: its source text}, each edit checked to apply."""
    variants = SSD_VARIANTS if variants is None else variants
    src = (build.CSRC / "ssd_scan.cu").read_text()
    out = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ssd source changed: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def probe_ssd_variants(variants=None, shapes=SSD_COMPARED[:2]) -> None:
    """Builds of csrc/ssd_scan.cu with one switch of the bf16 forward's
    design flipped (`SSD_VARIANTS`), each beside its ptxas lines and its
    relative RMS against `ssd_scan_plain`, timed in turns (each in order,
    then in reverse) at zamba2's and mamba2-2.7b's prefill shapes: what
    each lever buys, and where the time goes."""
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(ssd_variant_sources(variants).items()):
        paths[name] = out / f"ssd_variant{i}.cu"
        paths[name].write_text(text)
    from concurrent.futures import ThreadPoolExecutor
    ss._lib()                           # this build once, before the pool
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        bound = dict(zip(paths, pool.map(bind_ssd, paths.values())))
    runs = {}
    for name, (_, log, run) in bound.items():
        print(f"ptxas {name}: " + "; ".join(
            k for k in chip_smoke.ptxas_kernels(log)
            if "_hb<" in k or "warning" in k), flush=True)
        runs[name] = run
    gen = torch.Generator(device=DEV).manual_seed(9)
    for label, b, s, h, g, n, p in shapes:
        ins = ssd_inputs(gen, b, s, h, g, n, torch.bfloat16, 1.0, p)
        want = ss.ssd_scan_plain(*ins, chunk=64)
        for name, run in runs.items():
            y = run(*ins)
            print(f"ssd variant {name} ({label}): rel RMS vs plain "
                  f"{rel_rms(y, want):.3g}, repeat bit-equal "
                  f"{torch.equal(y, run(*ins))}", flush=True)
        order = list(runs)
        for name in order + order[::-1]:
            print(f"ssd variant {name} ({label}: b={b} s={s} h={h} g={g} "
                  f"n={n} bf16): {cuda_ms(lambda: runs[name](*ins), 20):.4f}"
                  f" ms", flush=True)
        del ins, want


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


def other_width(text: str):
    """`kernel_width` as another copy of a flash source (`text`) takes
    heads: a copy that still holds the CUDA-core float32 kernels
    (`flash_kernel_f32`, `flash_bwd_dkdv`) runs float32 at bf16's widths,
    Dh 96 unpadded; one without them, this checkout's rule (96 at 128)."""
    real = fa.kernel_width
    if "flash_kernel_f32" in text or "flash_bwd_dkdv" in text:
        return lambda Dh, dtype: real(Dh, torch.bfloat16)
    return real


def probe_flash_compare(other: str) -> None:
    """The kernel built from another copy of csrc/flash_attention.cu
    (`other`, e.g. a parent commit's) against this checkout's.  At the
    zamba2-1.2b prefill shape, bf16 and float32, both called directly:
    times in turns (other, this, this, other), outputs bit for bit.  Then
    through the checkout's wrapper (padding; `_lib` swapped): at
    `FLASH_TIMED` in both dtypes (the built widths 96 and 256), olmo-1b's
    prefill (B 2 x S 2048, H 16, Dh 128) in float32, the bf16 forward's
    `chip_smoke.FWD_SHAPES` (olmo-1b, whisper's encoder, cross and decoder
    attention, gemma3-4b's global and local layers, phi-3-vision,
    zamba2-1.2b's shared block), every `chip_smoke.WIDE_FLASH` shape in
    both dtypes and `chip_smoke.WIDE_FLASH_TIMED` in both, each with o and
    its row lse compared bit for bit between the builds, each build's
    largest error against the plain version (o, and in float32 the lse
    against `flash_attention_lse_plain`) and whether a repeat is
    bit-equal and, in float32, the two builds' largest difference; times
    in turns at the timed shapes and the wide ones, each build at the head
    width it takes (`other_width`); last, how many SASS instructions of
    each kernel differ."""
    lib = build.BUILD_DIR.parent / "probe" / "flash_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    print("ptxas other: " + "; ".join(chip_smoke.ptxas_kernels(proc.stderr)))
    build.build("flash_attention")
    print("ptxas this: " + ("; ".join(chip_smoke.ptxas_kernels(
        build.BUILD_LOG["flash_attention"]))
        if "flash_attention" in build.BUILD_LOG else "built before"))
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
    other_fn = ctypes.CDLL(str(lib)).flash_attention_launch
    other_fn.argtypes = fa._lib().argtypes
    other_fn.restype = ctypes.c_int
    B, S, H, KvH, Dh, causal, window = chip_smoke.WIDE_FLASH_TIMED
    shapes = [((f"timed Dh {d}", 2, 4096, 4096, h, kvh, d, True, w), dtype)
              for h, kvh, d, w in FLASH_TIMED[1:]
              for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(("timed olmo-1b Dh 128", 2, 2048, 2048, 16, 16, 128, True,
                 None), torch.float32)]
    shapes += [((f"timed {s_[0]}", *s_[1:]), torch.bfloat16)
               for s_ in chip_smoke.FWD_SHAPES]
    width = other_width(Path(other).read_text())
    shapes += [(s_, dtype) for s_ in chip_smoke.WIDE_FLASH
               for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(("timed", B, S, S, H, KvH, Dh, causal, window), dtype)
               for dtype in (torch.bfloat16, torch.float32)]
    for (name, B, Sq, Sk, H, KvH, Dh, causal, window), dtype in shapes:
        q = rn(gen, (B, Sq, H, Dh), dtype)
        k, v = (rn(gen, (B, Sk, KvH, Dh), dtype) for _ in range(2))
        mask = dict(causal=causal, window=window)

        def this():
            return fa._flash_cuda(q, k, v, lse=True, **mask)

        def run_other():
            saved = fa._lib, fa.kernel_width
            fa._lib, fa.kernel_width = (lambda: other_fn), width
            try:
                return this()
            finally:
                fa._lib, fa.kernel_width = saved
        label = (f"flash {name} B={B} Sq={Sq} Sk={Sk} H={H} KvH={KvH} "
                 f"Dh={Dh} causal={causal} window={window} "
                 f"{str(dtype)[6:]}")
        wide = Dh > 256
        f32 = dtype == torch.float32
        firsts = []
        for who, f in (("other", run_other), ("this", this)):
            a, b = f(), f()
            torch.cuda.synchronize()
            firsts.append(a)
            err = float((a[0].float() - fa.flash_attention_plain(
                q, k, v, **mask).float()).abs().max())
            same = all(chip_smoke.bits_equal(x, y) for x, y in zip(a, b))
            lse = ""
            if f32:
                lse_err = (a[1] - fa.flash_attention_lse_plain(q, k, **mask))
                lse = f", lse {float(lse_err.abs().max()):.3g}"
            print(f"{label}, {who}: max abs err vs flash_attention_plain "
                  f"{err:.3g}{lse}; a repeat bit-equal: {same}", flush=True)
        line = (f"{label}: other and this bit-equal (o, lse): "
                f"{all(chip_smoke.bits_equal(x, y) for x, y in zip(*firsts))}")
        if f32:
            line += ("; their largest difference o "
                     f"{float((firsts[0][0] - firsts[1][0]).abs().max()):.3g}, "
                     f"lse {float((firsts[0][1] - firsts[1][1]).abs().max()):.3g}")
        print(line, flush=True)
        if not (name.startswith("timed") or wide):
            continue
        reps = 20 if Dh <= 256 and dtype == torch.bfloat16 else \
            10 if Sq * Sk * Dh < 2 ** 31 else 5
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            f = run_other if who == "other" else this
            times[who].append(cuda_ms(f, reps))
            print(f"{label}, {who} ({other if who == 'other' else 'checkout'}"
                  f"): {times[who][-1]:.4f} ms", flush=True)
        print(f"{label}: other / this "
              f"{sum(times['other']) / sum(times['this']):.3f} (means of "
              f"{reps} calls in turns)", flush=True)
        del q, k, v, firsts
    sass_diff(lib, build.library_path("flash_attention"))


# source edits of csrc/flash_attention.cu for `flash-wide-variants`: each
# drops or changes one part of the bf16 wide forward's step (the dropped
# ones give wrong outputs: they only time what is left)
_FW_BARRIERS = [('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" '
                 '::: "memory");', "  __syncthreads();"),
                ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" '
                 '::: "memory");', "  __syncthreads();"),
                ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" '
                 '::: "memory");', "")]
# each block's partial written into its own exchange (wrong scores: the
# sum adds it to itself), so no distributed shared memory is touched
_FW_LOCAL = [("  float4* out = push ? const_cast<float4*>(peer(mine, 1 - cb)) "
              ": mine;", "  float4* out = mine;")]
_FW_COPIES = [("    if (i + 2 < n) stage_kv(ks + (i & 1) * FW_KB, a.k, i + 2);",
               "    if (i + 2 < n && i == 0) "
               "stage_kv(ks + (i & 1) * FW_KB, a.k, i + 2);"),
              ("    if (i + 1 < n) stage_kv(vs + ((i + 1) & 1) * FW_KB, a.v, "
               "i + 1);",
               "    if (i + 1 < n && i == 0) "
               "stage_kv(vs + ((i + 1) & 1) * FW_KB, a.v, i + 1);")]
FWD_VARIANTS = {
    "as built": [],
    "two ranks pulled (the peer's partial read from its exchange)": [
        ("  const bool push = x.ranks == 2;", "  const bool push = false;")],
    "the partials-read arrive with a release fence": [
        ("    cluster_arrive_relaxed();              // R_i",
         "    cluster_arrive();                      // R_i")],
    "own exchange only (no DSMEM)": _FW_LOCAL,
    "own exchange, block barriers for the cluster's": [*_FW_LOCAL,
                                                       *_FW_BARRIERS],
    "no partial products (S partials zero)": [
        ("    fw_scores<NC>(s, qw, ks + (i & 1) * FW_KB, false);",
         "#pragma unroll\n"
         "    for (int e = 0; e < 32; ++e) s[e] = 0.f;")],
    "no PV products": [
        ("    if (live) fw_pv<NC>(acc, pa, vs + (i & 1) * FW_KB);",
         "    if (live) fence_acc<NC * 32>(acc);")],
    "K and V copied for the first kv tiles only": _FW_COPIES,
    "own exchange, block barriers, copies for the first tiles only": [
        *_FW_LOCAL, *_FW_BARRIERS, *_FW_COPIES],
    "design b: no cluster, each block forms S over the head": [
        ("  x.ranks = x.ncb <= FW_CLUSTER ? x.ncb : 1;", "  x.ranks = 1;")],
}


# the same for the float32 wide forward (flash_fwd_hf)
_FF_LOCAL = [("      if (r < x.ranks) t[r] = (r == cb ? xch : peer(xch, r))[pos];",
              "      if (r < x.ranks) t[r] = xch[pos];"),
             ("        (r == cb ? xch : const_cast<float4*>(peer(xch, r)))[pos]"
              " = t[0];", "        xch[pos] = t[0];")]
_FF_COPIES = [("    ff_split_kv<NC>(vs, slots);\n    if (i + 1 < n) ff_copy_kv<NC>",
               "    if (i == 0) ff_split_kv<NC>(vs, slots);\n"
               "    if (i + 1 < n && i == 0) ff_copy_kv<NC>"),
              ("    if (i + 1 < n) {               // K_{i+1} in, V_{i+1} to the "
               "slots", "    if (i + 1 < n && i == 0) {")]
FWD_F32_VARIANTS = {
    "as built": [],
    "64-column blocks (one chunk, 8 a cluster at Dh 512)": [
        ("constexpr int FF_MAX_CHUNKS = 2;", "constexpr int FF_MAX_CHUNKS = 1;")],
    "own exchange only (no DSMEM)": _FF_LOCAL,
    "own exchange, block barriers for the cluster's": [*_FF_LOCAL,
                                                       *_FW_BARRIERS],
    "no owner sums (the barrier kept)": [
        ("  for (int pos = lo + threadIdx.x; pos < hi; pos += 256) {",
         "  for (int pos = lo + threadIdx.x; pos < lo; pos += 256) {")],
    "no partial products (S partials zero)": [
        ("    ff_scores<NC>(s, qw, ks);",
         "#pragma unroll\n    for (int e = 0; e < 32; ++e) s[e] = 0.f;")],
    "no PV products": [
        ("    ff_frags(f, s);\n    ff_pv(tmp, f, vs);",
         "    for (int e = 0; e < 32; ++e) tmp[e] = 0.f;"),
        ("    if constexpr (NC > 1) ff_accumulate<NC - 1>(acc + 32, f, "
         "vs + FF_KP,\n                                                live);",
         "")],
    "K and V split and copied for the first tiles only": _FF_COPIES,
    "own exchange, block barriers, first tiles' copies only": [
        *_FF_LOCAL, *_FW_BARRIERS, *_FF_COPIES],
    "one bf16 part (hi.hi only: the precision control)": [
        ("constexpr int FF_PAIRS = 6;", "constexpr int FF_PAIRS = 1;")],
    "design b: no cluster, each block forms S over the head": [
        ("  x.ranks = x.ncb <= FW_CLUSTER ? x.ncb : 1;", "  x.ranks = 1;")],
}


# the bf16 forward at the built widths (flash_fwd_hb): each part of the
# design switched off in turn (the outputs stay right; the kv tile of 64
# rounds p on other tiles), then two parts of the step dropped
BF16_VARIANTS = {
    "as built": [],
    "no ping-pong (the consumers issue as they come)": [
        ("constexpr bool HB_PINGPONG = true;",
         "constexpr bool HB_PINGPONG = false;")],
    "no softmax overlap (one product at a time)": [
        ("constexpr bool HB_OVERLAP = true;",
         "constexpr bool HB_OVERLAP = false;")],
    "neither overlap nor ping-pong": [
        ("constexpr bool HB_PINGPONG = true;",
         "constexpr bool HB_PINGPONG = false;"),
        ("constexpr bool HB_OVERLAP = true;",
         "constexpr bool HB_OVERLAP = false;")],
    "cp.async by the producer warpgroup in place of TMA": [
        ("constexpr bool HB_TMA = true;", "constexpr bool HB_TMA = false;")],
    "expf in place of ex2.approx": [
        ("constexpr bool HB_EXP2 = true;", "constexpr bool HB_EXP2 = false;")],
    "kv tile 64 at Dh <= 128": [
        ("return dh <= 128 ? 128 : 64;", "return 64;")],
    "three stages up to Dh 128": [
        ("constexpr int hb_stages(int) { return 2; }",
         "constexpr int hb_stages(int dh) { return dh <= 128 ? 3 : 2; }")],
    "the scale and the shift in two steps (no fma)": [
        ("constexpr bool HB_FOLD = true;", "constexpr bool HB_FOLD = false;")],
    # where the time goes (wrong outputs: they only time what is left)
    "no softmax (P = S)": [
        ("  const bool fold = HB_FOLD && !edge && sc > 0.f;",
         "  alpha[0] = alpha[1] = 1.f;\n  if (sc != 0.f) return;\n"
         "  const bool fold = HB_FOLD && !edge && sc > 0.f;")],
    "no products (S and P V not issued)": [
        ("  for (int kk = 0; kk < DH / 16; ++kk) {   // chunk kk / 4, its "
         "k-step", "  for (int kk = 0; kk < 0; ++kk) {"),
        ("  for (int kk = 0; kk < T::BK / 16; ++kk) {\n"
         "    const unsigned char* rows = v + kk * 16 * 128;",
         "  for (int kk = 0; kk < 0; ++kk) {\n"
         "    const unsigned char* rows = v + kk * 16 * 128;")],
}
# (label, B, S, H, KvH, Dh, causal, window) the built-width variants are
# timed at: the prefill shapes of zamba2-1.2b, phi-3-vision and gemma3-4b
# (FLASH_TIMED) and olmo-1b's training step
BUILT_BF16_SHAPES = (
    ("zamba2-1.2b", 2, 4096, 32, 32, 64, True, None),
    ("phi-3-vision", 2, 4096, 32, 32, 96, True, None),
    ("olmo-1b", 2, 2048, 16, 16, 128, True, None),
    ("gemma3-4b global", 2, 4096, 8, 4, 256, True, None),
    ("gemma3-4b local", 2, 4096, 8, 4, 256, True, 1024))


def probe_flash_wide_variants(variants=None, dtype=torch.bfloat16,
                              shapes=None, kernel=None) -> None:
    """Builds of csrc/flash_attention.cu with one part of a forward's step
    dropped or changed (`FWD_VARIANTS` for the bf16 wide forward,
    `FWD_F32_VARIANTS` for float32, `BF16_VARIANTS` for bf16 at the built
    widths), timed in turns (each in order, then in reverse) at `shapes`
    ((label, B, S, H, KvH, Dh, causal, window); by default
    `chip_smoke.WIDE_FLASH_TIMED`), each beside its largest error against
    the plain version: where the step's time goes.  `kernel` picks the
    ptxas lines printed (by default the wide kernel of `dtype`)."""
    variants = FWD_VARIANTS if variants is None else variants
    if shapes is None:
        shapes = [("timed", *chip_smoke.WIDE_FLASH_TIMED)]
    if kernel is None:
        kernel = "hw<" if dtype == torch.bfloat16 else "hf<"
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"flash source changed: {old!r}")
            text = text.replace(old, new)
        path = out / f"flash_fwd_variant{i}.cu"
        path.write_text(text)
        lib = out / f"flash_fwd_variant{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        print(f"ptxas {name}: " + "; ".join(
            k for k in chip_smoke.ptxas_kernels(err)
            if kernel in k or "warning" in k))
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes = fa._lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device=DEV).manual_seed(9)
    for label, B, S, H, KvH, Dh, causal, window in shapes:
        q = rn(gen, (B, S, H, Dh), dtype)
        k, v = (rn(gen, (B, S, KvH, Dh), dtype) for _ in range(2))

        def run(fn):
            saved = fa._lib
            fa._lib = lambda: fn
            try:
                return fa._flash_cuda(q, k, v, causal=causal, window=window)
            finally:
                fa._lib = saved
        plain = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        for name, fn in fns.items():
            err = float((run(fn).float() - plain.float()).abs().max())
            print(f"flash fwd variant {name} ({label}): max abs err vs "
                  f"plain {err:.3g}", flush=True)
        order = list(fns)
        reps = 20 if Dh <= 256 and dtype == torch.bfloat16 else 5
        for name in order + order[::-1]:
            print(f"flash fwd variant {name} ({label}: B={B} S={S} H={H} "
                  f"KvH={KvH} Dh={Dh} causal window={window} "
                  f"{str(dtype)[6:]}): "
                  f"{cuda_ms(lambda: run(fns[name]), reps):.4f} ms",
                  flush=True)
        del q, k, v, plain


def sass(lib: Path) -> dict:
    """{kernel name: its SASS instructions} of a built library, by
    cuobjdump ({} when cuobjdump is missing or fails); a name is cut to
    start at its function's own name, past the anonymous namespace's
    tag (which holds the source file's name)."""
    try:
        out = subprocess.run(["cuobjdump", "-sass", str(lib)],
                             capture_output=True, text=True).stdout
    except OSError:
        return {}
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+?\d+(?=[a-z])",
                          "", name)
            cur = funcs.setdefault(name, [])
        elif cur is not None and "/*" in line:
            cur.append(line.split("/*")[1].split("*/")[-1].strip()
                       if line.strip().startswith("/*") else
                       line.split("/*")[0].strip())
    return funcs


def probe_day_compare(other: str) -> None:
    """The day scan built from another copy of csrc/day_scan.cu (`other`,
    e.g. a parent commit's) against this checkout's on the serving grid's
    tables (N 64, T 4320, L 3, dt_s 10): all nine outputs bit for bit,
    times in turns (other, this, this, other, other, this; CUDA events
    over 50 launches), and how many SASS lines of each kernel differ."""
    from repro_torch.core import daysim
    lib = build.BUILD_DIR.parent / "probe" / "day_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).day_scan_launch
    fn.argtypes = ds._argtypes(len(ds.OUTS))
    fn.restype = ctypes.c_int
    fns = {"other": fn, "this": ds._entry(False)}
    full, _ = daysim.day_tables(daysim._fused_pipeline(DEV, dt_s=10.0))
    want = ds.day_scan_plain(full)
    for who, f in fns.items():
        got = {k: v.t() for k, v in ds._launch(f, full).items()}
        chip_smoke.compare(got, want)
        print(f"day scan ({who}) == plain on the serving grid: all nine "
              f"outputs bit for bit")
    for who in ("other", "this", "this", "other", "other", "this"):
        print(f"day scan N=64 T=4320 L=3, {who} "
              f"({other if who == 'other' else 'checkout'}): "
              f"{cuda_ms(lambda: ds._launch(fns[who], full), 50):.4f} ms",
              flush=True)
    sass_diff(lib, build.library_path("day_scan"))


def sass_diff(other: Path, this: Path) -> None:
    """For each kernel of the library `other`, its SASS instructions and
    this build's and how many of them differ (a kernel whose SASS is the
    same in both builds times the same: a difference in turns is noise)."""
    import difflib
    mine = sass(this)
    for name, lines in sorted(sass(other).items()):
        if name not in mine:
            print(f"SASS {name}: not in this build")
            continue
        sm = difflib.SequenceMatcher(None, lines, mine[name], autojunk=False)
        changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2
                      in sm.get_opcodes() if tag != "equal")
        print(f"SASS {name}: {len(lines)} / {len(mine[name])} instructions, "
              f"{changed} differ")


def probe_flash_bwd_compare(other: str) -> None:
    """The backward kernel built from another copy of
    csrc/flash_attention_bwd.cu (`other`, e.g. the parent commit's, with
    this checkout's entry point) against this checkout's, both through the
    checkout's wrapper (padding, scratch), on the forward kernel's own o
    and lse: at every `chip_smoke.BWD_SHAPES` entry and every
    `chip_smoke.WIDE_FLASH` shape, bf16 and float32, and at
    `chip_smoke.WIDE_FLASH_TIMED` in both.  For each: each build's largest
    gradient error against `flash_attention_bwd_plain` (over each
    gradient's largest magnitude), whether a repeat is bit-equal, whether
    the two builds' outputs are (float32, whose kernels differ from the
    parent's: their largest difference over each gradient's largest
    magnitude), and times in turns (other, this, this, other), each build
    at the head width it takes (`other_width`); last, how many SASS
    instructions of each kernel differ."""
    build.build_all(("flash_attention", "flash_attention_bwd"))
    print("ptxas this: " + "; ".join(chip_smoke.ptxas_kernels(
        build.BUILD_LOG.get("flash_attention_bwd", ""))))
    lib = build.BUILD_DIR.parent / "probe" / "flash_bwd_other.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           other], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}:\n{proc.stderr}")
    print("ptxas other: " + "; ".join(chip_smoke.ptxas_kernels(proc.stderr)))
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
    fn.argtypes = fa._bwd_lib().argtypes
    fn.restype = ctypes.c_int
    B, S, H, KvH, Dh, causal, window = chip_smoke.WIDE_FLASH_TIMED
    shapes = [(s_, dtype) for s_ in chip_smoke.BWD_SHAPES
              + chip_smoke.WIDE_FLASH
              for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(("timed", B, S, S, H, KvH, Dh, causal, window), dtype)
               for dtype in (torch.bfloat16, torch.float32)]
    width = other_width(Path(other).read_text())
    gen = torch.Generator(device=DEV).manual_seed(9)
    for (name, B, Sq, Sk, H, KvH, Dh, causal, window), dtype in shapes:
        q, do = (rn(gen, (B, Sq, H, Dh), dtype) for _ in range(2))
        k, v = (rn(gen, (B, Sk, KvH, Dh), dtype) for _ in range(2))
        mask = dict(causal=causal, window=window)
        o, lse = fa._flash_cuda(q, k, v, lse=True, **mask)

        def this():
            return fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)

        def run_other():
            saved = fa._bwd_lib, fa.kernel_width
            fa._bwd_lib, fa.kernel_width = (lambda: fn), width
            try:
                return this()
            finally:
                fa._bwd_lib, fa.kernel_width = saved
        plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **mask)
        label = (f"flash bwd {name} B={B} Sq={Sq} Sk={Sk} H={H} KvH={KvH} "
                 f"Dh={Dh} causal={causal} window={window} "
                 f"{str(dtype)[6:]}")
        firsts = []
        for who, f in (("other", run_other), ("this", this)):
            a, b = f(), f()
            torch.cuda.synchronize()
            firsts.append(a)
            rel = [float((x.float() - w.float()).abs().max()
                         / w.float().abs().max()) for x, w in zip(a, plain)]
            same = all(chip_smoke.bits_equal(x, y) for x, y in zip(a, b))
            print(f"{label}, {who}: dq/dk/dv max err / max |.| vs "
                  f"flash_attention_bwd_plain "
                  + "/".join(f"{r:.3g}" for r in rel)
                  + f"; a repeat bit-equal: {same}", flush=True)
        line = (f"{label}: other and this bit-equal: "
                f"{all(chip_smoke.bits_equal(x, y) for x, y in zip(*firsts))}")
        if dtype == torch.float32:
            line += ("; their largest difference dq/dk/dv / max |.| "
                     + "/".join(f"{float((x - y).abs().max() / y.abs().max()):.3g}"
                                for x, y in zip(*firsts)))
        print(line, flush=True)
        reps = 10 if name != "timed" else 3
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            f = run_other if who == "other" else this
            times[who].append(cuda_ms(f, reps))
            print(f"{label}, {who} ({other if who == 'other' else 'checkout'}"
                  f"): {times[who][-1]:.4f} ms", flush=True)
        print(f"{label}: other / this {sum(times['other']) / sum(times['this']):.3f}"
              f" (means of {reps} calls in turns)", flush=True)
        del q, k, v, do, o, lse, plain, firsts
    sass_diff(lib, build.library_path("flash_attention_bwd"))


# source edits of csrc/flash_attention_bwd.cu for `flash-bwd-variants`:
# each drops or changes one part of the bf16 wide backward's step (the
# dropped ones give wrong gradients: they only time what is left)
_HW_TOTALS = ("    float4 sv = *peer(sp, 0), dv = *peer(dp, 0);\n"
              "    for (int c = 1; c < x.ncb; ++c) {")
_HW_BARRIERS = ('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" '
                '::: "memory");',
                '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" '
                '::: "memory");',
                '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" '
                '::: "memory");')
_HW_PARTIAL = ("  if (nc == 2) wg_issue<128>(acc, a, b);\n"
               "  else if (nc == 3) wg_issue<192>(acc, a, b);\n"
               "  else wg_issue<256>(acc, a, b);\n"
               "  wg_wait<64>(acc, nullptr);")
_LOCAL = (_HW_TOTALS, "    float4 sv = *sp, dv = *dp;\n"
                      "    for (int c = 1; c < 1; ++c) {")
# items head-major (each head's kv tiles, then query tiles, together), so
# the clusters running at once walk one head's tiles, which L2 holds
_HEAD_MAJOR = [("    const int kt = id / (a.KvH * a.B), rest = id % (a.KvH * a.B);\n"
                "    hw_dkdv(a, x, sm, kt, rest % a.KvH, rest / a.KvH, cb);",
                "    const int nk = (a.Sk + HB_TILE - 1) / HB_TILE;\n"
                "    const int kt = id % nk, rest = id / nk;\n"
                "    hw_dkdv(a, x, sm, kt, rest % a.KvH, rest / a.KvH, cb);"),
               ("    const int qt = nq - 1 - j / (a.H * a.B), rest = j % (a.H * a.B);\n"
                "    hw_dq(a, x, sm, qt, rest % a.H, rest / a.H, cb);",
                "    const int qt = nq - 1 - j % nq, rest = j / nq;\n"
                "    hw_dq(a, x, sm, qt, rest % a.H, rest / a.H, cb);")]
# the arrive after the partials are read with release semantics (a fence
# a step): what the relaxed arrive saves
_RELEASE = [("  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\" ::: "
             "\"memory\");",
             "  asm volatile(\"barrier.cluster.arrive.release.aligned;\\n\" ::: "
             "\"memory\");")]
# the next step's copies issued after the publish barrier, not before
# the partial products (the barrier's release then has no copy in flight
# to order; the exchange modes only)
_COPIES_AFTER_PUBLISH = [
    ("    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);\n"
     "    cp_async_commit();\n    const unsigned char* qs = sm.stage(st, 0);\n"
     "    const unsigned char* dos = sm.stage(st, 1);\n    float acc[32];",
     "    const unsigned char* qs = sm.stage(st, 0);\n"
     "    const unsigned char* dos = sm.stage(st, 1);\n    float acc[32];"),
    ("    if (x.mode == HW_EXCHANGE) hw_publish(acc, sm.xch(), i == 0);\n",
     "    if (x.mode == HW_EXCHANGE) hw_publish(acc, sm.xch(), i == 0);\n"
     "    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);\n"
     "    cp_async_commit();\n"),
    ("    if (kt + 1 < kt_end) load_step(kt + 1, st ^ 1);\n"
     "    cp_async_commit();\n    const unsigned char* ks = sm.stage(st, 0);\n"
     "    float acc[32];",
     "    const unsigned char* ks = sm.stage(st, 0);\n    float acc[32];"),
    ("      hw_publish(acc, sm.xch(), kt == kt_begin);\n",
     "      hw_publish(acc, sm.xch(), kt == kt_begin);\n"
     "      if (kt + 1 < kt_end) load_step(kt + 1, st ^ 1);\n"
     "      cp_async_commit();\n")]
# the partials read by ld.shared::cluster at mapa.shared::cluster
# addresses, not by generic loads
_CLUSTER_LOADS = [
    ("__device__ __forceinline__ const float4* peer(const float4* p, int rank) {",
     """__device__ __forceinline__ float4 ldc(const float4* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote)
               : "memory");
  return v;
}
__device__ __forceinline__ const float4* peer(const float4* p, int rank) {"""),
    (_HW_TOTALS + """
      const float4 s1 = *peer(sp, c), d1 = *peer(dp, c);""",
     """    float4 sv = ldc(sp, 0), dv = ldc(dp, 0);
    for (int c = 1; c < x.ncb; ++c) {
      const float4 s1 = ldc(sp, c), d1 = ldc(dp, c);""")]
# the streamed tiles copied for the first two steps only (later steps
# reuse them): what the staging costs
_NO_STAGING = [("    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);\n"
                "    cp_async_commit();\n    const unsigned char* qs",
                "    if (i + 1 < n_steps && i == 0) load_step(i + 1, st ^ 1);\n"
                "    cp_async_commit();\n    const unsigned char* qs"),
               ("    if (kt + 1 < kt_end) load_step(kt + 1, st ^ 1);\n"
                "    cp_async_commit();\n    const unsigned char* ks = "
                "sm.stage(st, 0);\n    float acc[32];",
                "    if (kt + 1 < kt_end && kt == kt_begin) "
                "load_step(kt + 1, st ^ 1);\n"
                "    cp_async_commit();\n    const unsigned char* ks = "
                "sm.stage(st, 0);\n    float acc[32];")]
BWD_VARIANTS = {
    "as built": [],
    "release arrive after the reads": _RELEASE,
    "copies issued after the publish": _COPIES_AFTER_PUBLISH,
    "head-major items": _HEAD_MAJOR,
    "ld.shared::cluster loads": _CLUSTER_LOADS,
    "head-major items, ld.shared::cluster loads": [*_HEAD_MAJOR,
                                                   *_CLUSTER_LOADS],
    "own partials only (no DSMEM reads)": [_LOCAL],
    "own partials, block barriers for cluster ones": [
        _LOCAL, *[(b, "  __syncthreads();") for b in _HW_BARRIERS]],
    "no partial products (S, dP partials zero)": [
        (_HW_PARTIAL, "#pragma unroll\n"
                      "  for (int i = 0; i < 32; ++i) acc[i] = 0.f;")],
    "streamed tiles copied twice only": _NO_STAGING,
    "own partials, block barriers, tiles copied twice only": [
        _LOCAL, *[(b, "  __syncthreads();") for b in _HW_BARRIERS],
        *_NO_STAGING],
}


# the same for the float32 wide backward (flash_bwd_hf)
_HF_LOCAL = [("        const float4* src = r == me ? xch : peer(xch, r);",
              "        const float4* src = xch;"),
             ("        float4* dst = r == me ? xch : const_cast<float4*>"
              "(peer(xch, r));", "        float4* dst = xch;")]
_HF_COPIES = [("    if (i + 1 < n_steps) split(sm.stage(st ^ 1, 0), "
               "sm.stage(st ^ 1, 1));\n    if (i + 2 < n_steps) copy(i + 2);",
               "    if (i + 1 < n_steps && i == 0) split(sm.stage(st ^ 1, 0), "
               "sm.stage(st ^ 1, 1));\n"
               "    if (i + 2 < n_steps && i == 0) copy(i + 2);"),
              ("    if (i + 1 < n) split(sm.stage(st ^ 1, 0), "
               "sm.stage(st ^ 1, 1));\n    if (i + 2 < n) copy(i + 2);",
               "    if (i + 1 < n && i == 0) split(sm.stage(st ^ 1, 0), "
               "sm.stage(st ^ 1, 1));\n"
               "    if (i + 2 < n && i == 0) copy(i + 2);")]
_HF_BARRIERS = [(b, "  __syncthreads();") for b in _HW_BARRIERS]
BWD_F32_VARIANTS = {
    "as built": [],
    "own exchange only (no DSMEM reads)": _HF_LOCAL,
    "own exchange, block barriers for the cluster's": [*_HF_LOCAL,
                                                       *_HF_BARRIERS],
    "no owner sums, P or dS (the barrier kept)": [
        ("       pos < end; pos += 256) {", "       pos < 0; pos += 256) {")],
    "no partial products (S, dP partials zero)": [
        ("      hf_issue(acc, sm.fixed(wg), HF_PT, sm.stage(st, wg), HF_PT);",
         "      for (int e = 0; e < 32; ++e) acc[e] = 0.f;")],
    "no dV, dK, dQ products": [
        ("      hf_rs<4>(tmp, f, sm.stage(st, 1 - wg), 0);",
         "      for (int e = 0; e < 32; ++e) tmp[e] = 0.f;"),
        ("    hf_rs<2>(tmp, f, sm.stage(st, 0), 2 * wg);",
         "    for (int e = 0; e < 32; ++e) tmp[e] = 0.f;")],
    "tiles split and copied for the first steps only": _HF_COPIES,
    "own exchange, block barriers, first steps' copies only": [
        *_HF_LOCAL, *_HF_BARRIERS, *_HF_COPIES],
    "one bf16 part (hi.hi only: the precision control)": [
        ("constexpr int HF_PAIRS = 6;", "constexpr int HF_PAIRS = 1;")],
}


# the float32 backward at the built widths, (name, B, S, H, KvH, Dh,
# causal): zamba2's shared block (Dh 64, a block alone), olmo-1b's
# training shape (Dh 128, clusters of 2) and gemma3-4b's global layer (Dh
# 256, clusters of 4), for `flash-bwd-f32-built-variants`
BUILT_F32_SHAPES = (("zamba2 shared block", 4, 2048, 32, 32, 64, True),
                    ("olmo-1b", 2, 2048, 16, 16, 128, True),
                    ("gemma3-4b global", 1, 2048, 8, 4, 256, True))


# the float32 backward at the built widths (`flash-bwd-f32-built-variants`,
# at BUILT_F32_SHAPES): P by the SFU's ex2.approx in place of expf (a
# change of the float32 numerics: one more rounding of the argument), and
# the parts of the step the exchange does not own
BWD_F32_BUILT_VARIANTS = {
    "as built": [],
    "P by ex2.approx (the scale folded into log2 units)": [
        ("    sv[e] = ok ? expf(sv[e] * a.scale - rows[qr]) : 0.f;",
         "    sv[e] = ok ? hb_exp2((sv[e] * a.scale - rows[qr]) * LOG2E) "
         ": 0.f;")],
    "no partial products (S, dP partials zero)":
        BWD_F32_VARIANTS["no partial products (S, dP partials zero)"],
    "no dV, dK, dQ products": BWD_F32_VARIANTS["no dV, dK, dQ products"],
    "tiles split and copied for the first steps only": _HF_COPIES,
    "one bf16 part (hi.hi only: the precision control)":
        BWD_F32_VARIANTS["one bf16 part (hi.hi only: the precision control)"],
}


def probe_flash_bwd_variants(variants=None, dtype=torch.bfloat16,
                             shapes=None) -> None:
    """Builds of csrc/flash_attention_bwd.cu with one part of the wide
    backward's step dropped or changed (`BWD_VARIANTS` for bf16,
    `BWD_F32_VARIANTS` for float32), timed in turns (each in order, then
    in reverse) at `shapes` ((name, B, S, H, KvH, Dh, causal); by default
    `chip_smoke.WIDE_FLASH_TIMED`), each beside its largest gradient error
    against `flash_attention_bwd_plain`: where the step's time goes."""
    variants = BWD_VARIANTS if variants is None else variants
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"flash bwd source changed: {old!r}")
            text = text.replace(old, new)
        path = out / f"flash_bwd_variant{i}.cu"
        path.write_text(text)
        lib = out / f"flash_bwd_variant{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        print(f"ptxas {name}: " + "; ".join(
            k for k in chip_smoke.ptxas_kernels(err)
            if ("hw<" if dtype == torch.bfloat16 else "hf<") in k))
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
        fn.argtypes = fa._bwd_lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    if shapes is None:
        shapes = [("timed", *chip_smoke.WIDE_FLASH_TIMED[:6])]
    gen = torch.Generator(device=DEV).manual_seed(9)
    for label, B, S, H, KvH, Dh, causal in shapes:
        q, do = (rn(gen, (B, S, H, Dh), dtype) for _ in range(2))
        k, v = (rn(gen, (B, S, KvH, Dh), dtype) for _ in range(2))
        o, lse = fa._flash_cuda(q, k, v, lse=True, causal=causal)

        def run(fn):
            saved = fa._bwd_lib
            fa._bwd_lib = lambda: fn
            try:
                return fa._flash_bwd_cuda(q, k, v, o, do, lse, causal=causal)
            finally:
                fa._bwd_lib = saved
        plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=causal)
        for name, fn in fns.items():
            got = run(fn)
            rel = [float((a.float() - w.float()).abs().max()
                         / w.float().abs().max()) for a, w in zip(got, plain)]
            print(f"flash bwd variant {name} ({label}): dq/dk/dv max err / "
                  f"max |.| " + "/".join(f"{r:.3g}" for r in rel), flush=True)
        order = list(fns)
        for name in order + order[::-1]:
            print(f"flash bwd variant {name} ({label}: B={B} S={S} H={H} "
                  f"Dh={Dh} causal {str(dtype)[6:]}): "
                  f"{cuda_ms(lambda: run(fns[name]), 5):.4f} ms", flush=True)
        del q, k, v, do, o, lse, plain


def bind_ssd_bwd(path, name: str = "ssd_bwd_other", quiet: bool = False):
    """Build another copy of csrc/ssd_scan_bwd.cu into build/probe/ and
    return (its library path, its ptxas lines, run), run(x, dt, A, B, C,
    dy, states) -> (dx, ddt, dA, dB, dC) through the checkout's wrapper
    with that build's entry point: this design's (the strides of x, B, C
    and dy after the ints; its HEADS) or, from a source whose entry point
    takes no strides (the mma.sync design's), the ints alone on dense
    inputs."""
    lib = build.BUILD_DIR.parent / "probe" / f"{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stderr}")
    lines = chip_smoke.ptxas_kernels(proc.stderr)
    if not quiet:
        print("ptxas other: " + "; ".join(lines))
    text = Path(path).read_text()
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.ssd_scan_bwd_launch
    fn.restype = ctypes.c_int
    strided = "long long yb" in text
    fn.argtypes = ss._bwd_lib().argtypes if strided else \
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    heads = cdll.ssd_scan_bwd_heads()

    def dense_call(f, tensors, args, what):
        tensors = [t if t is None or t.is_contiguous() else t.contiguous()
                   for t in tensors]
        return build.launch(f, tensors, args[:9], what)

    def run(x, dt, A, B, C, dy, states):
        saved = ss._bwd_lib, ss.BWD_HEADS, ss._call
        ss._bwd_lib, ss.BWD_HEADS = (lambda: fn), heads
        if not strided:
            ss._call = dense_call
        try:
            return ss._ssd_bwd_cuda(x, dt, A, B, C, dy, states)
        finally:
            ss._bwd_lib, ss.BWD_HEADS, ss._call = saved
    return lib, lines, run


# the backward's timed shapes (label, b, s, h, g, n): zamba2-1.2b's and
# mamba2-2.7b's prefill, phase 24's zamba2 train step
SSD_BWD_TIMED = (("zamba2", 2, 4096, 64, 1, 64),
                 ("mamba2-2.7b", 2, 4096, 80, 1, 128),
                 ("zamba2 train", 4, 2048, 64, 1, 64))


def probe_ssd_bwd_compare(other: str) -> None:
    """The SSD backward built from another copy of csrc/ssd_scan_bwd.cu
    (`other`: the parent commit's, or an edited copy of this one) against
    this checkout's, at zamba2's and mamba2-2.7b's prefill shapes and phase
    24's step shape, bf16 and float32, on the forward kernel's own group
    states: each build's largest gradient error against
    `ssd_scan_bwd_plain` (over each gradient's largest magnitude; bf16
    also the relative RMS), whether a repeat is bit-equal, whether the two
    builds' outputs are bit-equal (float32: they must be), and times in
    turns (other, this, this, other); then each kernel's SASS diffed (the
    float32 instances and the pass: equal)."""
    build.build_all(("ssd_scan", "ssd_scan_bwd"))
    print("ptxas this: " + "; ".join(chip_smoke.ptxas_kernels(
        build.BUILD_LOG.get("ssd_scan_bwd", ""))))
    other_lib, _, run_other = bind_ssd_bwd(other)
    names = ("dx", "ddt", "dA", "dB", "dC")
    gen = torch.Generator(device=DEV).manual_seed(13)
    for label, b, s, h, g, n in SSD_BWD_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            ins = ssd_inputs(gen, b, s, h, g, n, dtype, 1.0)
            dy = rn(gen, (b, s, h, 64), dtype)
            _, st = ss._ssd_cuda(*ins, states=True)
            fns = {"other": lambda: run_other(*ins, dy, st),
                   "this": lambda: ss._ssd_bwd_cuda(*ins, dy, st)}
            plain = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
            tag = (f"ssd bwd {label} {str(dtype)[6:]} b={b} s={s} h={h} "
                   f"g={g} n={n}")
            firsts = []
            for who, f in fns.items():
                a, c = f(), f()
                firsts.append(a)
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
            print(f"{tag}: other and this bit-equal: "
                  f"{all(torch.equal(x, y) for x, y in zip(*firsts))}")
            for who in ("other", "this", "this", "other"):
                where = other if who == "other" else "checkout"
                print(f"{tag}, {who} ({where}): "
                      f"{cuda_ms(fns[who], 10):.4f} ms", flush=True)
            del ins, dy, st, plain
    sass_diff(other_lib, build.library_path("ssd_scan_bwd"))


# builds of csrc/ssd_scan_bwd.cu with one switch of the bf16 backward's
# design flipped (levers a-e of its design), then two diagnostics that
# break the result to weigh a part: (name, [(old, new) text edits])
SSD_BWD_VARIANTS = {
    "as built": [],
    "a: dt_j by a multiply in G o E (not folded into ex2's exponent)": [
        ("constexpr bool SB_FOLD = true;", "constexpr bool SB_FOLD = false;")],
    "b: two stages at n 64": [
        ("__host__ __device__ constexpr int sb_stages(int n) { return n == 64 ? 1 : 2; }",
         "__host__ __device__ constexpr int sb_stages(int n) { return 2; }")],
    "b: one stage at n 128": [
        ("__host__ __device__ constexpr int sb_stages(int n) { return n == 64 ? 1 : 2; }",
         "__host__ __device__ constexpr int sb_stages(int n) { return 1; }")],
    "b: the slabs' loads with branches at n 64": [
        ("__host__ __device__ constexpr bool sb_branchless(int n) { return n == 64; }",
         "__host__ __device__ constexpr bool sb_branchless(int n) { return false; }")],
    "b: no L2 prefetch of the float32 slabs": [
        ("constexpr bool SB_PREFETCH = true;",
         "constexpr bool SB_PREFETCH = false;")],
    "c: the walks write every chunk's slabs": [
        ("constexpr bool SB_SKIP_SLABS = true;",
         "constexpr bool SB_SKIP_SLABS = false;")],
    "d: four heads a chunk block (twice the dB / dC rows)": [
        ("constexpr int HEADS = 8;", "constexpr int HEADS = 4;")],
    "e: one chunk block an SM at n 64": [
        ("constexpr int SB_BLOCKS_N64 = 2;", "constexpr int SB_BLOCKS_N64 = 1;")],
    # where the time goes (wrong outputs: they only time what is left)
    "no exps (every decay 1)": [
        ("float hb_exp2(float x) {\n", "float hb_exp2(float x) {\n  return 1.f;\n")],
    "no products (no wgmma issued)": [
        ("uint64_t db, int accumulate) {\n  asm volatile(",
         "uint64_t db, int accumulate) {\n  return;\n  asm volatile(")],
}


def ssd_bwd_variant_sources(variants=None) -> dict:
    """{variant name: its source text}, each edit checked to apply."""
    variants = SSD_BWD_VARIANTS if variants is None else variants
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    out = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ssd backward source changed: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def probe_ssd_bwd_variants(variants=None, shapes=None) -> None:
    """Builds of csrc/ssd_scan_bwd.cu with one switch of the bf16
    backward's design flipped (`SSD_BWD_VARIANTS`), each beside its ptxas
    lines and its relative RMS against `ssd_scan_bwd_plain` (the largest
    over the five gradients), timed in two turns (each in order, then in
    reverse) at zamba2's and mamba2-2.7b's prefill shapes, with the mean
    of its two times: what each lever buys, and where the time goes."""
    shapes = SSD_BWD_TIMED[:2] if shapes is None else shapes
    out = build.BUILD_DIR.parent / "probe"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, text) in enumerate(
            ssd_bwd_variant_sources(variants).items()):
        paths[name] = out / f"ssd_bwd_variant{i}.cu"
        paths[name].write_text(text)
    from concurrent.futures import ThreadPoolExecutor
    build.build_all(("ssd_scan", "ssd_scan_bwd"))
    ss._bwd_lib()                       # this build once, before the pool
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        bound = dict(zip(paths, pool.map(
            lambda path: bind_ssd_bwd(path, path.stem, quiet=True),
            paths.values())))
    runs = {}
    for name, (_, lines, run) in bound.items():
        print(f"ptxas {name}: " + "; ".join(
            k for k in lines if "_hb<" in k or "warning" in k), flush=True)
        runs[name] = run
    gen = torch.Generator(device=DEV).manual_seed(9)
    for label, b, s, h, g, n in shapes:
        ins = ssd_inputs(gen, b, s, h, g, n, torch.bfloat16, 1.0)
        dy = rn(gen, (b, s, h, 64), torch.bfloat16)
        _, st = ss._ssd_cuda(*ins, states=True)
        want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
        for name, run in runs.items():
            got = run(*ins, dy, st)
            again = run(*ins, dy, st)
            print(f"ssd bwd variant {name} ({label}): rel RMS vs plain "
                  f"{max(rel_rms(a, w) for a, w in zip(got, want)):.3g}, "
                  f"repeat bit-equal "
                  f"{all(torch.equal(a, c) for a, c in zip(got, again))}",
                  flush=True)
        order, times = list(runs), {}
        for name in order + order[::-1]:
            ms = cuda_ms(lambda: runs[name](*ins, dy, st), 10)
            times.setdefault(name, []).append(ms)
            print(f"ssd bwd variant {name} ({label}: b={b} s={s} h={h} g={g} "
                  f"n={n} bf16): {ms:.4f} ms", flush=True)
        base = sum(times["as built"]) / 2
        for name, ts in times.items():
            mean = sum(ts) / 2
            print(f"ssd bwd variant {name} ({label}): mean of two turns "
                  f"{mean:.4f} ms, {mean / base:.3f}x as built", flush=True)
        del ins, dy, st, want


def probe_wide() -> None:
    """chip_smoke.py's phase 33 alone: the flash and SSD sources built at
    once, the wide kernels' ptxas lines (registers and spills, the bf16
    backward's `flash_bwd_hw` among them), then the wide widths against
    their plain versions, the derived smoke configs and the timed
    shapes; the misses listed at the end."""
    build.build_all(("flash_attention", "flash_attention_bwd", "ssd_scan",
                     "ssd_scan_bwd"))
    for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd"):
        lines = [k for k in chip_smoke.ptxas_kernels(build.BUILD_LOG.get(
            name, "")) if "f32>" in k or "_hw<" in k or "_hf<" in k]
        print(f"ptxas {name}: " + "; ".join(lines))
    chip_smoke.phase33(DEV)
    print(f"misses: {len(chip_smoke.MISSES)}")
    for m in chip_smoke.MISSES:
        print(f"  {m}")


def main() -> None:
    probes = {"day": probe_day, "flash": probe_flash, "ssd": probe_ssd,
              "flash-bwd": probe_flash_bwd, "ssd-bwd": probe_ssd_bwd,
              "flash-bwd-variants": probe_flash_bwd_variants,
              "flash-wide-variants": probe_flash_wide_variants,
              "flash-bf16-variants": lambda: probe_flash_wide_variants(
                  BF16_VARIANTS, torch.bfloat16, BUILT_BF16_SHAPES,
                  "fwd_hb<"),
              "flash-wide-f32-variants": lambda: probe_flash_wide_variants(
                  FWD_F32_VARIANTS, torch.float32),
              "flash-bwd-f32-variants": lambda: probe_flash_bwd_variants(
                  BWD_F32_VARIANTS, torch.float32),
              "flash-bwd-f32-built-variants": lambda: probe_flash_bwd_variants(
                  BWD_F32_BUILT_VARIANTS, torch.float32, BUILT_F32_SHAPES),
              "ssd-variants": probe_ssd_variants,
              "ssd-bwd-variants": probe_ssd_bwd_variants,
              "row-stage": probe_row_stage, "wide": probe_wide}
    compare = {"flash-compare": probe_flash_compare,
               "flash-bwd-compare": probe_flash_bwd_compare,
               "ssd-compare": probe_ssd_compare,
               "ssd-bwd-compare": probe_ssd_bwd_compare,
               "day-compare": probe_day_compare}
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
