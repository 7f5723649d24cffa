"""The CUDA kernels (day scan in both output modes, with the full trace's
initial SoC, flash attention at Dh 64 / 96 / 128 / 256 and a transformer
prefill through it, SSD scan) against their plain PyTorch
versions on the card, the day scan's paths: serial, batched (K queries
folded into the combo axis), the legacy engine, `simulate_users`,
`simulate`, `optimize_policy` and the fleet day, the joint device +
backend front, and the gradient path (the relaxed engine and the
differentiable day) on the card against the CPU.

Needs an NVIDIA card with nvcc (the kernels have no CPU mode) and skips
without one; it imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import daysim, design, dse, fleet, scenarios
from repro_torch.kernels import day_scan as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.serving.twin import DesignTwin
from torch_day_reports import assert_identical, assert_reports_match
from torch_day_tables import random_tables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,t,n_lvl", [(1, 50, 1), (37, 300, 3),
                                       (70, 200, 6), (33, 120, 12)])
def test_kernel_matches_plain(cuda, n, t, n_lvl):
    tables = random_tables(n, t, n_lvl, seed=n, device=cuda)
    before = ds.LAUNCHES
    got = ds.day_scan(tables)
    assert ds.LAUNCHES == before + 1
    want = ds.day_scan_plain(tables)
    torch.cuda.synchronize()
    for k in ("level", "shut"):
        assert torch.equal(got[k], want[k]), k
    for k in ("soc", "soc_p", "t_skin", "t_skin_p", "pods", "drain_mw",
              "drain_p_mw"):
        np.testing.assert_allclose(got[k].cpu().numpy(),
                                   want[k].cpu().numpy(), rtol=1e-6,
                                   atol=1e-4, err_msg=k)
    assert int(want["level"].max()) >= min(1, n_lvl - 1)
    if n > 1:
        assert float(want["shut"].max()) == 1.0
    _assert_all_equal(got, want)


def _assert_all_equal(got: dict, want: dict) -> None:
    """Bit for bit on all nine outputs: the kernel keeps the plain
    version's every operation and its order."""
    for k in ds.OUTS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n,t,n_lvl", [
    (64, 1, 3),         # one step
    (31, 129, 16),      # ragged N, smallest chunks, 16 levels
    (200, 1000, 3),     # ragged N over 7 blocks, many ring turns
    (1024, 257, 3),     # 32 blocks: 16 serving grids folded into N
])
def test_kernel_edges_match_plain(cuda, n, t, n_lvl):
    tables = random_tables(n, t, n_lvl, seed=n + t, device=cuda)
    before = ds.LAUNCHES
    got = ds.day_scan(tables)
    assert ds.LAUNCHES == before + 1
    want = ds.day_scan_plain(tables)
    torch.cuda.synchronize()
    _assert_all_equal(got, want)


@pytest.mark.parametrize("n_lvl", [1, 3, 16])
@pytest.mark.parametrize("steps", ["1", "tc-1", "tc", "tc+1", "9tc+1"])
def test_kernel_time_edges(cuda, n_lvl, steps):
    """T around the kernel's chunk (`chunk_steps`): under one chunk, one
    whole chunk, just past it, and past two turns of the rings."""
    tc = ds.chunk_steps(n_lvl)
    assert tc >= 1
    t = {"1": 1, "tc-1": max(tc - 1, 1), "tc": tc, "tc+1": tc + 1,
         "9tc+1": 9 * tc + 1}[steps]
    tables = random_tables(37, t, n_lvl, seed=t, device=cuda)
    got = ds.day_scan(tables)
    want = ds.day_scan_plain(tables)
    torch.cuda.synchronize()
    _assert_all_equal(got, want)


def _assert_full_equal(got: dict, want: dict) -> None:
    """Bit for bit on all 17 outputs of the full-trace mode."""
    assert tuple(got) == ds.TRACE_OUTS
    for k in ds.TRACE_OUTS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n,t,n_lvl", [
    (64, 700, 3), (63, 700, 3),     # the serving grid's width, ragged
    (1, 700, 3),                    # simulate's: 31 of 32 lanes masked
    (33, 129, 16),                  # 16 levels, the smallest chunks
])
def test_full_mode_matches_plain(cuda, n, t, n_lvl):
    """The full-trace mode against its plain version on all 17 outputs,
    and its first nine against the default mode's, which stays equal to
    its own plain version."""
    tables = random_tables(n, t, n_lvl, seed=n + 7, device=cuda)
    before = (ds.LAUNCHES, ds.FULL_LAUNCHES)
    got = ds.day_scan(tables, full=True)
    short = ds.day_scan(tables)
    assert (ds.LAUNCHES, ds.FULL_LAUNCHES) == (before[0] + 2, before[1] + 1)
    want = ds.day_scan_plain(tables, full=True)
    torch.cuda.synchronize()
    _assert_full_equal(got, want)
    _assert_all_equal(short, ds.day_scan_plain(tables))
    for k in ds.OUTS:
        assert torch.equal(got[k], short[k]), k
    assert float(want["soc_state"].max()) == 1.0
    if n > 1:
        assert float(want["th_state"].max()) == 1.0


@pytest.mark.parametrize("n_lvl", [1, 3, 16])
@pytest.mark.parametrize("steps", ["tc-1", "tc", "tc+1", "9tc+1"])
def test_full_mode_time_edges(cuda, n_lvl, steps):
    """T around the full-trace mode's own (smaller) chunk."""
    tc = ds.chunk_steps(n_lvl, full=True)
    assert 1 <= tc <= ds.chunk_steps(n_lvl)
    t = {"tc-1": max(tc - 1, 1), "tc": tc, "tc+1": tc + 1,
         "9tc+1": 9 * tc + 1}[steps]
    tables = random_tables(37, t, n_lvl, seed=t + 1, device=cuda)
    got = ds.day_scan(tables, full=True)
    want = ds.day_scan_plain(tables, full=True)
    torch.cuda.synchronize()
    _assert_full_equal(got, want)


def test_kernel_rejects_too_many_levels(cuda):
    tables = random_tables(4, 10, ds.MAX_LEVELS + 1, seed=0, device=cuda)
    with pytest.raises(ValueError, match="throttle levels"):
        ds.day_scan(tables)


# tolerances of tests/test_kernels.py; bf16 flash is held tighter: one
# bf16 spacing of the value (rtol 2^-7) over an atol of 8e-3, twice the
# error read on an H100 at the zamba2-1.2b prefill shape
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (8e-3, 2.0 ** -7)}
# relative RMS error of the bf16 kernel against the plain version on its
# own tiles (flash_attention.TILES); the plain version with p left
# unrounded exceeds it
FLASH_ROUNDING_LIMIT = 5e-4
# relative RMS error of the bf16 SSD kernel against the plain version
# (2e-5 to 7e-5 on an H100); the plain version with x dt and W rounded to
# bf16 before their product (~3e-3) exceeds it
SSD_BF16_LIMIT = 5e-4


def _randn(seed, shape, dtype, device, scale=1.0):
    g = np.random.default_rng(seed)
    a = (scale * g.standard_normal(shape)).astype(np.float32)
    return torch.as_tensor(a, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KvH,Dh,causal,window", [
    (2, 512, 4, 4, 64, True, None),
    (1, 300, 8, 2, 128, True, 96),      # GQA 4:1 + window, ragged S
    (2, 200, 4, 1, 64, False, None),    # bidirectional, ragged S
    (1, 37, 2, 2, 64, True, None),      # S below one tile
    (1, 300, 4, 4, 64, True, 5),        # window smaller than a tile
    (1, 130, 4, 2, 128, False, None),   # bidirectional, Dh 128
    (2, 257, 8, 8, 128, True, None),    # Dh 128, ragged S
    (1, 1100, 8, 4, 256, True, None),   # gemma3 global: GQA 2:1, Dh 256
    (1, 1100, 8, 4, 256, True, 1024),   # gemma3 local: window 1024
    (2, 300, 4, 2, 256, True, 5),       # Dh 256, window below a tile
    (1, 1000, 32, 32, 96, True, None),  # phi-3-vision: Dh 96
    (2, 257, 8, 2, 96, True, 96),       # Dh 96, GQA 4:1 + window, ragged
    (1, 130, 4, 4, 96, False, None),    # Dh 96 bidirectional
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, KvH, Dh, causal,
                                    window):
    q = _randn(0, (B, S, H, Dh), dtype, cuda)
    k = _randn(1, (B, S, KvH, Dh), dtype, cuda)
    v = _randn(2, (B, S, KvH, Dh), dtype, cuda)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    atol, rtol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=atol, rtol=rtol)


def _rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def test_flash_bf16_rounds_p_like_the_reference(cuda):
    """The bf16 kernel rounds p to v's dtype before the PV product: on the
    kernel's own tiles (same running max, same p) it is closer to the
    plain version than that version with p left unrounded is."""
    from repro_torch.nn import attention as attn
    q, k, v = (_randn(i, (2, 1024, 4, 64), torch.bfloat16, cuda)
               for i in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    bq, bk = fa.TILES[torch.bfloat16]
    tiles = {"causal": True, "chunk_q": bq, "chunk_k": bk}
    want = attn.chunked_attention(q, k, v, **tiles)
    control = attn.chunked_attention(q, k, v.float(), **tiles)
    assert _rel_rms(got, want) <= FLASH_ROUNDING_LIMIT < \
        _rel_rms(control, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,causal,window", [
    (1, 130, 70, False, None),          # Sq, Sk off both tiles, Sq > Sk
    (1, 70, 130, True, None),           # causal, Sq < Sk
    (2, 200, 333, True, 40),            # window, Sq < Sk
])
def test_flash_kernel_ragged_sq_sk(cuda, dtype, B, Sq, Sk, causal, window):
    """Query and key lengths that differ, neither a multiple of a tile."""
    q = _randn(0, (B, Sq, 4, 64), dtype, cuda)
    k = _randn(1, (B, Sk, 2, 64), dtype, cuda)
    v = _randn(2, (B, Sk, 2, 64), dtype, cuda)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [96, 256])
@pytest.mark.parametrize("B,Sq,Sk,causal,window", [
    (1, 130, 70, False, None),          # Sq, Sk off both tiles, Sq > Sk
    (2, 200, 333, True, 40),            # window, Sq < Sk
])
def test_flash_kernel_wide_heads_ragged(cuda, dtype, Dh, B, Sq, Sk, causal,
                                        window):
    """Dh 96 and 256 (every output column written: a dropped column would
    stay at torch.empty's garbage) with GQA and lengths off the tiles."""
    q = _randn(0, (B, Sq, 8, Dh), dtype, cuda)
    k = _randn(1, (B, Sk, 4, Dh), dtype, cuda)
    v = _randn(2, (B, Sk, 4, Dh), dtype, cuda)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=atol, rtol=rtol)


def test_transformer_prefill_on_the_card_matches_cpu(cuda):
    """gemma3's smoke config (local and global layers, Dh 16 widened to
    96 and 256 so the kernel takes them) in float32: the prefill step's
    last hidden and cache on the card against the same call on the CPU,
    one flash launch a layer."""
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import registry
    base, model = registry.get("gemma3-4b", smoke=True)
    for dh in (96, 256):
        cfg = dataclasses.replace(base, head_dim=dh)
        tree = convert.lm_params_numpy(cfg, 0)
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 40)))
        outs = {}
        for dev in ("cpu", cuda):
            params = convert.lm_params_from_numpy(tree, cfg, dev)
            before = fa.LAUNCHES
            outs[str(dev)] = steps.make_prefill_step(cfg, model)(
                params, {"tokens": toks.to(dev)})
            launched = fa.LAUNCHES - before
        assert launched == cfg.n_layers
        h_cpu, c_cpu = outs["cpu"]
        h, c = outs[str(cuda)]
        torch.testing.assert_close(h.cpu(), h_cpu, atol=1e-4, rtol=1e-4)
        for key in c_cpu:
            torch.testing.assert_close(c[key].cpu(), c_cpu[key], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g,n", [(2, 256, 4, 1, 64),
                                       (1, 200, 4, 2, 128),   # ragged s
                                       (1, 64, 2, 1, 64)])
def test_ssd_kernel_matches_plain(cuda, dtype, b, s, h, g, n):
    x = _randn(0, (b, s, h, 64), dtype, cuda, 0.5)
    dt = torch.nn.functional.softplus(_randn(1, (b, s, h), torch.float32,
                                             cuda))
    A = -torch.exp(_randn(2, (h,), torch.float32, cuda, 0.3))
    B = _randn(3, (b, s, g, n), dtype, cuda, 0.3)
    C = _randn(4, (b, s, g, n), dtype, cuda, 0.3)
    before = ss.LAUNCHES
    got = ss.ssd_scan(x, dt, A, B, C, chunk=64)
    assert ss.LAUNCHES == before + ss.kernel_launches(s)
    want = ss.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=max(tol, 1e-4), rtol=5 * tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g,n", [
    (1, 40, 1, 1, 64),      # s < one chunk, b = h = 1
    (1, 512, 2, 1, 64),     # s = one group: the scan launch alone
    (2, 600, 4, 1, 64),     # s not a multiple of the group (or the chunk)
    (1, 1000, 4, 2, 128),   # g = 2 with n = 128, two groups
    (1, 2048, 2, 1, 64),    # four whole groups
])
def test_ssd_kernel_split_edges(cuda, dtype, b, s, h, g, n):
    """The edges of the split: dt x 0.05 (slow decay), so the state carried
    between groups moves y.  y within tests/test_kernels.py's tolerance;
    in bf16 also a relative RMS error under SSD_BF16_LIMIT, which the
    bf16-product shortcut exceeds; the float32 group states within the
    float32 tolerance."""
    x = _randn(0, (b, s, h, 64), dtype, cuda, 0.5)
    dt = 0.05 * torch.nn.functional.softplus(
        _randn(1, (b, s, h), torch.float32, cuda))
    A = -torch.exp(_randn(2, (h,), torch.float32, cuda, 0.3))
    B = _randn(3, (b, s, g, n), dtype, cuda, 0.3)
    C = _randn(4, (b, s, g, n), dtype, cuda, 0.3)
    before = ss.LAUNCHES
    got = ss.ssd_scan(x, dt, A, B, C, chunk=64)
    assert ss.LAUNCHES == before + ss.kernel_launches(s)
    want = ss.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=max(tol, 1e-4), rtol=5 * tol)
    if dtype == torch.bfloat16:
        control = ss.ssd_scan_rounded_plain(x, dt, A, B, C, chunk=64)
        assert _rel_rms(got, want) <= SSD_BF16_LIMIT < _rel_rms(control,
                                                                want)
    if ss.n_groups(s) > 1:
        states = ss.ssd_group_states_cuda(x, dt, A, B, C)
        want_states = ss.ssd_split_states_plain(x, dt, A, B, C, chunk=64)
        torch.cuda.synchronize()
        np.testing.assert_allclose(states.cpu().numpy(),
                                   want_states.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [128, 32])
def test_ssd_kernels_run_their_tile_at_any_chunk(cuda, dtype, chunk):
    """A scan asked for at another chunk (mamba2-2.7b tuned: 128) runs the
    kernels' own 64-row tile: the launches and y of a chunk-64 call, bit
    for bit; y and the gradients against the plain versions at the chunk
    asked for, at the tolerances above."""
    b, s, h, g, n = 1, 1000, 4, 1, 128
    ins = [_randn(0, (b, s, h, 64), dtype, cuda, 0.5),
           0.05 * torch.nn.functional.softplus(
               _randn(1, (b, s, h), torch.float32, cuda)),
           -torch.exp(_randn(2, (h,), torch.float32, cuda, 0.3)),
           _randn(3, (b, s, g, n), dtype, cuda, 0.3),
           _randn(4, (b, s, g, n), dtype, cuda, 0.3)]
    dy = _randn(5, (b, s, h, 64), dtype, cuda)
    before = ss.LAUNCHES
    got = ss.ssd_scan(*ins, chunk=chunk)
    assert ss.LAUNCHES == before + ss.kernel_launches(s) == before + 3
    assert torch.equal(got, ss.ssd_scan(*ins, chunk=64))
    want = ss.ssd_scan_plain(*ins, chunk=chunk)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=max(tol, 1e-4), rtol=5 * tol)
    leaves = [t.clone().requires_grad_() for t in ins]
    b0 = ss.BWD_LAUNCHES
    grads = torch.autograd.grad(ss.ssd_scan(*leaves, chunk=chunk), leaves,
                                dy)
    assert ss.BWD_LAUNCHES == b0 + 1
    for a, w in zip(grads, ss.ssd_scan_bwd_plain(*ins, dy, chunk=chunk)):
        a, w = a.float(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            assert _rel_rms(a, w) <= 5e-4


def test_kernels_reject_unsupported_shapes(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="Dh in"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(1, 8, 2, 32, device=cuda)
    dt = torch.zeros(1, 8, 2, device=cuda)
    A = torch.zeros(2, device=cuda)
    B = torch.zeros(1, 8, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="p in"):
        ss.ssd_scan(x, dt, A, B, B)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_row_stage_rows_keep_their_bits_at_any_position(cuda, shift):
    """A scenario row's table values depend neither on where it sits in
    a row-stage pass nor on the pass's size: the legacy engine evaluates
    deduplicated rows, the batched path stacks queries' rows.

    `scenarios._row_sums` rests on how PyTorch's CUDA sum reads a row
    (from its first 16-byte-aligned address); verified with torch
    2.11.0+cu128 on an H100 80GB HBM3.  A torch whose reduce reads rows
    otherwise fails here (and in chip_smoke.py's legacy-vs-fused
    phase)."""
    pipe = daysim._fused_pipeline(cuda, dt_s=600.0)
    for p, plat in enumerate(pipe.asm.plats):
        g = pipe.dyn["groups"][p]
        args = (g["theta"], pipe.dyn["rates"], pipe.dyn["gate"],
                g["p_base"], g["p_wan"])
        stage = daysim._row_stage(plat)
        full = stage(g["vec"], *args)
        for hi in (None, shift + 5, shift + 1):
            part = stage({k: v[shift:hi].contiguous()
                          for k, v in g["vec"].items()}, *args)
            for x, y in zip(full, part):
                assert torch.equal(x[shift:hi], y), (plat.name, hi)


def _governor_grids(k: int, start: int = 0) -> list:
    """k default-grid queries, each with the thermal governor's
    temp_trip_c moved (value-level what-ifs of one signature)."""
    gov = daysim.get_policy("thermal_governor")
    return [{"policies": ("none", dataclasses.replace(
                gov, name=f"v{start + i}",
                temp_trip_c=38.0 + 0.1 * (start + i)), "battery_saver")}
            for i in range(k)]


@pytest.mark.parametrize("k", [1, 5, 16])
def test_batched_twin_bit_identical_to_serial(cuda, k):
    """K default-grid what-ifs in one batch: one kernel launch at N =
    K x 64, each answer bit-identical to its serial query
    on the card."""
    twin = DesignTwin(dt_s=60.0, warm=False)
    queries = _governor_grids(k)
    serial = [twin.query(**q) for q in queries]
    before = ds.LAUNCHES
    batch = twin.query_batch(queries)
    assert ds.LAUNCHES == before + 1
    assert twin.stats.batches == 1
    for s, b in zip(serial, batch):
        assert_identical(s, b)


def test_batch_one_launch_per_signature_group(cuda):
    twin = DesignTwin(dt_s=60.0, warm=False)
    gov = daysim.get_policy("thermal_governor")
    points = [{"platform": "aria2_display", "design": daysim.DEFAULT_DESIGNS[1],
               "schedule": "commuter",
               "policy": dataclasses.replace(gov, name=f"t{i}",
                                             temp_trip_c=38.0 + 0.05 * i)}
              for i in range(3)]
    items = [points[0], *_governor_grids(2, 50), points[1], points[2]]
    serial = [twin.what_if(**w) for w in items]
    before = ds.LAUNCHES
    batch = twin.what_if_many(items)
    assert ds.LAUNCHES == before + 2
    assert twin.stats.batches == 2
    for s, b in zip(serial, batch):
        assert_identical(s, b)


def test_legacy_matches_fused_on_the_card(cuda):
    """The legacy engine (host tables, one launch, float64 summary)
    against the fused one: discrete outputs identical, extrema equal."""
    fused = dse.day_pareto(dt_s=60.0)
    before = ds.LAUNCHES
    legacy = dse.day_pareto(dt_s=60.0, engine="legacy")
    assert ds.LAUNCHES == before + 1
    assert legacy.combos == fused.combos
    for k in ("front_mask", "shutdown"):
        np.testing.assert_array_equal(getattr(legacy, k), getattr(fused, k))
    np.testing.assert_array_equal(legacy.survives(), fused.survives())
    for k in ("end_soc", "peak_skin_c", "steady_mw", "day_hours"):
        np.testing.assert_array_equal(getattr(legacy, k), getattr(fused, k),
                                      err_msg=k)
    for k in ("time_to_empty_h", "pod_hours", "energy_mwh", "throttled_h"):
        np.testing.assert_allclose(getattr(legacy, k), getattr(fused, k),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_simulate_users_on_the_card(cuda, monkeypatch):
    """`simulate_users` (64 users: battery fades x ambient offsets) on
    the card: one launch at N = 64, the kernel bit for bit equal to its
    plain version on the call's own tables, and the report equal to the
    same call on the CPU on discrete outputs, continuous ones within the
    reference's tolerances."""
    calls, scan = [], ds.day_scan

    def recording(tables):
        ys = scan(tables)
        calls.append((tables, ys))
        return ys

    monkeypatch.setattr(ds, "day_scan", recording)
    args = ("aria2_display", daysim.DEFAULT_DESIGNS[2], "field_day",
            "thermal_governor")
    kw = dict(fades=np.repeat(np.linspace(0.0, 0.35, 8), 8),
              ambient_offsets_c=np.tile(np.linspace(-6.0, 8.0, 8), 8),
              dt_s=120.0)
    before = ds.LAUNCHES
    got = daysim.simulate_users(*args, **kw)
    assert ds.LAUNCHES == before + 1
    assert [t["step_mw"].shape[-1] for t, _ in calls] == [64]
    _assert_all_equal(calls[0][1], ds.day_scan_plain(calls[0][0]))
    want = daysim.simulate_users(*args, **kw, device="cpu")
    for rep in (got, want):
        rep.front_mask = dse.non_dominated(rep.objectives(), maximize=(0,))
    assert_reports_match(got, want)
    assert 0 < int(got.shutdown.sum()) < 64


@pytest.mark.parametrize("args", [
    ("rayban_cam", 0, "desk_day", "battery_saver"),
    ("aria2_puck_split", 1, "field_day", "thermal_governor"),
])
def test_simulate_on_the_card(cuda, args):
    """`simulate` on the card: one full-trace launch at N = 1; discrete
    traces equal to the same call on the CPU, the others within the
    reference's tolerance, the summary at rtol 1e-6."""
    plat, design, schedule, policy = args
    call = (plat, daysim.DEFAULT_DESIGNS[design], schedule, policy)
    before = (ds.LAUNCHES, ds.FULL_LAUNCHES)
    got = daysim.simulate(*call, dt_s=60.0)
    assert (ds.LAUNCHES, ds.FULL_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = daysim.simulate(*call, dt_s=60.0, device="cpu")
    for k in ("level", "shut", "th_state", "soc_state", "valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    for k in ("soc", "soc_puck", "t_soc_c", "t_skin_c", "t_skin_puck_c",
              "p_mw", "p_puck_mw", "drain_mw", "drain_puck_mw", "pods"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    assert list(got.summary) == list(want.summary)
    for k, v in want.summary.items():
        assert got.summary[k] == pytest.approx(v, rel=1e-6), k


def test_joint_pareto_on_the_card(cuda):
    """The 2304-point joint front on the card against the CPU: the same
    front, objectives at rtol 1e-6, the same co_optimize rows."""
    got = dse.joint_pareto()
    want = dse.joint_pareto(device="cpu")
    np.testing.assert_array_equal(got.front_mask, want.front_mask)
    np.testing.assert_allclose(got.objectives(), want.objectives(),
                               rtol=1e-6)
    for budgets in ({}, {"pod_budget": 40.0}, {"power_budget_mw": 1100.0},
                    {"usd_budget_per_day": 3.0e5}):
        assert dse.co_optimize(got, **budgets) == \
            dse.co_optimize(want, **budgets), budgets


# ---------------------------------------------------------------------------
# the gradient co-design path on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["aria2", "aria2_display",
                                      "rayban_cam"])
def test_relaxed_engine_equals_hard_engine_on_the_card(cuda, platform):
    """Binary placements and one-hot MCS weights through the relaxed
    engine give `evaluate`'s bits on the card too."""
    plat = dse._plat(platform)
    sset = scenarios.ScenarioSet.grid(
        placements=scenarios.all_placements(plat.supported_primitives()),
        compressions=(2.0, 16.0), fps_scales=(1.0, 4.0),
        mcs_tiers=(0, 1, 2), upload_duties=(0.4,), brightnesses=(0.5,),
        primitives=plat.primitives)
    rep = scenarios.evaluate(plat, sset)
    out = scenarios.evaluate_relaxed(plat, scenarios.relax_vec(sset))
    assert torch.equal(rep.total_mw, out["total"])
    assert torch.equal(rep.loads_mw, out["loads"])
    assert torch.equal(rep.offloaded_mbps, out["mbps"])


def test_relaxed_day_and_gradient_on_the_card(cuda):
    """The relaxed day and d soft_tte_h / d policy point on the card
    against the CPU (discrete outputs equal, traces at rtol 1e-6 / atol
    1e-4, soft_tte_h at rtol 1e-5, gradients at rtol 1e-5 with equal
    signs: 2.5e-7 read on an H100); at an exactly binary placement the
    traces within the trace tolerance of `simulate`'s on the card (the
    relaxed rows compose brightness x its throttle multiplier in
    float32, as the reference does, so a level table may sit one ulp
    off the hard one), and the eager integrator on `simulate`'s own
    tables equal to the kernel on all 17 outputs."""
    args = ("aria2_display", "field_day", "battery_saver",
            daysim.DEFAULT_DESIGNS[0])
    res = {}
    for dev in ("cuda", "cpu"):
        f = daysim.relaxed_day_fn(*args, dt_s=120.0, device=dev)
        pt = {k: v.requires_grad_() for k, v in design.policy_point(
            daysim.get_policy("battery_saver"), dev).items()}
        out = f(pt)
        g = torch.autograd.grad(out["soft_tte_h"], list(pt.values()))
        res[dev] = ({k: v.detach().cpu().numpy() for k, v in out.items()},
                    np.asarray([float(x) for x in g]))
        if dev == "cuda":
            binary = f({**{k: v.detach() for k, v in pt.items()},
                        "placement_logits": torch.full((4,), -200.0,
                                                       device=dev)})
    (got, g_got), (want, g_want) = res["cuda"], res["cpu"]
    for k in ("tte_h", "throttled_frac"):
        assert got[k] == want[k], k
    assert float(got["soft_tte_h"]) == pytest.approx(
        float(want["soft_tte_h"]), rel=1e-5)
    for k in ("t_skin", "soc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-6)
    live = np.abs(g_want) > 1e-6
    np.testing.assert_array_equal(np.sign(g_got[live]),
                                  np.sign(g_want[live]))
    calls, scan = [], ds.day_scan

    def recording(tables, full=False):
        ys = scan(tables, full)
        calls.append((tables, ys))
        return ys

    ds.day_scan = recording
    try:
        tr = daysim.simulate(args[0], args[3], args[1], args[2],
                             dt_s=120.0)
    finally:
        ds.day_scan = scan
    np.testing.assert_allclose(binary["t_skin"].cpu().numpy(), tr.t_skin_c,
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(binary["soc"].cpu().numpy(), tr.soc,
                               rtol=1e-6, atol=1e-4)
    (tables, ys), = calls
    one = {k: v[..., 0] for k, v in tables.items() if k != "const"}
    one["const"] = {k: v[0] for k, v in tables["const"].items()}
    eager = daysim._integrate_one(one)
    for k in ds.TRACE_OUTS:
        assert torch.equal(eager[k], ys[k][0]), k


def test_optimize_policy_launches_held_to_plain(cuda, monkeypatch):
    """`optimize_policy` on the card: one full-trace launch for the
    baseline and one per hardened restart, each bit for bit equal to the
    plain version on its own tables (all 17 outputs)."""
    calls, scan = [], ds.day_scan

    def recording(tables, full=False):
        ys = scan(tables, full)
        calls.append((tables, ys))
        return ys

    monkeypatch.setattr(ds, "day_scan", recording)
    before = (ds.LAUNCHES, ds.FULL_LAUNCHES)
    opt = dse.optimize_policy("aria2_display", daysim.DEFAULT_DESIGNS[0],
                              "field_day", "battery_saver", n_restarts=2,
                              steps=1, dt_s=120.0)
    assert (ds.LAUNCHES - before[0], ds.FULL_LAUNCHES - before[1]) == (3, 3)
    assert len(calls) == 3
    for tables, ys in calls:
        want = ds.day_scan_plain(tables, full=True)
        assert tuple(ys) == tuple(want) == ds.TRACE_OUTS
        for k in want:
            assert torch.equal(ys[k], want[k]), k
    cpu = daysim.simulate("aria2_display", daysim.DEFAULT_DESIGNS[0],
                          "field_day", opt["policy"], dt_s=120.0,
                          device="cpu")
    assert cpu.summary["time_to_empty_h"] == opt["tte_h"]


def _soc0(n: int, seed: int, device) -> dict:
    g = torch.Generator().manual_seed(seed)
    soc0 = 0.05 + 0.9 * torch.rand(n, generator=g)
    soc0[0] = 0.0                   # a dead start
    return {"soc0": soc0.to(device),
            "soc0_p": (0.05 + 0.9 * torch.rand(n, generator=g)).to(device)}


@pytest.mark.parametrize("n,t,n_lvl", [(1, 50, 1), (37, 300, 3),
                                       (70, 200, 6), (200, 1000, 3)])
def test_full_trace_initial_soc_matches_plain(cuda, n, t, n_lvl):
    """The full-trace entry's soc0 / soc0_p: all 17 outputs bit for bit
    equal to the plain version; absent, the launch equals one from a
    full battery (soc0 = 1), and the default mode is untouched."""
    tables = random_tables(n, t, n_lvl, seed=n + 3, device=cuda)
    started = dict(tables, **_soc0(n, n, cuda))
    before = ds.FULL_LAUNCHES
    got = ds.day_scan(started, full=True)
    assert ds.FULL_LAUNCHES == before + 1
    want = ds.day_scan_plain(started, full=True)
    torch.cuda.synchronize()
    _assert_full_equal(got, want)
    plain = ds.day_scan(tables, full=True)
    ones = ds.day_scan(dict(tables, soc0=torch.ones(n, device=cuda),
                            soc0_p=torch.ones(n, device=cuda)), full=True)
    _assert_full_equal(ones, plain)
    _assert_full_equal(plain, ds.day_scan_plain(tables, full=True))
    if n > 1:
        assert not torch.equal(got["soc"], plain["soc"])
    with pytest.raises(ValueError, match="full-trace mode only"):
        ds.day_scan(started)


PER_USER = ("time_to_empty_h", "peak_skin_c", "end_soc", "shutdown",
            "pod_hours", "day_hours")


def test_fleet_day_chunks_and_positions_on_the_card(cuda, monkeypatch):
    """Per-user results do not depend on the chunk size or on a user's
    place in a chunk; one full-trace launch per chunk and day, each bit
    for bit equal to the plain version on its own tables."""
    calls, scan = [], ds.day_scan

    def recording(tables, full=False):
        ys = scan(tables, full)
        calls.append((tables, ys))
        return ys

    pop = fleet.sample_population(fleet.DEFAULT_POPULATION, 300, key=5)
    whole = fleet.fleet_day(pop, dt_s=60.0, n_days=2,
                            overnight_charge_mw=50.0)
    monkeypatch.setattr(ds, "day_scan", recording)
    monkeypatch.setattr(fleet, "CHUNK_USERS", 128)
    before = ds.FULL_LAUNCHES
    small = fleet.fleet_day(pop, dt_s=60.0, n_days=2,
                            overnight_charge_mw=50.0)
    assert ds.FULL_LAUNCHES - before == 3 * 2
    for tables, ys in calls:
        want = ds.day_scan_plain(tables, full=True)
        for k in want:
            assert torch.equal(ys[k], want[k]), k
    assert any("soc0" in t and bool((t["soc0"] < 1.0).any())
               for t, _ in calls)
    part = fleet.fleet_day(pop.take(np.arange(50, 150)), dt_s=60.0,
                           n_days=2, overnight_charge_mw=50.0)
    for k in PER_USER:
        assert np.array_equal(getattr(small, k), getattr(whole, k)), k
        assert np.array_equal(getattr(part, k),
                              getattr(whole, k)[50:150]), k
    np.testing.assert_allclose(small.curve, whole.curve, rtol=1e-12)


def test_fleet_day_on_the_card_matches_cpu(cuda):
    """512 users on the card against the same call on the CPU: survival,
    shutdown and time-to-empty equal, peak skin, end SoC, the curves and
    pod-hours within rtol 1e-6."""
    pop = fleet.sample_population(fleet.DEFAULT_POPULATION, 512, key=2)
    got = fleet.fleet_day(pop, dt_s=60.0)
    want = fleet.fleet_day(pop, dt_s=60.0, device="cpu")
    assert 0 < got.survives().sum() < len(got)
    assert np.array_equal(got.survives(), want.survives())
    for k in ("time_to_empty_h", "shutdown", "day_hours"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    np.testing.assert_allclose(got.peak_skin_c, want.peak_skin_c,
                               rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(got.end_soc, want.end_soc, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.pod_hours, want.pod_hours, rtol=1e-6)
    for k in ("curve", "stream_curve"):
        w = getattr(want, k)
        np.testing.assert_allclose(getattr(got, k), w, rtol=1e-6,
                                   atol=1e-6 * float(w.max()), err_msg=k)


# ---------------------------------------------------------------------------
# the flash backward kernel and training on the card
# ---------------------------------------------------------------------------

# float32 gradients against autograd of the plain forward: max error over
# the gradient's largest magnitude (1.5e-6 read on an H100 80GB HBM3 at
# 700 W); bf16 against
# the plain version's bf16 run, which rounds dP to bf16 where the kernel
# keeps float32: two bf16 spacings (2^-6) of the largest magnitude
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _autograd_plain(q, k, v, do, causal, window):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(o, (q, k, v), do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", [
    (1, 300, 300, 4, 4, 64, True, None),
    (1, 300, 300, 8, 2, 128, True, 96),     # GQA 4:1 + window
    (2, 200, 200, 4, 1, 64, False, None),   # bidirectional, GQA 4:1
    (1, 130, 70, 4, 2, 96, False, None),    # Sq > Sk, Dh 96
    (1, 70, 130, 2, 2, 64, True, None),     # Sq < Sk causal
    (1, 257, 257, 8, 4, 256, True, 5),      # Dh 256, window below a tile
    (1, 100, 300, 4, 4, 64, False, None),   # cross-attention shape
    (1, 37, 37, 4, 4, 96, True, None),      # below one tile
    (1, 600, 600, 8, 4, 256, True, None),   # Dh 256 GQA, many tiles
    (1, 130, 200, 4, 2, 256, False, None),  # Dh 256 ragged, bidirectional
])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KvH, Dh,
                                        causal, window):
    """dq / dk / dv through the autograd function (forward kernel with its
    lse, backward kernel) against autograd of the plain forward."""
    q, do = (_randn(i, (B, Sq, H, Dh), dtype, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), dtype, cuda) for i in (1, 2))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    fa.flash_attention(qg, kg, vg, causal=causal, window=window).backward(do)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    want = _autograd_plain(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for got, w in zip((qg.grad, kg.grad, vg.grad), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = float((got.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", [
    (2, 300, 300, 8, 2, 128, True, 96),
    (1, 600, 600, 8, 4, 256, True, None),
    (2, 200, 330, 4, 4, 64, False, None),
])
def test_flash_bwd_kernel_repeats_bit_for_bit(cuda, dtype, B, Sq, Sk, H,
                                              KvH, Dh, causal, window):
    """Every sum of the backward kernel runs in a fixed order: two calls
    on the same inputs give the same bits."""
    q, do = (_randn(i, (B, Sq, H, Dh), dtype, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), dtype, cuda) for i in (1, 2))
    o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window, lse=True)
    runs = [fa._flash_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                               window=window) for _ in range(2)]
    torch.cuda.synchronize()
    width = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b in zip(*runs):
        assert torch.equal(a.view(width), b.view(width))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_and_serving_output(cuda, dtype):
    """The forward's row lse matches its plain version; asking for it
    leaves the output bit for bit as the serving launch writes it."""
    q = _randn(0, (2, 300, 8, 128), dtype, cuda)
    k, v = (_randn(i, (2, 300, 2, 128), dtype, cuda) for i in (1, 2))
    o, lse = fa._flash_cuda(q, k, v, causal=True, window=96, lse=True)
    with torch.no_grad():
        served = fa.flash_attention(q, k, v, causal=True, window=96)
    torch.cuda.synchronize()
    assert torch.equal(o, served)
    want = fa.flash_attention_lse_plain(q, k, causal=True, window=96)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_train_step_on_the_card_matches_cpu(cuda):
    """olmo-1b's smoke config (heads widened to Dh 64 for the kernel) in
    float32: one `make_train_step` (remat) on the card and on the CPU from
    the same weights; loss within 1e-5, the first moments within 1e-4
    relative RMS; one forward, one recompute and one backward launch a
    layer."""
    from repro_torch import convert, tree
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.training import optimizer as opt
    base, model = registry.get("olmo-1b", smoke=True)
    cfg = dataclasses.replace(base, head_dim=64)
    np_tree = convert.lm_params_numpy(cfg, 0)
    batch = lm_batch(DataConfig(cfg.vocab, 64, 2), 0, "cpu")
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = convert.lm_params_from_numpy(np_tree, cfg, dev)
        f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
        _, state, m = steps.make_train_step(cfg, model)(
            params, opt.init(params), {k: v.to(dev) for k, v in
                                       batch.items()})
        out.append((state, m, (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0)))
    (s_card, m_card, launched), (s_cpu, m_cpu, _) = out
    assert launched == (2 * cfg.n_layers, cfg.n_layers)
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-5)
    for a, b in zip(tree.leaves(s_card["m"]), tree.leaves(s_cpu["m"])):
        assert _rel_rms(a.cpu(), b) <= 1e-4


def test_kernels_without_backward_raise_on_the_card(cuda):
    """A grad-requiring input to the day-scan kernel, the one kernel
    without a backward, raises instead of returning an output that
    carries no gradient; the SSD scan's output carries one (its backward
    kernel, one call)."""
    x = _randn(0, (1, 128, 2, 64), torch.float32, cuda).requires_grad_()
    dt = torch.full((1, 128, 2), 0.1, device=cuda)
    A = -torch.ones(2, device=cuda)
    Bm = _randn(1, (1, 128, 1, 64), torch.float32, cuda)
    b0 = ss.BWD_LAUNCHES
    y = ss.ssd_scan(x, dt, A, Bm, Bm, chunk=64)
    y.square().sum().backward()
    assert ss.BWD_LAUNCHES == b0 + 1
    assert bool(torch.isfinite(x.grad).all()) and bool((x.grad != 0).any())
    with torch.no_grad():
        ss.ssd_scan(x, dt, A, Bm, Bm, chunk=64)         # serving: fine
    tables = random_tables(5, 30, 2, 0, cuda)
    tables["step_mw"] = tables["step_mw"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        ds.day_scan(tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,g,n", [(1, 70, 2, 1, 64), (2, 600, 4, 2, 64),
                                       (1, 1100, 4, 1, 128), (1, 1, 2, 1, 64),
                                       (3, 700, 6, 3, 64), (2, 1000, 8, 2, 64),
                                       (1, 600, 20, 1, 64),
                                       (2, 300, 10, 1, 128)])
def test_ssd_bwd_matches_plain(cuda, dtype, b, s, h, g, n):
    """The SSD backward kernel (through `SSDScan`) against
    `ssd_scan_bwd_plain` on the same inputs: float32 within 1e-5 of each
    gradient's largest entry, bf16 within 5e-4 relative RMS (the kernel
    keeps every product in float32); two runs bit-equal.  The shapes
    cross the bf16 chunk blocks' edges: s = 1, a ragged tail, fewer heads
    a B/C group than a block takes (h 6 g 3, h 8 g 2), more and not a
    multiple of them (20 and 10 heads of one group: 8 + 8 + 4, 8 + 2),
    n 128."""
    ins = [_randn(0, (b, s, h, 64), dtype, cuda),
           0.05 * torch.nn.functional.softplus(
               _randn(1, (b, s, h), torch.float32, cuda)),
           -torch.exp(0.3 * _randn(2, (h,), torch.float32, cuda)),
           0.3 * _randn(3, (b, s, g, n), dtype, cuda),
           0.3 * _randn(4, (b, s, g, n), dtype, cuda)]
    dy = _randn(5, (b, s, h, 64), dtype, cuda)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = ss.ssd_scan(*leaves, chunk=64)
        runs.append(torch.autograd.grad(y, leaves, dy))
    want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
    for a, c, w in zip(*runs, want):
        assert torch.equal(a, c) and a.dtype == w.dtype
        a, w = a.float(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
        elif bool(w.any()):
            assert _rel_rms(a, w) <= 5e-4
        else:                       # s = 1: dA is 0 on both sides
            assert not bool(a.any())
