"""The CUDA kernels (day scan in both output modes, with the full trace's
initial SoC, up to 64 levels, flash attention at Dh 64 / 96 / 128 / 256
(bf16 on flash_fwd_hb at the edges of its kv tile, float32 on the
split-operand kernels, 96 padded to 128), at narrower
heads zero-padded to them and at wider heads on the wide kernels, and
transformer prefills through it, SSD scan at p 64 and
narrower, and at wider p and n in blocks) against their plain PyTorch
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
    (31, 129, 16),      # ragged N, 16 levels
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
    (33, 129, 16),                  # 16 levels
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
    bq, bk = fa.fwd_tile(64, torch.bfloat16)
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


# the bf16 forward at the built widths (flash_fwd_hb) at the edges of its
# kv tile bk (fwd_tile: 128 keys up to Dh 128, 64 at 256): (B, Sq, Sk, H,
# KvH, causal, window) of a case as a function of bk
BF16_EDGES = {
    "Sk = 1 mod bk, GQA 4:1": lambda bk: (1, 2 * bk + 1, 2 * bk + 1, 8, 2,
                                         True, None),
    "Sq < 64, GQA 4:1": lambda bk: (2, 37, bk + 1, 4, 1, False, None),
    "window over three tiles": lambda bk: (1, 5 * bk + 1, 5 * bk + 1, 8, 2,
                                           True, 2 * bk + 5),
    "Sq != Sk, causal": lambda bk: (2, 100, 3 * bk + 1, 4, 4, True, None),
}


@pytest.mark.parametrize("Dh", [64, 96, 128, 256])
@pytest.mark.parametrize("case", list(BF16_EDGES))
def test_flash_bf16_built_widths_at_the_tile_edges(cuda, Dh, case):
    """Each built width against the plain version at a key count one past
    whole kv tiles, a query count below one warpgroup's 64 rows, a window
    spanning three tiles and Sq != Sk; one launch each."""
    bk = fa.fwd_tile(Dh, torch.bfloat16)[1]
    B, Sq, Sk, H, KvH, causal, window = BF16_EDGES[case](bk)
    q = _randn(Dh, (B, Sq, H, Dh), torch.bfloat16, cuda)
    k = _randn(Dh + 1, (B, Sk, KvH, Dh), torch.bfloat16, cuda)
    v = _randn(Dh + 2, (B, Sk, KvH, Dh), torch.bfloat16, cuda)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    atol, rtol = FLASH_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("Dh", [64, 96, 128, 256])
def test_flash_bf16_lse_leaves_o_and_repeats(cuda, Dh):
    """At each built width, with a window across tiles and GQA: the launch
    with the row lse writes o bit for bit as the serving launch does, a
    repeat gives the same bits, and the lse matches its plain version."""
    bk = fa.fwd_tile(Dh, torch.bfloat16)[1]
    B, Sq, Sk, H, KvH, causal, window = BF16_EDGES["window over three "
                                                   "tiles"](bk)
    q = _randn(3, (B, Sq, H, Dh), torch.bfloat16, cuda)
    k, v = (_randn(i, (B, Sk, KvH, Dh), torch.bfloat16, cuda)
            for i in (4, 5))
    runs = [fa._flash_cuda(q, k, v, causal=causal, window=window, lse=True)
            for _ in range(2)]
    served = fa._flash_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o.view(torch.int16), served.view(torch.int16))
    assert torch.equal(o.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    want = fa.flash_attention_lse_plain(q, k, causal=causal, window=window)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


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
    """No width the TPU kernels take is refused: Dh 257 and 512 run on the
    wide kernels, p 65 / 128 and n 129 / 256 in blocks, each within the
    reference's tolerance of its plain version; only a grid dimension the
    card cannot launch raises, naming the limit."""
    for Dh in (257, 512):
        q = _randn(Dh, (1, 100, 2, Dh), torch.float32, cuda)
        got = fa.flash_attention(q, q, q)
        np.testing.assert_allclose(
            got.cpu().numpy(), fa.flash_attention_plain(q, q, q).cpu().numpy(),
            atol=TOL[torch.float32], rtol=TOL[torch.float32])
    dt = 0.05 * torch.ones(1, 100, 2, device=cuda)
    A = -torch.ones(2, device=cuda)
    for p, n in ((65, 64), (128, 64), (64, 129), (64, 256)):
        x = _randn(p, (1, 100, 2, p), torch.float32, cuda, 0.5)
        B = _randn(n, (1, 100, 1, n), torch.float32, cuda, 0.3)
        np.testing.assert_allclose(
            ss.ssd_scan(x, dt, A, B, B).cpu().numpy(),
            ss.ssd_scan_plain(x, dt, A, B, B).cpu().numpy(), atol=1e-4,
            rtol=5 * TOL[torch.float32])
    many = torch.zeros(65536, 1, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="grid dimension above 65535"):
        fa.flash_attention(many, many, many)


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


def _ssd_bwd_case(b, s, h, g, n, cuda, p=64):
    """bf16 x, dt (x 0.05), A, B, C and dy on the card, and the forward's
    group states."""
    bf = torch.bfloat16
    ins = [_randn(10, (b, s, h, p), bf, cuda, 0.5),
           0.05 * torch.nn.functional.softplus(
               _randn(11, (b, s, h), torch.float32, cuda)),
           -torch.exp(0.3 * _randn(12, (h,), torch.float32, cuda)),
           _randn(13, (b, s, g, n), bf, cuda, 0.3),
           _randn(14, (b, s, g, n), bf, cuda, 0.3)]
    dy = _randn(15, (b, s, h, p), bf, cuda)
    _, states = ss._ssd_cuda(*ins, states=True)
    return ins, dy, states


@pytest.mark.parametrize("n", [64, 128])
def test_ssd_bwd_hb_strided_views_match_dense(cuda, n):
    """The bf16 backward's TMA maps read the model's views (x / B / C in
    one conv output, dy in a wider buffer) where they lie: the gradients
    are the dense inputs' bit for bit, and a repeat is bit-equal."""
    b, s, h, g = 2, 1100, 6, 2
    ins, dy, states = _ssd_bwd_case(b, s, h, g, n, cuda)
    x, dt, A, B, C = ins
    xbc = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1),
                     C.reshape(b, s, -1)], -1)
    xv = xbc[..., :h * 64].reshape(b, s, h, 64)
    Bv = xbc[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    Cv = xbc[..., h * 64 + g * n:].reshape(b, s, g, n)
    wide = torch.zeros((b, s, h * 64 + 8), dtype=dy.dtype, device=cuda)
    wide[..., :h * 64] = dy.reshape(b, s, -1)
    dyv = wide[..., :h * 64].reshape(b, s, h, 64)
    assert all(ss._tma_ready(t) and not t.is_contiguous()
               for t in (xv, Bv, Cv, dyv))
    dense = ss._ssd_bwd_cuda(x, dt, A, B, C, dy, states)
    views = ss._ssd_bwd_cuda(xv, dt, A, Bv, Cv, dyv, states)
    again = ss._ssd_bwd_cuda(xv, dt, A, Bv, Cv, dyv, states)
    torch.cuda.synchronize()
    for a, c, d in zip(dense, views, again):
        assert torch.equal(a, c) and torch.equal(c, d)


@pytest.mark.parametrize("b,s,h,g,n,p", [
    (1, 1100, 80, 1, 128, 64),     # mamba2-2.7b's widths: 10 sets of 8
    (2, 700, 13, 1, 64, 64),       # 13 heads of a group: 8 + 5
    (1, 600, 4, 1, 256, 64),       # two n-blocks: the DXF32 sum
    (1, 600, 4, 2, 200, 100),      # p-blocks and n-blocks, padded
])
def test_ssd_bwd_hb_widths_and_sets(cuda, b, s, h, g, n, p):
    """The bf16 backward at mamba2-2.7b's widths, a head count the
    blocks' 8 do not divide, and past the built widths (n in two blocks
    whose float32 dx parts sum before one rounding; p in blocks as
    heads): within 5e-4 relative RMS of `ssd_scan_bwd_plain` on each
    gradient, a repeat bit-equal."""
    ins, dy, states = _ssd_bwd_case(b, s, h, g, n, cuda, p)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = ss.ssd_scan(*leaves, chunk=64)
        runs.append(torch.autograd.grad(y, leaves, dy))
    want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
    for a, c, w in zip(*runs, want):
        assert torch.equal(a, c) and a.dtype == w.dtype
        assert _rel_rms(a.float(), w.float()) <= 5e-4


def test_twin_query_syncs_are_covered_by_the_lint(cuda):
    """Every synchronizing operation torch reports (sync debug mode
    "warn") in a warm default-grid twin query sits, when its function is
    in the lint's static hot set, on a statement the lint covers (a
    finding, a reasoned suppression or a baseline entry)."""
    from pathlib import Path
    from repro_torch.analysis import audit
    from repro_torch.analysis.__main__ import BASELINE
    from repro_torch.analysis.engine import analyze
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    res = analyze([str(src)], baseline_path=BASELINE)
    assert res.exit_code == 0
    twin = DesignTwin(dt_s=60.0)
    twin.query()
    before = ds.LAUNCHES
    torch.cuda.synchronize()
    with audit.record_syncs() as sites:
        twin.query()
    torch.cuda.synchronize()
    assert ds.LAUNCHES == before + 1
    rows = audit.classify(sites, res)
    assert sum(r["syncs"] for r in rows) >= 1       # the summary's copy
    assert all(r["site"] is not None for r in rows), rows
    missed = [r for r in rows if r["hot"] and not r["covered"]]
    assert missed == [], missed


# ---------------------------------------------------------------------------
# widths the kernels are not built for: zero-padded to the next built one
# (flash Dh < 256, SSD p < 64 / n < 128), and the day scan past 16 levels
# (it is handed the three levels a step can select, whatever L)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KvH,Dh,causal,window", [
    (1, 128, 2, 2, 32, True, None),     # tests/test_kernels.py's sweep
    (2, 192, 8, 4, 32, False, None),
    (2, 200, 8, 8, 8, True, None),      # granite-3-2b / yi-34b / dbrx heads
    (2, 300, 4, 2, 16, True, 40),       # olmo-1b / gemma3-4b / zamba2 heads
    (1, 130, 4, 4, 16, False, None),
    (1, 70, 4, 2, 80, True, None),      # padded to 96
    (1, 70, 4, 2, 112, True, None),     # padded to 128
    (1, 70, 4, 2, 200, True, 20),       # padded to 256
])
def test_flash_kernel_narrow_heads(cuda, dtype, B, S, H, KvH, Dh, causal,
                                   window):
    """A head narrower than the kernels' widths launches the kernel once
    (zero-padded) and matches the plain version; its gradients through
    the autograd function match autograd of the plain forward."""
    q, do = (_randn(i, (B, S, H, Dh), dtype, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, S, KvH, Dh), dtype, cuda) for i in (1, 2))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    atol, rtol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    fa.flash_attention(qg, kg, vg, causal=causal, window=window).backward(do)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    grads = _autograd_plain(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for a, w in zip((qg.grad, kg.grad, vg.grad), grads):
        assert a.shape == w.shape and a.dtype == dtype
        err = float((a.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (1, 128, 2, 8, 1, 16),              # tests/test_kernels.py's sweep
    (2, 256, 4, 16, 2, 32),
    (1, 256, 8, 32, 1, 64),
    (2, 128, 4, 8, 4, 16),
    (2, 1000, 8, 16, 1, 16),            # zamba2 / mamba2 smoke widths, split
    (1, 600, 4, 40, 2, 100),            # n padded to 128
])
def test_ssd_kernel_narrow_widths(cuda, dtype, b, s, h, p, g, n):
    """Narrow p and n through the kernels (zero-padded): y against the
    plain version at the reference's tolerances, the gradients through
    `SSDScan` against `ssd_scan_bwd_plain` (float32 1e-5 of the largest
    entry, bf16 5e-4 relative RMS)."""
    ins = [_randn(0, (b, s, h, p), dtype, cuda, 0.5),
           0.05 * torch.nn.functional.softplus(
               _randn(1, (b, s, h), torch.float32, cuda)),
           -torch.exp(0.3 * _randn(2, (h,), torch.float32, cuda)),
           _randn(3, (b, s, g, n), dtype, cuda, 0.3),
           _randn(4, (b, s, g, n), dtype, cuda, 0.3)]
    dy = _randn(5, (b, s, h, p), dtype, cuda)
    before = ss.LAUNCHES
    y = ss.ssd_scan(*ins, chunk=64)
    assert ss.LAUNCHES == before + ss.kernel_launches(s)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        y.float().cpu().numpy(),
        ss.ssd_scan_plain(*ins, chunk=64).float().cpu().numpy(),
        atol=max(tol, 1e-4), rtol=5 * tol)
    leaves = [t.clone().requires_grad_() for t in ins]
    got = torch.autograd.grad(ss.ssd_scan(*leaves, chunk=64), leaves, dy)
    want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        a, w = a.float(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            assert _rel_rms(a, w) <= 5e-4


@pytest.mark.parametrize("n_lvl", [17, 32, 64, 300])
@pytest.mark.parametrize("n,steps", [(37, "tc+1"), (64, "9tc+1"),
                                     (1, "tc-1")])
def test_kernel_many_levels_match_plain(cuda, n_lvl, n, steps):
    """17 to 300 levels in both output modes (the kernel is handed the three
    a step can select, on the chunk of L = 3), T around each mode's
    chunk: every output bit for bit equal to the plain version."""
    for full in (False, True):
        tc = ds.chunk_steps(n_lvl, full)
        assert tc == ds.chunk_steps(3, full) >= 1
        t = {"tc-1": max(tc - 1, 1), "tc+1": tc + 1,
             "9tc+1": 9 * tc + 1}[steps]
        tables = random_tables(n, t, n_lvl, seed=n_lvl + n, device=cuda)
        before = ds.LAUNCHES
        got = ds.day_scan(tables, full=full)
        assert ds.LAUNCHES == before + 1
        want = ds.day_scan_plain(tables, full=full)
        torch.cuda.synchronize()
        (_assert_full_equal if full else _assert_all_equal)(got, want)


def test_transformer_prefill_unwidened_smoke_matches_cpu(cuda):
    """gemma3's smoke config at its own head width (Dh 16, padded to 64 on
    the card) in float32: the prefill step's last hidden and cache on the
    card against the same call on the CPU, one flash launch a layer."""
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import registry
    cfg, model = registry.get("gemma3-4b", smoke=True)
    assert cfg.head_dim < min(fa.HEAD_DIMS)
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


# ---------------------------------------------------------------------------
# widths above the built ones: the wide flash kernels, the SSD's blocks
# ---------------------------------------------------------------------------

WIDE_FLASH_CASES = [
    (1, 300, 300, 4, 2, 320, True, None),     # causal GQA, 64-wide last block
    (1, 300, 300, 4, 2, 320, True, 96),       # window
    (2, 200, 200, 2, 2, 512, False, None),    # bidirectional, two blocks
    (1, 130, 210, 4, 2, 512, False, None),    # Sq < Sk
    (1, 257, 257, 2, 1, 257, True, 5),        # padded to 320, small window
    (1, 700, 700, 2, 2, 576, True, None),     # three column blocks
    (1, 200, 200, 2, 1, 2112, True, None),    # nine: past a cluster
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", WIDE_FLASH_CASES)
def test_flash_wide_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KvH, Dh,
                                         causal, window):
    """The forward past Dh 256 (one launch) against the plain version at
    the built widths' tolerances."""
    q = _randn(0, (B, Sq, H, Dh), dtype, cuda)
    k, v = (_randn(i, (B, Sk, KvH, Dh), dtype, cuda) for i in (1, 2))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", WIDE_FLASH_CASES)
def test_flash_wide_bf16_forward_repeats_and_its_lse(cuda, B, Sq, Sk, H, KvH,
                                                     Dh, causal, window):
    """The bf16 forward past Dh 256 (clusters of column blocks that sum
    their partial scores in rank order; past 8 blocks none): a repeat is
    bit-equal, asking for the row lse leaves o as the serving launch
    writes it, and the lse (column block 0's, which every block holds)
    matches `flash_attention_lse_plain` within 1e-5."""
    bf = torch.bfloat16
    q = _randn(0, (B, Sq, H, Dh), bf, cuda)
    k, v = (_randn(i, (B, Sk, KvH, Dh), bf, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    runs = [fa._flash_cuda(q, k, v, lse=True, **mask) for _ in range(2)]
    served = fa._flash_cuda(q, k, v, **mask)
    want = fa.flash_attention_lse_plain(q, k, **mask)
    torch.cuda.synchronize()
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(o.view(torch.int16), served.view(torch.int16))
    assert torch.equal(lse, lse2)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("Dh", [320, 512, 576])
def test_flash_wide_bf16_rounds_p_like_the_reference(cuda, Dh):
    """The bf16 forward past Dh 256 rounds p to v's dtype before the PV
    product, on the built widths' tiles (`TILES`): against the plain
    version on those tiles it is closer than that version with p left
    unrounded is (ex2.approx moves p by ~2^-22 before its rounding)."""
    from repro_torch.nn import attention as attn
    q = _randn(0, (1, 700, 4, Dh), torch.bfloat16, cuda)
    k, v = (_randn(i, (1, 700, 2, Dh), torch.bfloat16, cuda) for i in (1, 2))
    got = fa.flash_attention(q, k, v, causal=True)
    bq, bk = fa.fwd_tile(Dh, torch.bfloat16)
    tiles = {"causal": True, "chunk_q": bq, "chunk_k": bk}
    want = attn.chunked_attention(q, k, v, **tiles)
    control = attn.chunked_attention(q, k, v.float(), **tiles)
    assert _rel_rms(got, want) <= FLASH_ROUNDING_LIMIT < \
        _rel_rms(control, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", WIDE_FLASH_CASES)
def test_flash_wide_bwd_matches_plain_and_repeats(cuda, dtype, B, Sq, Sk, H,
                                                  KvH, Dh, causal, window):
    """The backward past Dh 256 through the autograd function against
    autograd of the plain forward (BWD_TOL of each gradient's largest
    magnitude), and two calls on the same inputs bit for bit equal."""
    q, do = (_randn(i, (B, Sq, H, Dh), dtype, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), dtype, cuda) for i in (1, 2))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, causal=causal, window=window).backward(do)
    want = _autograd_plain(q, k, v, do, causal, window)
    o, lse = fa._flash_cuda(q, k, v, causal=causal, window=window, lse=True)
    runs = [fa._flash_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                               window=window) for _ in range(2)]
    torch.cuda.synchronize()
    width = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, w, a, b in zip((qg.grad, kg.grad, vg.grad), want, *runs):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = float((got.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * float(w.float().abs().max())
        assert torch.equal(a.view(width), b.view(width))


# bf16 backward past Dh 256 at the largest cluster (8 column blocks, Dh
# 2048) and past it (9 blocks: passes through the scratch's totals)
WIDE_BWD_EXTRA = [
    (1, 200, 200, 2, 1, 1024, True, None),    # four column blocks
    (1, 130, 130, 2, 2, 2048, True, 70),      # eight, a window
    (1, 130, 150, 2, 1, 2100, False, None),   # padded to 2112: nine
]
# phase 18's bf16 tolerances (chip_smoke.BWD_BF16_MAX / BWD_BF16_RMS): one
# bf16 spacing at the gradient's largest magnitude each side, and a
# relative RMS under half a spacing
WIDE_BWD_BF16 = (2.0 ** -6, 2.0 ** -8)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window",
                         WIDE_FLASH_CASES + WIDE_BWD_EXTRA)
def test_flash_wide_bf16_bwd_matches_plain_version(cuda, B, Sq, Sk, H, KvH,
                                                   Dh, causal, window):
    """The bf16 backward past Dh 256 (clusters of column blocks on the
    tensor cores) on the forward kernel's own o and lse against
    `flash_attention_bwd_plain` at phase 18's bf16 tolerances, one call
    counted, a repeat bit-equal; the control: the same gradients against
    float32 ones miss the float32 tolerance."""
    bf = torch.bfloat16
    q, do = (_randn(i, (B, Sq, H, Dh), bf, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), bf, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    o, lse = fa._flash_cuda(q, k, v, lse=True, **mask)
    before = fa.BWD_LAUNCHES
    runs = [fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)
            for _ in range(2)]
    assert fa.BWD_LAUNCHES == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **mask)
    f32 = _autograd_plain(q.float(), k.float(), v.float(), do.float(),
                          causal, window)
    torch.cuda.synchronize()
    top, rms = WIDE_BWD_BF16
    for a, b, w, f in zip(*runs, want, f32):
        assert a.dtype == bf and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        a, w, f = a.float(), w.float(), f.float()
        assert float((a - w).abs().max()) <= top * float(w.abs().max())
        assert _rel_rms(a, w) <= rms
        ctrl = float((a - f).abs().max() / f.abs().max())
        assert ctrl > BWD_TOL[torch.float32], ctrl


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window",
                         WIDE_FLASH_CASES + [(1, 150, 150, 2, 1, 2100, True,
                                              None)])
def test_flash_wide_f32_forward_repeats_and_its_lse(cuda, B, Sq, Sk, H, KvH,
                                                    Dh, causal, window):
    """The float32 forward past Dh 256 (clusters of column blocks of one or
    two chunks on the tensor cores, every operand split into three bf16
    parts; past 8 blocks none, Dh 2100 -> 2112): within the float32
    tolerance of the plain version, a repeat bit-equal, asking for the
    row lse leaves o as the serving launch writes it, and the lse (column
    block 0's) within 1e-5 of `flash_attention_lse_plain`."""
    f32 = torch.float32
    q = _randn(0, (B, Sq, H, Dh), f32, cuda)
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    runs = [fa._flash_cuda(q, k, v, lse=True, **mask) for _ in range(2)]
    served = fa._flash_cuda(q, k, v, **mask)
    want = fa.flash_attention_plain(q, k, v, **mask)
    want_lse = fa.flash_attention_lse_plain(q, k, **mask)
    torch.cuda.synchronize()
    (o, lse), (o2, lse2) = runs
    atol, rtol = FLASH_TOL[f32]
    torch.testing.assert_close(o, want, atol=atol, rtol=rtol)
    assert torch.equal(o.view(torch.int32), o2.view(torch.int32))
    assert torch.equal(o.view(torch.int32), served.view(torch.int32))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window",
                         WIDE_FLASH_CASES + WIDE_BWD_EXTRA)
def test_flash_wide_f32_bwd_matches_plain_version(cuda, B, Sq, Sk, H, KvH,
                                                  Dh, causal, window):
    """The float32 backward past Dh 256 (clusters of up to 8 one-chunk
    column blocks, operands split into three bf16 parts; past 8, passes
    through the scratch's totals) on the forward kernel's own o and lse
    against `flash_attention_bwd_plain` on its tiles (1e-5 of each
    gradient's largest magnitude), one call counted, a repeat
    bit-equal."""
    f32 = torch.float32
    q, do = (_randn(i, (B, Sq, H, Dh), f32, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    o, lse = fa._flash_cuda(q, k, v, lse=True, **mask)
    before = fa.BWD_LAUNCHES
    runs = [fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)
            for _ in range(2)]
    assert fa.BWD_LAUNCHES == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **mask)
    torch.cuda.synchronize()
    for a, b, w in zip(*runs, want):
        assert a.dtype == f32 and a.shape == w.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert float((a - w).abs().max()) <= BWD_TOL[f32] * \
            float(w.abs().max())


def test_flash_wide_f32_tolerances_see_a_one_part_shortcut(cuda):
    """The control of the float32 wide kernels' split: at a causal shape
    the kernels meet the float32 tolerances (forward 2e-5 against the
    plain version, backward 1e-5 of each gradient's largest magnitude
    against autograd of it), while the plain version on the inputs
    rounded to bf16 (what one bf16 part would multiply) misses both."""
    f32 = torch.float32
    B, Sq, Sk, H, KvH, Dh, causal, window = WIDE_FLASH_CASES[0]
    q, do = (_randn(i, (B, Sq, H, Dh), f32, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    rounded = [t.bfloat16().float() for t in (q, k, v, do)]
    atol, rtol = FLASH_TOL[f32]
    want = fa.flash_attention_plain(q, k, v, **mask)
    got = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=atol, rtol=rtol)
    assert not torch.allclose(fa.flash_attention_plain(*rounded[:3], **mask),
                              want, atol=atol, rtol=rtol)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, **mask).backward(do)
    grads = _autograd_plain(q, k, v, do, causal, window)
    ctl = _autograd_plain(*rounded, causal, window)
    torch.cuda.synchronize()
    for a, c, w in zip((qg.grad, kg.grad, vg.grad), ctl, grads):
        top = float(w.abs().max())
        assert float((a - w).abs().max()) <= BWD_TOL[f32] * top
        assert float((c - w).abs().max()) > BWD_TOL[f32] * top


# float32 at the built widths, the same split-operand kernels as past Dh
# 256 (Dh 96 padded to 128, 160 to 192; Dh 64 and 128 one block alone
# forward, 192 and 256 a cluster of 2; backward Dh 64 one block alone,
# 128, 192 and 256 clusters of 2, 3 and 4): a window across tiles,
# bidirectional Sq > Sk, causal Sq < Sk, a window below a tile, gemma3's
# local window past many tiles
BUILT_F32_CASES = [
    (1, 300, 300, 4, 2, 64, True, 96),
    (2, 200, 130, 4, 4, 64, False, None),
    (1, 257, 257, 8, 2, 96, True, 5),
    (1, 130, 330, 4, 2, 96, True, None),
    (2, 300, 300, 8, 2, 128, True, 96),
    (1, 200, 130, 4, 1, 128, False, None),
    (1, 257, 257, 4, 2, 160, True, 96),
    (1, 600, 600, 8, 4, 256, True, None),
    (1, 1100, 1100, 8, 4, 256, True, 1024),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", BUILT_F32_CASES)
def test_flash_f32_built_forward_repeats_and_its_lse(cuda, B, Sq, Sk, H, KvH,
                                                     Dh, causal, window):
    """The float32 forward at Dh <= 256 (split operands on wgmma): within
    the float32 tolerance of the plain version, one launch, a repeat
    bit-equal, asking for the row lse leaves o as the serving launch
    writes it, and the lse within 1e-5 of `flash_attention_lse_plain`."""
    f32 = torch.float32
    q = _randn(0, (B, Sq, H, Dh), f32, cuda)
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    before = fa.LAUNCHES
    runs = [fa._flash_cuda(q, k, v, lse=True, **mask) for _ in range(2)]
    served = fa._flash_cuda(q, k, v, **mask)
    assert fa.LAUNCHES == before + 3
    want = fa.flash_attention_plain(q, k, v, **mask)
    want_lse = fa.flash_attention_lse_plain(q, k, **mask)
    torch.cuda.synchronize()
    (o, lse), (o2, lse2) = runs
    atol, rtol = FLASH_TOL[f32]
    assert o.shape == q.shape
    torch.testing.assert_close(o, want, atol=atol, rtol=rtol)
    assert torch.equal(o.view(torch.int32), o2.view(torch.int32))
    assert torch.equal(o.view(torch.int32), served.view(torch.int32))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", BUILT_F32_CASES)
def test_flash_f32_built_bwd_matches_plain_version(cuda, B, Sq, Sk, H, KvH,
                                                   Dh, causal, window):
    """The float32 backward at Dh <= 256 (split operands on wgmma) on the
    forward kernel's own o and lse against `flash_attention_bwd_plain` on
    its tiles and autograd of the plain forward (1e-5 of each gradient's
    largest magnitude), one call counted, a repeat bit-equal."""
    f32 = torch.float32
    q, do = (_randn(i, (B, Sq, H, Dh), f32, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    o, lse = fa._flash_cuda(q, k, v, lse=True, **mask)
    before = fa.BWD_LAUNCHES
    runs = [fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)
            for _ in range(2)]
    assert fa.BWD_LAUNCHES == before + 2
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **mask)
    auto = _autograd_plain(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for a, b, w, u in zip(*runs, want, auto):
        assert a.dtype == f32 and a.shape == w.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for ref_ in (w, u):
            assert float((a - ref_).abs().max()) <= BWD_TOL[f32] * \
                float(ref_.abs().max())


@pytest.mark.parametrize("Dh", [64, 256])
def test_flash_f32_built_tolerances_see_a_one_part_shortcut(cuda, Dh):
    """The control of the float32 split at the built widths: at a causal
    GQA shape the kernels meet the float32 tolerances (forward 2e-5
    against the plain version, backward 1e-5 of each gradient's largest
    magnitude against autograd of it), while the plain version on the
    inputs rounded to bf16 (what one bf16 part would multiply) misses
    both."""
    f32 = torch.float32
    B, Sq, Sk, H, KvH, causal, window = 1, 300, 300, 4, 2, True, None
    q, do = (_randn(i, (B, Sq, H, Dh), f32, cuda) for i in (0, 3))
    k, v = (_randn(i, (B, Sk, KvH, Dh), f32, cuda) for i in (1, 2))
    mask = dict(causal=causal, window=window)
    rounded = [t.bfloat16().float() for t in (q, k, v, do)]
    atol, rtol = FLASH_TOL[f32]
    want = fa.flash_attention_plain(q, k, v, **mask)
    got = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, atol=atol, rtol=rtol)
    assert not torch.allclose(fa.flash_attention_plain(*rounded[:3], **mask),
                              want, atol=atol, rtol=rtol)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg, **mask).backward(do)
    grads = _autograd_plain(q, k, v, do, causal, window)
    ctl = _autograd_plain(*rounded, causal, window)
    torch.cuda.synchronize()
    for a, c, w in zip((qg.grad, kg.grad, vg.grad), ctl, grads):
        top = float(w.abs().max())
        assert float((a - w).abs().max()) <= BWD_TOL[f32] * top
        assert float((c - w).abs().max()) > BWD_TOL[f32] * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (2, 1000, 4, 128, 1, 128),          # p in two blocks of 64
    (1, 600, 4, 80, 2, 64),             # p padded to two blocks
    (2, 1000, 4, 64, 1, 256),           # n in two blocks of 128
    (1, 1100, 4, 128, 2, 192),          # n in a block of 128 and one of 64
    (1, 70, 2, 65, 1, 129),             # one group, both padded
])
def test_ssd_kernels_past_the_built_widths(cuda, dtype, b, s, h, p, g, n):
    """p past 64 and n past 128 through the kernels (p-blocks as heads,
    one call an n-block, float32 partial y / dx in bf16): y against the
    plain version at the reference's tolerances, the gradients through
    `SSDScan` against `ssd_scan_bwd_plain` (float32 1e-5 of the largest
    entry, bf16 5e-4 relative RMS), two backward runs bit-equal."""
    ins = [_randn(0, (b, s, h, p), dtype, cuda, 0.5),
           0.05 * torch.nn.functional.softplus(
               _randn(1, (b, s, h), torch.float32, cuda)),
           -torch.exp(0.3 * _randn(2, (h,), torch.float32, cuda)),
           _randn(3, (b, s, g, n), dtype, cuda, 0.3),
           _randn(4, (b, s, g, n), dtype, cuda, 0.3)]
    dy = _randn(5, (b, s, h, p), dtype, cuda)
    before = ss.LAUNCHES
    y = ss.ssd_scan(*ins, chunk=64)
    assert ss.LAUNCHES == before + ss.kernel_launches(s, n)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        y.float().cpu().numpy(),
        ss.ssd_scan_plain(*ins, chunk=64).float().cpu().numpy(),
        atol=max(tol, 1e-4), rtol=5 * tol)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in ins]
        runs.append(torch.autograd.grad(ss.ssd_scan(*leaves, chunk=64),
                                        leaves, dy))
    want = ss.ssd_scan_bwd_plain(*ins, dy, chunk=64)
    for a, c, w in zip(*runs, want):
        assert torch.equal(a, c)
        assert a.shape == w.shape and a.dtype == w.dtype
        a, w = a.float(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            assert _rel_rms(a, w) <= 5e-4


# ---------------------------------------------------------------------------
# the bf16 SSD forward on wgmma (ssd_kernel_state_hb / ssd_kernel_scan_hb)
# ---------------------------------------------------------------------------

def _ssd_ins(cuda, b, s, h, g, n, dt_scale=0.05, p=64, seed=0):
    return [_randn(seed, (b, s, h, p), torch.bfloat16, cuda, 0.5),
            dt_scale * torch.nn.functional.softplus(
                _randn(seed + 1, (b, s, h), torch.float32, cuda)),
            -torch.exp(_randn(seed + 2, (h,), torch.float32, cuda, 0.3)),
            _randn(seed + 3, (b, s, g, n), torch.bfloat16, cuda, 0.3),
            _randn(seed + 4, (b, s, g, n), torch.bfloat16, cuda, 0.3)]


def _hold_ssd_bf16(got, ins):
    """y within SSD_BF16_LIMIT of the plain version, which the bf16-product
    control misses."""
    want = ss.ssd_scan_plain(*ins, chunk=64)
    control = ss.ssd_scan_rounded_plain(*ins, chunk=64)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_rms(got, want) <= SSD_BF16_LIMIT < _rel_rms(control, want)


@pytest.mark.parametrize("b,s,h,g,n", [(2, 1100, 4, 1, 64),
                                       (1, 1500, 3, 1, 128)])
def test_ssd_bf16_forward_repeats_bit_for_bit(cuda, b, s, h, g, n):
    """No atomics and a fixed order: a repeat of the bf16 forward gives y
    and the group states bit for bit, and so does the launch that keeps
    its states (what `SSDScan` runs)."""
    ins = _ssd_ins(cuda, b, s, h, g, n)
    y = ss.ssd_scan(*ins)
    y2, st = ss._ssd_cuda(*ins, states=True)
    y3, st3 = ss._ssd_cuda(*ins, states=True)
    assert torch.equal(y, y2) and torch.equal(y2, y3)
    assert torch.equal(st, st3)
    assert torch.equal(ss.ssd_group_states_cuda(*ins),
                       ss.ssd_group_states_cuda(*ins))
    _hold_ssd_bf16(y, ins)


def test_ssd_bf16_forward_at_mamba2_widths(cuda):
    """mamba2-2.7b's heads and state (h 80, n 128: two heads a block, 40
    blocks a group of chunks) over three groups: y against the plain
    version with the bf16 control, the group states within the float32
    tolerance of `ssd_split_states_plain`, three launches."""
    ins = _ssd_ins(cuda, 1, 1500, 80, 1, 128, dt_scale=1.0)
    before = ss.LAUNCHES
    y = ss.ssd_scan(*ins)
    assert ss.LAUNCHES == before + ss.kernel_launches(1500, 128) == \
        before + 3
    _hold_ssd_bf16(y, ins)
    states = ss.ssd_group_states_cuda(*ins)
    want = ss.ssd_split_states_plain(*ins, chunk=64)
    torch.cuda.synchronize()
    np.testing.assert_allclose(states.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,g,n", [
    (1, 700, 5, 1, 64),       # 5 heads: sets of 2, 2, 1
    (2, 1000, 9, 3, 128),     # 3 a B/C group: sets of 2 and 1, per group
    (1, 600, 1, 1, 64),       # one head, one short set
])
def test_ssd_bf16_heads_not_a_multiple_of_a_block(cuda, b, s, h, g, n):
    """The heads of a B/C group in sets of `HEADS` a block, the last set
    short when they do not divide h / g: every head's y against the plain
    version with the bf16 control, the group states within the float32
    tolerance; each head's y unchanged when run alone (its own B/C
    group's rows, no other head's state)."""
    ins = _ssd_ins(cuda, b, s, h, g, n)
    y = ss.ssd_scan(*ins)
    _hold_ssd_bf16(y, ins)
    states = ss.ssd_group_states_cuda(*ins)
    want = ss.ssd_split_states_plain(*ins, chunk=64)
    torch.cuda.synchronize()
    np.testing.assert_allclose(states.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    x, dt, A, B, C = ins
    hpg = h // g
    for hd in (0, h - 1):
        gg = hd // hpg
        alone = ss.ssd_scan(x[:, :, hd:hd + 1].contiguous(),
                            dt[:, :, hd:hd + 1].contiguous(), A[hd:hd + 1],
                            B[:, :, gg:gg + 1].contiguous(),
                            C[:, :, gg:gg + 1].contiguous())
        assert torch.equal(alone[:, :, 0], y[:, :, hd])


def test_ssd_bf16_float32_y_of_each_n_block_sums_once(cuda):
    """n 256 runs as two n-blocks of 128 (`state_blocks`), each launch
    writing a float32 y (dtype code 2, the YF32 instances): the call's y
    is the two blocks' float32 y summed and rounded to bf16 once, bit for
    bit; each block's float32 y within the float32 tolerance of its plain
    version's; y against the plain version with the bf16 control."""
    b, s, h, g, n = 1, 1000, 4, 1, 256
    ins = _ssd_ins(cuda, b, s, h, g, n)
    x, dt, A, B, C = ins

    def block_f32(n0, n1):
        done, st, decay = ss._prepare(x, dt, A, B[..., n0:n1], C[..., n0:n1],
                                      views=True)
        y = torch.empty(x.shape, dtype=torch.float32, device=cuda)
        ss._call(ss._lib("ssd_scan_launch"), (*done, y, st, decay),
                 ss._fwd_args(done, True), "ssd_scan")
        return y
    parts = [block_f32(0, 128), block_f32(128, 256)]
    y = ss.ssd_scan(*ins)
    assert torch.equal(y, (parts[0] + parts[1]).to(torch.bfloat16))
    for (n0, n1), part in zip(((0, 128), (128, 256)), parts):
        want = ss.ssd_scan_plain(x.float(), dt, A, B[..., n0:n1].float(),
                                 C[..., n0:n1].float(), chunk=64)
        torch.cuda.synchronize()
        np.testing.assert_allclose(part.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=5 * TOL[torch.float32])
    _hold_ssd_bf16(y, ins)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_bf16_strided_views_read_where_they_lie(cuda, g):
    """x / B / C as the model has them, views into one (b, s, d_inner +
    2 g n) conv output: the TMA maps read them uncopied (`_tma_ready`),
    and y and the group states equal, bit for bit, those of the same
    values made contiguous; a view whose row stride is off 16 bytes is
    copied and gives the same y too."""
    b, s, h, n = 2, 1100, 4, 64
    wide = _randn(9, (b, s, h * 64 + 2 * g * n), torch.bfloat16, cuda, 0.4)
    x = wide[..., :h * 64].reshape(b, s, h, 64)
    B = wide[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    C = wide[..., h * 64 + g * n:].reshape(b, s, g, n)
    dt = 0.05 * torch.nn.functional.softplus(
        _randn(10, (b, s, h), torch.float32, cuda))
    A = -torch.exp(_randn(11, (h,), torch.float32, cuda, 0.3))
    assert all(ss._tma_ready(t) for t in (x, B, C))
    dense = [x.contiguous(), dt, A, B.contiguous(), C.contiguous()]
    y, st = ss._ssd_cuda(x, dt, A, B, C, states=True)
    y_d, st_d = ss._ssd_cuda(*dense, states=True)
    assert torch.equal(y, y_d) and torch.equal(st, st_d)
    odd = _randn(12, (b, s, h * 64 + 4), torch.bfloat16, cuda)
    x_odd = odd[..., :h * 64].reshape(b, s, h, 64)
    assert not ss._tma_ready(x_odd)
    assert torch.equal(ss.ssd_scan(x_odd, dt, A, B, C),
                       ss.ssd_scan(x_odd.contiguous(), dt, A, B, C))
    _hold_ssd_bf16(y, dense)
