"""The bf16 SSD forward's host-side rules and its arithmetic on the CPU:
the truncated three-part split (`trunc_parts`), the plain version of the
kernel's dt-folded products (`ssd_scan_fold_plain`) against the reference
Pallas kernel in interpret mode and `ssd_chunked` at the float32
tolerance (with a one-part control that misses it), the launches' grids
and the heads each block takes (`launch_grids`, `block_heads`, on meta
tensors), which inputs the TMA maps read where they lie (`_tma_ready`,
`_strides`, `_prepare`), and that every `ssd-variants` edit of
scripts/kernel_probe.py still finds its source text.  Inputs come from
numpy and cross as arrays.

Tolerances are the reference's own (`tests/test_kernels.py`): atol
max(tol, 1e-4) and rtol 5 tol, tol = 2e-5 (float32) or 2e-2 (bfloat16)."""
import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_scan as j_kernel
from repro.nn import ssd as j_ssd
from repro_torch.kernels import ssd_scan as ss

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, dtype, b, s, h, p, g, n, dt_scale=1.0):
    """x, dt (dt_scale x softplus of a normal), A (-exp of 0.3 normal),
    B, C, for both packages."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((b, s, h, p))
    dt = dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(0.3 * rng.standard_normal(h))
    B = 0.3 * rng.standard_normal((b, s, g, n))
    C = 0.3 * rng.standard_normal((b, s, g, n))
    arrs = [a.astype(np.float32) for a in (x, dt, A, B, C)]
    low = (True, False, False, True, True)       # x, B, C in the dtype
    j = [jnp.asarray(a).astype(J_DT[dtype]) if lo else jnp.asarray(a)
         for a, lo in zip(arrs, low)]
    t = [torch.from_numpy(a).to(T_DT[dtype]) if lo else torch.from_numpy(a)
         for a, lo in zip(arrs, low)]
    return j, t


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=max(tol, 1e-4), rtol=5 * tol)


def test_trunc_parts_carry_every_bit():
    """Three truncated bf16 parts sum to the float32 value bit for bit at
    any magnitude; each part is a bf16 (its low 16 bits zero); two parts
    leave bits out."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy((rng.standard_normal(20000)
                          * np.exp(rng.uniform(-40, 40, 20000)))
                         .astype(np.float32))
    parts = ss.trunc_parts(t, 3)
    assert torch.equal(parts[0] + parts[1] + parts[2], t)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
        assert not (part.view(torch.int32) & 0xFFFF).any()
    assert not torch.equal(parts[0] + parts[1], t)
    assert float((parts[1].abs() / t.abs()).max()) < 2 ** -7
    assert float((parts[2].abs() / t.abs()).max()) < 2 ** -15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,group", [
    (1, 256, 2, 16, 1, 32, 8),     # one group: the scan alone
    (2, 320, 4, 8, 2, 16, 2),      # three groups carry the state
    (1, 384, 3, 16, 1, 16, 1),     # a chunk a group
])
def test_fold_plain_matches_pallas_and_ssd_chunked(dtype, b, s, h, p, g, n,
                                                   group):
    """The bf16 kernel's arithmetic (dt folded into W's columns, every
    float32 operand as three truncated bf16 parts, the split into groups)
    is the scan at the float32 tolerance: against the Pallas kernel in
    interpret mode and `ssd_chunked`, at chunk 64.  Slow decay (dt x
    0.05), so the carried state moves y."""
    j, t = _inputs(s + h + group, dtype, b, s, h, p, g, n, dt_scale=0.05)
    got = ss.ssd_scan_fold_plain(*t, group=group)
    assert got.dtype == T_DT[dtype] and got.shape == (b, s, h, p)
    _close(got, j_kernel.ssd_scan(*j, chunk=64, interpret=True), dtype)
    _close(got, j_ssd.ssd_chunked(*j, chunk=64)[0], dtype)


def test_fold_plain_one_part_misses_the_float32_tolerance():
    """The control: with one truncated bf16 part for each float32 operand
    (W' with dt folded in, S, B dt decay) the scan leaves the float32
    tolerance that three parts keep, and two parts stay within it at
    float32 rounding's order only."""
    j, t = _inputs(11, "float32", 1, 384, 2, 16, 1, 32, dt_scale=0.05)
    want = np.asarray(j_ssd.ssd_chunked(*j, chunk=64)[0], np.float32)
    three = ss.ssd_scan_fold_plain(*t).numpy()
    one = ss.ssd_scan_fold_plain(*t, parts=1).numpy()
    scale = np.abs(want).max()
    assert np.abs(three - want).max() <= 1e-5 * scale
    assert np.abs(one - want).max() > 1e-3 * scale


def test_fold_plain_ragged_tail_reads_as_dt_zero():
    """s not a multiple of the 64-row tile: the tail reads as dt = 0, and
    y at the true rows equals `ssd_chunked`'s."""
    j, t = _inputs(5, "float32", 2, 100, 2, 8, 1, 16)
    _close(ss.ssd_scan_fold_plain(*t), j_ssd.ssd_chunked(*j, chunk=64)[0],
           "float32")


@pytest.mark.parametrize("b,s,h,g,n,dtype", [
    (2, 4096, 64, 1, 64, torch.bfloat16),     # zamba2-1.2b's prefill
    (2, 4096, 80, 1, 128, torch.bfloat16),    # mamba2-2.7b's
    (3, 700, 6, 3, 64, torch.bfloat16),       # h / g = 2
    (1, 1000, 5, 1, 128, torch.bfloat16),     # h / g odd: a short set
    (1, 2048, 9, 3, 64, torch.bfloat16),      # 3 a group, sets of 2 and 1
    (1, 512, 3, 1, 64, torch.bfloat16),       # one group: the scan alone
    (2, 600, 4, 2, 64, torch.float32),        # float32: a head a block
])
def test_launch_grids_cover_every_head_once(b, s, h, g, n, dtype):
    """The launches' grids on meta tensors (shapes only): launch 1 over
    G - 1 groups, the pass over n p / 256, the scan over G; bf16 blocks
    take sets of `HEADS` (`STATE_HEADS`) heads of one B/C group, a
    group's last set short when they do not divide h / g, so every head
    is taken by exactly one block of each launch, with its own group's B
    and C; the grid's y stays within the card's 65 535."""
    x = torch.empty((b, s, h, 64), dtype=dtype, device="meta")
    B = torch.empty((b, s, g, n), dtype=dtype, device="meta")
    grids = ss.launch_grids(x, B)
    G = ss.n_groups(s)
    names = [name for name, *_ in grids]
    assert names == (["state", "pass", "scan"] if G > 1 else ["scan"])
    assert len(grids) == ss.kernel_launches(s, n)
    for name, (gx, gy, gz), threads, heads in grids:
        assert gz == b and gy <= ss.MAX_GRID_YZ
        assert gx == {"state": G - 1, "pass": n * 64 // 256, "scan": G}[name]
        if name == "pass":
            assert (gy, threads) == (h, 256)
            continue
        if dtype == torch.float32:
            assert (gy, threads, heads) == (h, 256, 1)
            continue
        assert heads == (ss.STATE_HEADS if name == "state" else ss.HEADS)
        assert threads == heads * 128 + (32 if name == "state" else 128)
        taken = [ss.block_heads(h, g, heads, y) for y in range(gy)]
        assert sorted(hd for hs in taken for hd in hs) == list(range(h))
        for hs in taken:
            assert 1 <= len(hs) <= heads
            assert len({hd // (h // g) for hd in hs}) == 1   # one B/C group
            assert hs == list(range(hs[0], hs[0] + len(hs)))


def test_grid_limit_raises_before_a_launch():
    """b or the heads past 65 535 raise before any launch (meta tensors:
    no card, no copy)."""
    for b, h in ((65536, 1), (1, 65536)):
        x = torch.empty((b, 64, h, 64), dtype=torch.bfloat16, device="meta")
        B = torch.empty((b, 64, 1, 64), dtype=torch.bfloat16, device="meta")
        dt = torch.empty((b, 64, h), device="meta")
        with pytest.raises(ValueError, match="grid dimension above 65535"):
            ss._prepare(x, dt, torch.empty(h, device="meta"), B, B)


def test_tma_maps_read_model_views_where_they_lie():
    """The model's x / B / C are views into the conv output (rows
    d_inner + 2 g n wide): their strides and bases sit on 16 bytes, so a
    bf16 call passes them uncopied with their strides; a float32 call,
    an odd row stride or a base off 16 bytes is copied dense.  An axis of
    one reads as dense."""
    b, s, h, g, n = 2, 70, 4, 1, 64
    xbc = torch.zeros((b, s, h * 64 + 2 * g * n), dtype=torch.bfloat16)
    x = xbc[..., :h * 64].reshape(b, s, h, 64)
    B = xbc[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    C = xbc[..., h * 64 + g * n:].reshape(b, s, g, n)
    dt = torch.ones((b, s, h))
    A = -torch.ones(h)
    assert all(ss._tma_ready(t) for t in (x, B, C))
    ins, states, decay = ss._prepare(x, dt, A, B, C, views=True)
    assert [t.data_ptr() for t in (ins[0], ins[3], ins[4])] == \
        [t.data_ptr() for t in (x, B, C)]
    assert states is None and decay is None           # s: one group
    row = h * 64 + 2 * g * n
    assert ss._fwd_args(ins)[9:] == (64, row, s * row, n, row, s * row,
                                     n, row, s * row)
    dense, _, _ = ss._prepare(x, dt, A, B, C)          # the backward's
    assert all(t.is_contiguous() for t in dense)
    f32 = [t.float() if t.dtype == torch.bfloat16 else t
           for t in (x, dt, A, B, C)]
    assert all(t.is_contiguous() for t in ss._prepare(*f32, views=True)[0])
    odd = torch.zeros((b, s, h * 64 + 4), dtype=torch.bfloat16)
    assert not ss._tma_ready(odd[..., :h * 64].reshape(b, s, h, 64))
    assert xbc.data_ptr() % 16 == 0        # 4 elements on: 8 bytes off
    assert not ss._tma_ready(xbc[..., 4:4 + h * 64].reshape(b, s, h, 64))
    off = ss._prepare(xbc[..., 4:4 + h * 64].reshape(b, s, h, 64), dt, A, B,
                      C, views=True)[0]
    assert off[0].is_contiguous() and off[0].data_ptr() % 16 == 0
    one = torch.zeros((1, s, 1, 64), dtype=torch.bfloat16)
    assert ss._strides(one) == (64, 64, s * 64)


def test_kernel_probe_ssd_variant_edits_apply():
    """scripts/kernel_probe.py's `ssd-variants` builds copies of
    csrc/ssd_scan.cu with one switch of the bf16 forward flipped by a text
    edit (levers a-e, expf, the row order, and the diagnostics without
    exps or products), and stops on an edit whose text the source no
    longer holds: every edit applies, and each variant changes the
    source."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        probe = importlib.import_module("kernel_probe")
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    sources = probe.ssd_variant_sources()
    text = (ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan.cu").read_text()
    assert sources["as built"] == text
    for lever in "abcde":
        assert any(name.startswith(lever + ":") for name in sources), lever
    for name in ("no exps (every decay 1)", "no products (no wgmma issued)"):
        assert name in sources
    for name, src in sources.items():
        assert name == "as built" or src != text, name
