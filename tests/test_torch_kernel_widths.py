"""The widths the TPU kernels take and the port's kernels are not built
for: flash attention's narrow heads (Dh 8 to 255 other than 64 / 96 / 128),
the SSD scan's narrow p and n, the day scan's levels past 16.

- The plain versions at the reference's kernel sweep shapes
  (`tests/test_kernels.py`) against the Pallas kernels in interpret mode
  (`repro.kernels.ops`), at the reference's tolerances.
- The CUDA wrappers' zero-padding, forward and backward, with the ctypes
  launch (`_call`) swapped for the plain version at the width it is
  handed: the result equals the plain version at the true width, the
  launch sees the padded width, the scale is the true width's, and the
  padded columns leave ddt and dA of the SSD backward where they were.
- A CUDA-typed call at a narrow width reaches the launch, never the plain
  version.
- `day_scan_plain` at 17 and 32 levels against the Pallas day kernel in
  interpret mode and the reference's scan oracle.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch import convert
from repro_torch.kernels import day_scan as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss

TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PAD_RTOL = 1e-6         # padded launch vs the plain version, float32
# the plain versions, kept before any test swaps them out
PLAIN_FLASH, PLAIN_SSD = fa.flash_attention_plain, ss.ssd_scan_plain

# tests/test_kernels.py's sweeps
FLASH_SWEEP = [
    (1, 128, 2, 2, 32, True, None, 64, 64),
    (2, 256, 4, 2, 64, True, None, 128, 128),
    (1, 256, 4, 1, 64, True, 96, 128, 128),     # GQA 4:1 + window
    (2, 192, 8, 4, 32, False, None, 64, 64),    # bidirectional, ragged S
    (1, 320, 4, 4, 128, True, None, 128, 64),   # uneven blocks, pad path
]
SSD_SWEEP = [
    (1, 128, 2, 8, 1, 16, 64),
    (2, 256, 4, 16, 2, 32, 64),
    (1, 256, 8, 32, 1, 64, 128),
    (2, 128, 4, 8, 4, 16, 32),      # groups == heads/1
]


def _rng(seed):
    return np.random.default_rng(seed)


def _qkv(seed, B, Sq, Sk, H, KvH, Dh, dtype="float32"):
    g = _rng(seed)
    arrs = [g.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, Dh), (B, Sk, KvH, Dh), (B, Sk, KvH, Dh),
                      (B, Sq, H, Dh))]
    return ([jnp.asarray(a).astype(J_DT[dtype]) for a in arrs[:3]],
            [torch.from_numpy(a).to(T_DT[dtype]) for a in arrs])


def _ssd_inputs(seed, b, s, h, p, g, n, dtype="float32", dt_scale=1.0):
    """x, dt, A, B, C as tests/test_kernels.py draws them (numpy here),
    and dy."""
    r = _rng(seed)
    x = 0.5 * r.standard_normal((b, s, h, p))
    dt = dt_scale * np.log1p(np.exp(r.standard_normal((b, s, h))))
    A = -np.exp(0.3 * r.standard_normal(h))
    B = 0.3 * r.standard_normal((b, s, g, n))
    C = 0.3 * r.standard_normal((b, s, g, n))
    dy = r.standard_normal((b, s, h, p))
    arrs = [a.astype(np.float32) for a in (x, dt, A, B, C, dy)]
    low = (True, False, False, True, True, True)
    j = [jnp.asarray(a).astype(J_DT[dtype]) if lo else jnp.asarray(a)
         for a, lo in zip(arrs[:5], low)]
    t = [torch.from_numpy(a).to(T_DT[dtype]) if lo else torch.from_numpy(a)
         for a, lo in zip(arrs, low)]
    return j, t


# ---------------------------------------------------------------------------
# the plain versions at the reference's sweep shapes vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KvH,Dh,causal,window,bq,bk", FLASH_SWEEP)
def test_flash_plain_matches_pallas_at_the_sweep(dtype, B, S, H, KvH, Dh,
                                                 causal, window, bq, bk):
    (jq, jk, jv), (tq, tk, tv, _) = _qkv(S + Dh, B, S, S, H, KvH, Dh, dtype)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SWEEP)
def test_ssd_plain_matches_pallas_at_the_sweep(dtype, b, s, h, p, g, n,
                                               chunk):
    j, t = _ssd_inputs(s + p + n, b, s, h, p, g, n, dtype)
    got = ss.ssd_scan(*t[:5], chunk=chunk)
    want = ops.ssd_scan(*j, chunk=chunk)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=max(tol, 1e-4), rtol=5 * tol)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.ssd_scan_ref(*j), np.float32),
                               atol=max(tol, 1e-4), rtol=5 * tol)


# ---------------------------------------------------------------------------
# the wrappers' padding, with the launch swapped for the plain version
# ---------------------------------------------------------------------------

def _rel_close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= PAD_RTOL * scale, (what, err, scale)


def _flash_launches(monkeypatch, seen, plain=PLAIN_FLASH,
                    lse_plain=fa.flash_attention_lse_plain,
                    bwd_plain=fa.flash_attention_bwd_plain):
    """Swap flash's ctypes launch for the plain versions at the width the
    launch is handed, recording (entry, Dh, scale) of every launch."""
    monkeypatch.setattr(fa, "_lib", lambda: "forward")
    monkeypatch.setattr(fa, "_bwd_lib", lambda: "backward")

    def call(fn, tensors, args, what):
        B, Sq, Sk, H, KvH, Dh, causal, window, scale, _ = args
        seen.append((fn, Dh, scale))
        mask = dict(causal=bool(causal),
                    window=None if window < 0 else window, scale=scale)
        ts = [None if t is None else t.as_subclass(torch.Tensor)
              for t in tensors]
        if fn == "forward":
            q, k, v, out, lse = ts
            assert q.shape[3] == Dh
            out.copy_(plain(q, k, v, **mask))
            if lse is not None:
                lse.copy_(lse_plain(q, k, **mask))
            return
        q, k, v, o, do, lse, _, dq, dk, dv = ts
        for d, w in zip((dq, dk, dv), bwd_plain(q, k, v, o, do, lse,
                                                **mask)):
            d.copy_(w)

    monkeypatch.setattr(fa, "_call", call)


@pytest.mark.parametrize("Dh,width", [(8, 64), (16, 64), (32, 64), (40, 64),
                                      (80, 96), (100, 128), (200, 256)])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,causal,window", [
    (2, 70, 70, 4, 2, True, None),
    (1, 50, 90, 2, 1, False, None),
    (1, 80, 80, 2, 2, True, 24),
])
def test_flash_padding_forward_and_backward(monkeypatch, Dh, width, B, Sq,
                                            Sk, H, KvH, causal, window):
    """`FlashAttention` (the card's route when autograd needs a gradient)
    at a width the kernels are not built for: the launches see the padded
    width and the true width's scale; o equals the plain version at the
    true width and dq, dk, dv the plain backward there.  `width` is the
    bf16 kernels'; these float32 inputs pad to their dtype's width, the
    same but for 80, which runs at 128 (float32 builds no 96)."""
    seen = []
    _flash_launches(monkeypatch, seen)
    _, (q, k, v, do) = _qkv(Dh + Sq, B, Sq, Sk, H, KvH, Dh)
    do = do[:, :Sq]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    o = fa.FlashAttention.apply(*leaves, causal, window, None)
    o.backward(do)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    assert fa.kernel_width(Dh, torch.bfloat16) == width
    f32_width = fa.kernel_width(Dh, torch.float32)
    assert f32_width == (128 if width == 96 else width)
    assert [(fn, d) for fn, d, _ in seen] == [("forward", f32_width),
                                             ("backward", f32_width)]
    assert all(s == 1.0 / math.sqrt(Dh) for _, _, s in seen)
    mask = dict(causal=causal, window=window)
    want = PLAIN_FLASH(q, k, v, **mask)
    grads = fa.flash_attention_bwd_plain(
        q, k, v, want, do, fa.flash_attention_lse_plain(q, k, **mask),
        **mask)
    assert o.shape == want.shape and o.is_contiguous()
    _rel_close(o.detach(), want, "o")
    for name, a, w in zip("qkv", leaves, grads):
        assert a.grad.shape == w.shape
        _rel_close(a.grad, w, "d" + name)


def test_flash_built_widths_launch_unpadded(monkeypatch):
    """At a width the kernels of a dtype are built for the launch takes
    the inputs as they are: no copy, the caller's scale (bf16
    `HEAD_DIMS`, float32 every multiple of `WIDE_SLICE`).  A float32 head
    96 wide, which float32 does not build, launches zero-padded to 128
    with the caller's scale and equals the plain version at 96."""
    seen = []
    _flash_launches(monkeypatch, seen)
    for dtype, widths in (("bfloat16", fa.HEAD_DIMS),
                          ("float32", (64, 128, 192, 256))):
        for Dh in widths:
            _, (q, k, v, _) = _qkv(Dh, 1, 20, 20, 2, 2, Dh, dtype)
            out = fa._flash_cuda(q, k, v, scale=0.25)
            assert seen[-1] == ("forward", Dh, 0.25)
            torch.testing.assert_close(out, fa.flash_attention_plain(
                q, k, v, scale=0.25), rtol=0, atol=0)
    _, (q, k, v, _) = _qkv(96, 1, 20, 20, 2, 2, 96)
    out = fa._flash_cuda(q, k, v, scale=0.25)
    assert seen[-1] == ("forward", 128, 0.25) and out.shape == q.shape
    _rel_close(out, fa.flash_attention_plain(q, k, v, scale=0.25), "Dh 96")


def _ssd_launches(monkeypatch, seen, plain=PLAIN_SSD,
                  states_plain=ss.ssd_split_states_plain,
                  bwd_plain=ss.ssd_scan_bwd_fold_plain):
    """Swap the SSD's ctypes launch for the plain versions at the widths
    and tile the launch is handed (float32), recording (entry, p, n)."""
    monkeypatch.setattr(ss, "_lib", lambda entry="ssd_scan_launch": entry)
    monkeypatch.setattr(ss, "_bwd_lib", lambda: "ssd_scan_bwd_launch")

    def call(fn, tensors, d, what):
        ts = [None if t is None else t.as_subclass(torch.Tensor)
              for t in tensors]
        b, s, h, p, g, n, tile, group, _, *strides = d
        assert len(strides) == (9 if fn == "ssd_scan_launch" else 12)
        seen.append((fn, p, n))
        if fn == "ssd_scan_launch":
            x, dt, A, B, C, y, st, _ = ts
            assert (x.shape[3], B.shape[3]) == (p, n)
            y.copy_(plain(x, dt, A, B, C, chunk=tile))
            if st is not None:
                st.copy_(states_plain(x, dt, A, B, C, chunk=tile,
                                      group=group).permute(0, 2, 1, 4, 3))
            return
        x, dt, A, B, C, dy, st, *_, dx, ddt, dBp, dCp, dAp = ts
        grads = bwd_plain(x, dt, A, B, C, dy, st, chunk=tile, group=group)
        dx.copy_(grads[0])
        ddt.copy_(grads[1])
        dAp.zero_()
        dAp[0, :, 0] = grads[2]
        for rows, d_ in ((dBp, grads[3]), (dCp, grads[4])):
            rows.zero_()
            rows.view(b, s, g, h // g, n)[:, :, :, 0] = d_

    monkeypatch.setattr(ss, "_call", call)


@pytest.mark.parametrize("p,n,width", [(8, 16, (64, 64)),
                                       (16, 16, (64, 64)),
                                       (32, 64, (64, 64)),
                                       (64, 32, (64, 64)),
                                       (24, 100, (64, 128))])
@pytest.mark.parametrize("b,s,h,g", [(1, 70, 2, 1), (2, 600, 4, 2)])
def test_ssd_padding_forward_and_backward(monkeypatch, p, n, width, b, s, h,
                                          g):
    """`SSDScan` (the card's route when autograd needs a gradient) at
    widths the kernels are not built for: the launches see the padded
    widths, the group states are kept padded, y equals the plain version
    at the true widths and every gradient the plain backward there (the
    kernel's mirror, `ssd_scan_bwd_fold_plain`)."""
    seen = []
    _ssd_launches(monkeypatch, seen)
    _, t = _ssd_inputs(s + p + n, b, s, h, p, g, n, dt_scale=0.05)
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    y = ss.SSDScan.apply(*leaves)
    y.backward(t[5])
    assert ss.LAUNCHES - f0 == ss.kernel_launches(s)
    assert ss.BWD_LAUNCHES - b0 == 1
    assert [(fn, pp, nn) for fn, pp, nn in seen] == [
        ("ssd_scan_launch", *width), ("ssd_scan_bwd_launch", *width)]
    want = PLAIN_SSD(*t[:5], chunk=ss.TILE)
    grads = ss.ssd_scan_bwd_fold_plain(*t, chunk=ss.TILE)
    assert y.shape == want.shape and y.is_contiguous()
    _rel_close(y.detach(), want, "y")
    for name, a, w in zip(("x", "dt", "A", "B", "C"), leaves, grads):
        assert a.grad.shape == w.shape, name
        _rel_close(a.grad, w, "d" + name)


def test_ssd_padded_columns_leave_ddt_and_da_unmoved(monkeypatch):
    """ddt and dA of a padded backward are the true widths' bit for bit:
    the padded columns of x, B, C and dy are exact zeros and add
    nothing."""
    seen = []
    _ssd_launches(monkeypatch, seen)
    b, s, h, p, g, n = 1, 600, 4, 16, 1, 16
    _, t = _ssd_inputs(5, b, s, h, p, g, n, dt_scale=0.05)
    y, states = ss._ssd_cuda(*t[:5], states=True)
    assert tuple(states.shape) == (b, h, ss.n_groups(s), 64, 64)
    assert not states[:, :, :, n:].any() and not states[..., p:].any()
    got = ss._ssd_bwd_cuda(*t[:5], t[5], states)
    x, dt, A, B, C, dy = t
    want = ss.ssd_scan_bwd_fold_plain(
        ss._pad_cols(x, 64), dt, A, ss._pad_cols(B, 64), ss._pad_cols(C, 64),
        ss._pad_cols(dy, 64), states, chunk=ss.TILE)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)   # ddt
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)   # dA
    unpadded = ss.ssd_scan_bwd_fold_plain(*t[:5], t[5], chunk=ss.TILE)
    for k in (1, 2):
        _rel_close(got[k], unpadded[k], ("ddt", "dA")[k - 1])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the dispatch's
    card route on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_narrow_widths_on_the_card_route_never_reach_plain(monkeypatch):
    """A CUDA-typed call at a narrow width goes to the launch (counted),
    padded, and never to the plain version."""
    seen = []
    _flash_launches(monkeypatch, seen)
    _ssd_launches(monkeypatch, seen)

    def refuse(*a, **kw):
        raise AssertionError("the card route reached the plain version")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    monkeypatch.setattr(ss, "ssd_scan_plain", refuse)
    for Dh in (8, 16, 32):
        _, (q, k, v, _) = _qkv(Dh, 1, 40, 40, 4, 2, Dh)
        want = PLAIN_FLASH(q, k, v, causal=True)
        before = fa.LAUNCHES
        got = fa.flash_attention(*(t.as_subclass(_OnCard)
                                   for t in (q, k, v)), causal=True)
        assert fa.LAUNCHES == before + 1 and seen[-1][:2] == ("forward", 64)
        _rel_close(got.as_subclass(torch.Tensor), want, f"Dh {Dh}")
    for p, n in ((8, 16), (16, 16), (32, 32)):
        _, t = _ssd_inputs(p + n, 1, 100, 2, p, 1, n)
        want = PLAIN_SSD(*t[:5], chunk=ss.TILE)
        before = ss.LAUNCHES
        got = ss.ssd_scan(*(x.as_subclass(_OnCard) for x in t[:5]))
        assert ss.LAUNCHES == before + 1
        assert seen[-1] == ("ssd_scan_launch", 64, 64)
        _rel_close(got.as_subclass(torch.Tensor), want, f"p {p} n {n}")


def test_plain_backward_in_float64():
    """`ssd_scan_bwd_plain` on float64 inputs, the exact reference of the
    card's float32 check: every gradient in float64, within the float32
    check's 1e-5 of the float32 run's largest magnitude."""
    _, t = _ssd_inputs(3, 2, 256, 4, 16, 2, 32)
    lo = ss.ssd_scan_bwd_plain(*t)
    hi = ss.ssd_scan_bwd_plain(*(x.double() for x in t))
    assert [g.dtype for g in hi] == [torch.float64] * 5
    for a, w in zip(lo, hi):
        assert float((a.double() - w.double()).abs().max()) <= \
            1e-5 * float(w.abs().max())


def test_refusals_name_the_limit_and_the_roadmap_item():
    """No width the TPU kernels take is refused: Dh 257 / 512 get their
    padded widths (the wide kernels), p 65 / 128 and n 129 / 256 their
    blocks; only what the card cannot launch raises, a grid dimension
    above 65 535, and the message names that limit."""
    bf, f32 = torch.bfloat16, torch.float32
    assert (fa.kernel_width(257, bf), fa.kernel_width(512, bf)) == (320, 512)
    assert (ss.kernel_widths(65, 64), ss.kernel_widths(128, 64)) == \
        ((128, 64), (128, 64))
    assert (ss.kernel_widths(64, 129), ss.kernel_widths(64, 256)) == \
        ((64, 192), (64, 256))
    assert [fa.kernel_width(d, bf) for d in (1, 64, 65, 96, 97, 129, 256)] \
        == [64, 64, 96, 96, 128, 256, 256]
    # float32's kernels take every multiple of 64
    assert [fa.kernel_width(d, f32)
            for d in (1, 64, 65, 96, 97, 129, 192, 193, 257)] == \
        [64, 64, 128, 128, 128, 192, 192, 256, 320]
    assert [ss.kernel_widths(p, n) for p, n in ((1, 1), (64, 64),
                                                (64, 65), (8, 128))] == \
        [(64, 64), (64, 64), (64, 128), (64, 128)]
    limit = f"grid dimension above {fa.MAX_GRID_YZ}"
    many = torch.zeros(1, 1, 1, 512).expand(fa.MAX_GRID_YZ + 1, 1, 2, 512)
    with pytest.raises(ValueError, match=limit):
        fa._kernel_args(None, None, 512, many, many, many)
    heads = torch.zeros(1, 1, 1, 1).expand(1, 1, ss.MAX_GRID_YZ // 2 + 1,
                                           128)
    dt = torch.zeros(1, 1, 1).expand(1, 1, heads.shape[2])
    B = torch.zeros(1, 1, 1, 16)
    with pytest.raises(ValueError, match=limit):   # p-blocks are heads
        ss._ssd_cuda(heads, dt, dt[0, 0], B, B)
    assert ds.LEVELS_READ == 3


# ---------------------------------------------------------------------------
# the day scan past 16 levels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[17, 32])
def many_levels(request):
    """The reference's day fixture (tests/test_kernels.py) with a throttle
    policy of L - 1 seeded actions beside "none" and "thermal_governor":
    tables of L levels."""
    from repro.core import daysim
    n_lvl = request.param
    r = _rng(n_lvl)
    actions = tuple(daysim.ThrottleAction(
        fps_mult=float(r.uniform(1.0, 4.0)),
        duty_mult=float(r.uniform(0.3, 1.0)),
        brightness_mult=float(r.uniform(0.3, 1.0)),
        active_mult=float(r.uniform(0.3, 1.0)),
        offload=bool(r.integers(0, 2))) for _ in range(n_lvl - 1))
    gov = daysim.get_policy("thermal_governor")
    pol = dataclasses.replace(gov, name=f"levels{n_lvl}", actions=actions)
    combos, _ = daysim.build_combos(
        platforms=("aria2_display", "aria2_puck_split"),
        designs=({"name": "hot", "on_device": ("slam", "asr"),
                  "compression": 10.0},
                 {"name": "lean", "on_device": ()}),
        schedules=("commuter",),
        policies=("none", "thermal_governor", pol))
    tables = daysim.batch_tables(combos, dt_s=60.0)
    assert np.asarray(tables["step_mw"]).shape[-1] == n_lvl
    return n_lvl, tables


@pytest.mark.parametrize("oracle", ["pallas_interpret", "scan_ref"])
def test_day_scan_plain_past_16_levels(many_levels, oracle):
    """Throttle level and shutdown latch exact, traces within rtol 1e-6 /
    atol 1e-4 (tests/test_kernels.py), at L = 17 and 32."""
    from repro.kernels.day_scan import day_scan as pallas_day_scan
    n_lvl, tables = many_levels
    port = convert.tables_from_numpy(tables, device="cpu")
    assert ds._shape(port)[2] == n_lvl
    got = ds.day_scan(port)
    if oracle == "pallas_interpret":
        want = pallas_day_scan(tables, chunk=128, interpret=True)
    else:
        want = ref.day_scan_ref(tables)
    assert int(got["level"].max()) >= 1
    np.testing.assert_array_equal(got["level"].numpy(),
                                  np.asarray(want["level"]))
    np.testing.assert_array_equal(got["shut"].numpy(),
                                  np.asarray(want["shut"]))
    for k in ("soc", "soc_p", "pods", "t_skin", "t_skin_p", "drain_mw",
              "drain_p_mw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-4, err_msg=k)


def test_day_scan_staged_split_past_16_levels(many_levels):
    """The kernel's split (`day_scan_staged_plain`) stays bit-equal to the
    plain version at L = 17 and 32, both output modes."""
    _, tables = many_levels
    port = convert.tables_from_numpy(tables, device="cpu")
    for full in (False, True):
        got = ds.day_scan_staged_plain(port, 7, full=full)
        want = ds.day_scan_plain(port, full=full)
        for k in want:
            assert torch.equal(got[k], want[k]), (full, k)
