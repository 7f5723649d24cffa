"""The widths above the ones the port's kernels are built for, which the
TPU kernels take: flash attention at any head width past 256, the SSD scan
at any p past 64 and any n past 128.

- The plain flash forward at Dh 320 and 512 against the Pallas kernel in
  interpret mode (`repro.kernels.ops`), at the reference's tolerances
  (`tests/test_kernels.py`: float32 2e-5, bf16 2e-2); its plain backward
  against `jax.grad` of `ref.flash_attention_ref`, on the wide kernels'
  tiles (64 x 64 in both dtypes, pinned); the plain forward on the wide
  forward's tile (128 x 64, the bf16 built widths') against the Pallas
  kernel at Dh 320, 512 and 576, and the wrapper's grid check at that
  tile in both dtypes.
- The SSD's block decomposition (`ssd_blocked` / `ssd_blocked_bwd`, what
  the card runs, handed the plain version for its blocks) against the
  Pallas kernel, against `jax.grad` of `repro.nn.ssd.ssd_chunked` and, in
  float32, against the plain backward run in float64.
- gemma3-4b's smoke config with heads 320 wide and mamba2-2.7b's with the
  SSD at p 128 / n 256, derived alike in both packages: prefill logits.
- The wrappers' card route with the ctypes launch swapped for the plain
  version at the width it is handed (`tests/test_torch_kernel_widths.py`'s
  helpers): a wide call reaches the launch, counted, at the padded head
  or in the SSD's blocks, and never the plain version (Dh 2100, padded
  to 2112: nine column blocks, past a cluster); the backward's column
  blocks and scratch in both dtypes (totals past Dh 2048 in bf16, past
  Dh 512 in float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.launch import steps as j_steps
from repro.models import registry as j_reg
from repro.nn import ssd as j_ssd
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import steps as t_steps
from repro_torch.nn import attention as attn
from repro_torch.models import registry as t_reg
from test_torch_kernel_widths import (PLAIN_FLASH, PLAIN_SSD, _flash_launches,
                                      _OnCard, _qkv, _rel_close,
                                      _ssd_inputs, _ssd_launches)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # tests/test_kernels.py
REL = 1e-5          # float32 gradients, of the largest magnitude

# (B, Sq, Sk, H, KvH, Dh, causal, window): causal GQA, a window,
# bidirectional at a ragged S, Sq != Sk, a ragged causal S; Dh 320 ends in
# a 64-wide column block of the wide kernels, 512 in two full ones
FLASH_CASES = [
    (1, 128, 128, 4, 2, 320, True, None),
    (1, 128, 128, 2, 2, 320, True, 48),
    (2, 96, 96, 2, 2, 512, False, None),
    (1, 80, 144, 4, 2, 512, False, None),
    (1, 100, 100, 2, 1, 512, True, None),
]
# (p, n): p in two blocks of 64, p padded to two blocks, n in two blocks of
# 128, n in a block of 128 and one of 64
SSD_WIDTHS = [(128, 128), (80, 64), (64, 256), (128, 192)]


def _plain_block(x, dt, A, B, C, f32):
    """One block of the decomposition by the plain version, y in float32
    (the bf16 kernel's products are exact in float32)."""
    return ss.ssd_scan_plain(x.float(), dt, A, B.float(), C.float()), None


def _plain_block_bwd(x, dt, A, B, C, dy, j, f32):
    return ss.ssd_scan_bwd_plain(x, dt, A, B, C, dy)


# ---------------------------------------------------------------------------
# flash attention past Dh 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas_past_256(dtype, B, Sq, Sk, H, KvH, Dh,
                                             causal, window):
    (jq, jk, jv), (tq, tk, tv, _) = _qkv(Sq + Dh, B, Sq, Sk, H, KvH, Dh,
                                         dtype)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_k=64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_grad_past_256(B, Sq, Sk, H, KvH, Dh,
                                                   causal, window):
    """`flash_attention_bwd_plain` on the wide kernels' tiles against
    `jax.grad` of the reference's attention, float32."""
    (jq, jk, jv), (q, k, v, do) = _qkv(Sq + Dh + 1, B, Sq, Sk, H, KvH, Dh)
    w = jnp.asarray(do.numpy())

    def loss(q_, k_, v_):
        return jnp.sum(ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                               window=window) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    mask = dict(causal=causal, window=window)
    got = fa.flash_attention_bwd_plain(
        q, k, v, PLAIN_FLASH(q, k, v, **mask), do,
        fa.flash_attention_lse_plain(q, k, **mask), **mask)
    assert fa.BWD_TILES[torch.float32]["wide"] == (64, 64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", FLASH_CASES)
def test_flash_bwd_plain_on_the_bf16_wide_tiles_matches_jax_grad(
        monkeypatch, B, Sq, Sk, H, KvH, Dh, causal, window):
    """The bf16 wide backward's tiles are 64 x 64 (the tensor-core
    kernel's, as at the built widths): `flash_attention_bwd_plain`'s
    recurrence on them, run in float32, against `jax.grad` of the
    reference's attention at the float32 tolerance; and its bf16 run
    (P and dS rounded once) against `jax.grad` of the same bf16 inputs
    within one bf16 spacing of the largest gradient."""
    assert fa.BWD_TILES[torch.bfloat16]["wide"] == (64, 64)
    (jq, jk, jv), (q, k, v, do) = _qkv(Sq + Dh + 2, B, Sq, Sk, H, KvH, Dh)
    mask = dict(causal=causal, window=window)

    def grads(q, k, v, do):
        return fa.flash_attention_bwd_plain(
            q, k, v, PLAIN_FLASH(q, k, v, **mask), do,
            fa.flash_attention_lse_plain(q, k, **mask), **mask)

    def jax_grads(q, k, v, do):
        w = jnp.asarray(do.float().numpy())

        def loss(q_, k_, v_):
            return jnp.sum(ref.flash_attention_ref(q_, k_, v_, **mask) * w)
        return jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))

    monkeypatch.setitem(fa.BWD_TILES[torch.float32], "wide",
                        fa.BWD_TILES[torch.bfloat16]["wide"])
    for name, a, b in zip(("dq", "dk", "dv"), grads(q, k, v, do),
                          jax_grads(q, k, v, do)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * float(np.abs(b).max()),
                                   err_msg=name)
    low = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    for name, a, b in zip(("dq", "dk", "dv"), grads(*low), jax_grads(*low)):
        b = np.asarray(b, np.float32)
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=2.0 ** -6 * float(np.abs(b).max()),
                                   err_msg=name)


# the bf16 wide forward's shapes (B, Sq, Sk, H, KvH, Dh, causal, window):
# causal GQA, windowed, three column blocks; each spans more than one of
# its 128-row query tiles and 64-key tiles
WIDE_FWD_CASES = [
    (1, 200, 200, 4, 2, 320, True, None),
    (1, 200, 200, 4, 2, 512, True, 70),
    (1, 150, 150, 2, 1, 576, True, None),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", WIDE_FWD_CASES)
def test_flash_plain_on_the_bf16_wide_tiles_matches_pallas(B, Sq, Sk, H,
                                                           KvH, Dh, causal,
                                                           window):
    """The bf16 wide forward keeps the built widths' tile (`TILES`: 128
    query rows, two warpgroups of 64, by 64 keys).  The plain forward on
    that tile (`chunked_attention`, bf16 inputs, p rounded to v's dtype
    before its product, l from the unrounded p, as the kernel) against
    the Pallas kernel in interpret mode on the same bf16 inputs, at the
    reference's bf16 tolerance (2e-2, `tests/test_kernels.py`)."""
    bq, bk = fa.fwd_tile(Dh, torch.bfloat16)
    assert (bq, bk) == (128, 64) == fa.TILES[torch.bfloat16]["wide"]
    (jq, jk, jv), (tq, tk, tv, _) = _qkv(Sq + Dh + 3, B, Sq, Sk, H, KvH, Dh,
                                         "bfloat16")
    got = attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 chunk_q=bq, chunk_k=bk)
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("Dh", [320, 2100])
def test_wide_bf16_forward_grid_check_at_its_tile(Dh):
    """The wide forward's query tiles (`TILES`' 128 rows, both
    dtypes) lie on a grid axis of at most `MAX_GRID_YZ` (its column blocks
    ride with the (batch, head) pairs on the other): an Sq of exactly that
    many tiles passes the wrapper's check, one row more raises before any
    launch, at column blocks a cluster holds and past them (Dh 2100 ->
    2112: nine bf16 blocks, 33 float32 ones).  The float32 kernel at a
    built width (the same kernel since it runs on the tensor cores) puts
    its 128-row query tiles on that axis too: the same limit there.  Meta
    tensors: nothing is allocated."""
    width = fa.kernel_width(Dh, torch.bfloat16)
    assert fa.kernel_width(Dh, torch.float32) == width
    assert fa.wide_bwd_blocks(width) == (2 if Dh == 320 else 9)
    assert fa.wide_f32_blocks(width) == width // 64
    assert fa.wide_f32_blocks(width, forward=True) == (3 if Dh == 320 else 17)

    def q(rows, dtype, d=Dh):
        return torch.empty((1, rows, 1, d), dtype=dtype, device="meta")
    for dtype in (torch.bfloat16, torch.float32):
        bq = fa.fwd_tile(Dh, dtype)[0]
        assert bq == 128
        scale, (padded,) = fa._kernel_args(None, None, Dh,
                                           q(fa.MAX_GRID_YZ * bq, dtype))
        assert padded.shape[3] == width and scale == 1.0 / np.sqrt(Dh)
        with pytest.raises(ValueError, match="grid dimension above 65535"):
            fa._kernel_args(None, None, Dh, q(fa.MAX_GRID_YZ * bq + 1, dtype))
    fa._kernel_args(None, None, 256,
                    q(fa.MAX_GRID_YZ * 128, torch.float32, 256))
    with pytest.raises(ValueError, match="grid dimension above 65535"):
        fa._kernel_args(None, None, 256,
                        q(fa.MAX_GRID_YZ * 128 + 1, torch.float32, 256))


# ---------------------------------------------------------------------------
# the SSD's block decomposition past p 64 and n 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n", SSD_WIDTHS)
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_blocks_match_pallas(dtype, p, n, g):
    """y from the blocks (p-blocks as heads, n-blocks summed in float32)
    against the Pallas kernel and the sequential oracle."""
    j, t = _ssd_inputs(p + n + g, 1, 128, 4, p, g, n, dtype)
    got, _ = ss.ssd_blocked(*t[:5], _plain_block)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    tol = TOL[dtype]
    for want in (ops.ssd_scan(*j, chunk=64), ref.ssd_scan_ref(*j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=max(tol, 1e-4), rtol=5 * tol)


@pytest.mark.parametrize("p,n", SSD_WIDTHS)
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_blocks_grads_match_jax(p, n, g):
    """At a ragged s (100: the tail reads as dt = 0), y and every gradient
    of the blocks (`ssd_blocked_bwd`: dx, ddt, dA summed over the n-blocks
    and ddt, dA over each head's p-blocks, dB / dC side by side) against
    `ssd_chunked` and its `jax.grad`, float32, dt at a quarter scale (the
    reference's gradient overflows on fast decays)."""
    j, t = _ssd_inputs(p * n + g, 2, 100, 4, p, g, n, dt_scale=0.25)
    y, _ = ss.ssd_blocked(*t[:5], _plain_block)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(j_ssd.ssd_chunked(*j, chunk=64)[0]), rtol=0,
        atol=REL * float(y.abs().max()))
    w = jnp.asarray(t[5].numpy())

    def loss(*a):
        return jnp.sum(j_ssd.ssd_chunked(*a, chunk=64)[0] * w)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*j)
    got = ss.ssd_blocked_bwd(*t, _plain_block_bwd)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("p,n", SSD_WIDTHS)
def test_ssd_blocks_float32_backward_vs_float64(p, n):
    """The blocks' float32 backward against the plain backward run whole
    in float64 (the exact reference of the card's float32 check) over more
    than one group: within 1e-5 of each gradient's largest magnitude.  dt
    x 0.05 as the card's phase 33 a draws it (the state carried between
    groups counts); at dt x 1 the float32 plain version's own dA, blocked
    or whole, is up to 6e-5 of its largest magnitude off float64 on these
    inputs (a sum of terms that cancel)."""
    _, t = _ssd_inputs(p + 2 * n, 1, 600, 2, p, 1, n, dt_scale=0.05)
    got = ss.ssd_blocked_bwd(*t, _plain_block_bwd)
    want = ss.ssd_scan_bwd_plain(*(x.double() for x in t))
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert float((a.double() - w).abs().max()) <= \
            REL * float(w.abs().max())


def test_state_blocks_and_launch_counts():
    assert ss.state_blocks(16) == [(0, 16, 64)]
    assert ss.state_blocks(128) == [(0, 128, 128)]
    assert ss.state_blocks(129) == [(0, 128, 128), (128, 129, 64)]
    assert ss.state_blocks(256) == [(0, 128, 128), (128, 256, 128)]
    assert ss.state_blocks(300) == [(0, 128, 128), (128, 256, 128),
                                    (256, 300, 64)]
    assert [ss.kernel_launches(s, n) for s, n in
            ((512, 64), (513, 64), (512, 256), (513, 256), (100, 300))] == \
        [1, 3, 2, 6, 3]


# ---------------------------------------------------------------------------
# the derived smoke configs through the models
# ---------------------------------------------------------------------------

def _derive(arch, cfg):
    """Phase 33 b's configs (chip_smoke.py), in either package."""
    if arch == "gemma3-4b":
        return dataclasses.replace(cfg, head_dim=320)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=128, d_state=256))


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-2.7b"])
def test_derived_configs_prefill_matches_reference(arch):
    jcfg, jmodel = j_reg.get(arch, smoke=True)
    tcfg, tmodel = t_reg.get(arch, smoke=True)
    jcfg, tcfg = _derive(arch, jcfg), _derive(arch, tcfg)
    assert (tcfg.head_dim, tcfg.ssm and (tcfg.ssm.head_dim,
                                         tcfg.ssm.d_state)) == \
        ((320, None) if arch == "gemma3-4b" else (1, (128, 256)))
    tree = convert.lm_params_numpy(tcfg, seed=3)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 40))
    hj, _ = j_steps.make_prefill_step(jcfg, jmodel, None)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    ht, _ = t_steps.make_prefill_step(tcfg, tmodel)(
        convert.lm_params_from_numpy(tree, tcfg, device="cpu"),
        {"tokens": torch.as_tensor(toks)})
    hj = np.asarray(hj, np.float32)
    assert tuple(ht.shape) == hj.shape
    np.testing.assert_allclose(ht.float().numpy(), hj, rtol=0,
                               atol=1e-5 * float(np.abs(hj).max()))


# ---------------------------------------------------------------------------
# the card route, the launch swapped for the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Dh,width", [(257, 320), (320, 320), (512, 512),
                                      (600, 640), (2100, 2112)])
def test_wide_flash_on_the_card_route(monkeypatch, Dh, width):
    """A CUDA-typed call past Dh 256 launches the wide path at the head
    padded to a multiple of 64 with the true width's scale, forward and
    backward, counted, and never reaches the plain version; o and the
    gradients equal the plain version's at the true width."""
    seen = []
    _flash_launches(monkeypatch, seen)
    leaves = _qkv(Dh, 1, 70, 70, 4, 2, Dh)[1]
    q, k, v, do = leaves
    mask = dict(causal=True, window=24)
    want = PLAIN_FLASH(q, k, v, **mask)
    grads = fa.flash_attention_bwd_plain(
        q, k, v, want, do, fa.flash_attention_lse_plain(q, k, **mask),
        **mask)

    def refuse(*a, **kw):
        raise AssertionError("the card route reached the plain version")
    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    before = fa.LAUNCHES
    with torch.no_grad():
        got = fa.flash_attention(*(t.as_subclass(_OnCard)
                                   for t in (q, k, v)), **mask)
    assert fa.LAUNCHES == before + 1
    assert seen[-1][:2] == ("forward", width)
    _rel_close(got.as_subclass(torch.Tensor), want, f"Dh {Dh}")
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    fa.FlashAttention.apply(*qkv, True, 24, None).backward(do)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    assert [(fn, d) for fn, d, _ in seen[-2:]] == [("forward", width),
                                                  ("backward", width)]
    assert all(s == 1.0 / np.sqrt(Dh) for _, _, s in seen)
    for name, a, w in zip("qkv", qkv, grads):
        assert a.grad.shape == w.shape
        _rel_close(a.grad, w, "d" + name)


@pytest.mark.parametrize("Dh,width,blocks", [(320, 320, 2), (512, 512, 2),
                                             (576, 576, 3), (2048, 2048, 8),
                                             (2100, 2112, 9)])
def test_wide_bf16_bwd_blocks_and_scratch_on_the_card_route(monkeypatch, Dh,
                                                            width, blocks):
    """The bf16 backward past Dh 256 runs clusters of `wide_bwd_blocks`
    column blocks (up to 4 chunks of 64 columns each, at most 8 a
    cluster); the wrapper hands the launch its scratch: each row's delta,
    and past 8 blocks (Dh > 2048, the passes) float32 S and dP totals of
    every pair of 64-row tiles, zeroed.  The gradients are the plain
    version's at the true width, within a bf16 spacing (the padded
    width's sums may round on the other side)."""
    seen = []

    def call(fn, tensors, args, what):
        q, k, v, o, do, lse, scratch, dq, dk, dv = tensors
        _, _, _, _, _, Dh_k, causal, window, scale, dtype = args
        seen.append((fn, Dh_k, dtype, scratch.clone()))
        for d, w in zip((dq, dk, dv), fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=bool(causal),
                window=None if window < 0 else window, scale=scale)):
            d.copy_(w)

    monkeypatch.setattr(fa, "_bwd_lib", lambda: "backward")
    monkeypatch.setattr(fa, "_call", call)
    B, Sq, Sk, H, KvH = 1, 70, 90, 4, 2
    q, k, v, do = (t.to(torch.bfloat16)
                   for t in _qkv(Dh, B, Sq, Sk, H, KvH, Dh)[1])
    mask = dict(causal=False, window=None)
    o = PLAIN_FLASH(q, k, v, **mask)
    lse = fa.flash_attention_lse_plain(q, k, **mask)
    before = fa.BWD_LAUNCHES
    got = fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)
    assert fa.BWD_LAUNCHES == before + 1
    fn, Dh_k, dtype, scratch = seen[-1]
    assert (fn, Dh_k, dtype) == ("backward", width, 1)
    assert fa.kernel_width(Dh, torch.bfloat16) == width
    assert fa.wide_bwd_blocks(width) == blocks
    totals = B * H * 2 * 2 * 2 * 64 * 64 if blocks > fa.WIDE_BWD_CLUSTER \
        else 0
    assert scratch.dtype == torch.float32
    assert scratch.numel() == B * H * Sq + totals
    assert fa.bwd_scratch_floats(B, Sq, Sk, H, width, torch.bfloat16) == \
        scratch.numel()
    if totals:
        assert not bool(scratch.any())
    for a, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                      **mask)):
        assert a.shape == w.shape and a.dtype == torch.bfloat16
        a, w = a.float(), w.float()
        assert float((a - w).abs().max()) <= 2.0 ** -7 * float(w.abs().max())


@pytest.mark.parametrize("Dh,width,blocks", [(257, 320, 5), (512, 512, 8),
                                             (576, 576, 9), (2100, 2112, 33)])
def test_wide_f32_bwd_blocks_and_scratch_on_the_card_route(monkeypatch, Dh,
                                                           width, blocks):
    """The float32 backward past Dh 256 runs clusters of `wide_f32_blocks`
    column blocks (one 64-column chunk each, at most 8 a cluster: Dh <=
    512); past 8 (the passes) the wrapper's scratch holds, after each
    row's delta, float32 S and dP totals of every pair of 64-row tiles,
    zeroed.  The gradients are the plain version's at the true width
    within the float32 tolerance (1e-5 of the largest magnitude)."""
    seen = []

    def call(fn, tensors, args, what):
        q, k, v, o, do, lse, scratch, dq, dk, dv = tensors
        _, _, _, _, _, Dh_k, causal, window, scale, dtype = args
        seen.append((fn, Dh_k, dtype, scratch.clone()))
        for d, w in zip((dq, dk, dv), fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=bool(causal),
                window=None if window < 0 else window, scale=scale)):
            d.copy_(w)

    monkeypatch.setattr(fa, "_bwd_lib", lambda: "backward")
    monkeypatch.setattr(fa, "_call", call)
    B, Sq, Sk, H, KvH = 1, 70, 130, 2, 1
    q, k, v, do = _qkv(Dh, B, Sq, Sk, H, KvH, Dh)[1]
    mask = dict(causal=False, window=None)
    o = PLAIN_FLASH(q, k, v, **mask)
    lse = fa.flash_attention_lse_plain(q, k, **mask)
    before = fa.BWD_LAUNCHES
    got = fa._flash_bwd_cuda(q, k, v, o, do, lse, **mask)
    assert fa.BWD_LAUNCHES == before + 1
    fn, Dh_k, dtype, scratch = seen[-1]
    assert (fn, Dh_k, dtype) == ("backward", width, 0)
    assert fa.wide_f32_blocks(width) == blocks
    assert fa.wide_blocks(width, torch.float32) == blocks
    totals = B * H * 2 * 3 * 2 * 64 * 64 if blocks > fa.WIDE_BWD_CLUSTER \
        else 0
    assert scratch.numel() == B * H * Sq + totals
    assert fa.bwd_scratch_floats(B, Sq, Sk, H, width, torch.float32) == \
        scratch.numel()
    if totals:
        assert not bool(scratch.any())
    for a, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                      **mask)):
        assert a.shape == w.shape and a.dtype == torch.float32
        assert float((a - w).abs().max()) <= REL * float(w.abs().max())


@pytest.mark.parametrize("width,dtype,floats", [
    (512, torch.float32, 0), (576, torch.float32, 1),
    (2048, torch.bfloat16, 0), (2112, torch.bfloat16, 1),
    (256, torch.float32, 0), (256, torch.bfloat16, 0)])
def test_bwd_scratch_counts_totals_past_a_cluster(width, dtype, floats):
    """`bwd_scratch_floats`: B H Sq delta floats, and S and dP totals of
    every pair of 64-row tiles exactly where the wide kernel runs in
    passes: past 8 one-chunk float32 blocks (Dh > 512) or 8 bf16 blocks of
    up to four chunks (Dh > 2048), never at a built width."""
    B, Sq, Sk, H = 2, 100, 200, 3
    totals = B * H * 2 * 4 * 2 * 64 * 64
    assert fa.bwd_scratch_floats(B, Sq, Sk, H, width, dtype) == \
        B * H * Sq + floats * totals
    if width not in fa.HEAD_DIMS:
        assert (fa.wide_blocks(width, dtype) > fa.WIDE_BWD_CLUSTER) == \
            bool(floats)


# float32 shapes past the wide kernels' 64 x 64 tiles' edges: a ragged
# Sq and Sk on both sides, a window across tiles, Sq > Sk, one tile
F32_BWD_TILE_CASES = [
    (1, 130, 70, 2, 1, 320, False, None),
    (1, 150, 150, 2, 2, 384, True, 40),
    (2, 64, 64, 2, 1, 448, True, None),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", F32_BWD_TILE_CASES)
def test_flash_bwd_plain_on_the_f32_wide_tiles_matches_jax_grad(
        B, Sq, Sk, H, KvH, Dh, causal, window):
    """`flash_attention_bwd_plain` on the float32 wide kernel's tiles
    (`BWD_TILES[float32]["wide"]`: 64 x 64, the kernel's HB_TILE) against
    `jax.grad` of the reference's attention at the float32 tolerance
    (1e-5 of each gradient's largest magnitude), at shapes whose edges
    cut those tiles."""
    assert fa.BWD_TILES[torch.float32]["wide"] == (64, 64)
    (jq, jk, jv), (q, k, v, do) = _qkv(Sq + Dh + 4, B, Sq, Sk, H, KvH, Dh)
    w = jnp.asarray(do.numpy())
    mask = dict(causal=causal, window=window)

    def loss(q_, k_, v_):
        return jnp.sum(ref.flash_attention_ref(q_, k_, v_, **mask) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    got = fa.flash_attention_bwd_plain(
        q, k, v, PLAIN_FLASH(q, k, v, **mask), do,
        fa.flash_attention_lse_plain(q, k, **mask), **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("p,n,s", [(128, 256, 70), (80, 192, 600),
                                   (65, 129, 600)])
def test_wide_ssd_on_the_card_route(monkeypatch, p, n, s):
    """A CUDA-typed call past p 64 / n 128 launches at p 64 (the p-blocks
    as heads) once per n-block, each at its built width, and never reaches
    the plain version; through `SSDScan` y and every gradient equal the
    plain version's at the true widths, the group states kept at the
    kernels' widths."""
    seen = []
    _ssd_launches(monkeypatch, seen)
    b, h, g = 1, 2, 1
    _, t = _ssd_inputs(p + n + s, b, s, h, p, g, n, dt_scale=0.05)
    want = PLAIN_SSD(*t[:5], chunk=ss.TILE)
    grads = ss.ssd_scan_bwd_fold_plain(*t, chunk=ss.TILE)

    def refuse(*a, **kw):
        raise AssertionError("the card route reached the plain version")
    monkeypatch.setattr(ss, "ssd_scan_plain", refuse)
    blocks = [("ssd_scan_launch", 64, w) for *_, w in ss.state_blocks(n)]
    before = ss.LAUNCHES
    got = ss.ssd_scan(*(x.as_subclass(_OnCard) for x in t[:5]))
    assert ss.LAUNCHES == before + ss.kernel_launches(s, n)
    assert seen == blocks
    _rel_close(got.as_subclass(torch.Tensor), want, f"p {p} n {n}")
    y, states = ss._ssd_cuda(*t[:5], states=True)
    if ss.n_groups(s) > 1:
        assert tuple(states.shape) == (b, h * -(-p // 64), ss.n_groups(s),
                                       ss.kernel_widths(p, n)[1], 64)
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    seen.clear()
    b0 = ss.BWD_LAUNCHES
    ss.SSDScan.apply(*leaves).backward(t[5])
    assert ss.BWD_LAUNCHES - b0 == len(ss.state_blocks(n))
    assert seen == blocks + [("ssd_scan_bwd_launch", 64, w)
                             for *_, w in ss.state_blocks(n)]
    for name, a, w in zip(("x", "dt", "A", "B", "C"), leaves, grads):
        assert a.grad.shape == w.shape, name
        _rel_close(a.grad, w, "d" + name)


# ---------------------------------------------------------------------------
# scripts/kernel_probe.py's variants: each edit still finds its source text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source,table", [
    ("flash_attention", "FWD_VARIANTS"),
    ("flash_attention", "FWD_F32_VARIANTS"),
    ("flash_attention_bwd", "BWD_VARIANTS"),
    ("flash_attention_bwd", "BWD_F32_VARIANTS"),
    ("flash_attention_bwd", "BWD_F32_BUILT_VARIANTS"),
    ("flash_attention", "BF16_VARIANTS")])
def test_kernel_probe_variant_edits_apply(source, table):
    """`flash-wide-variants` / `flash-bwd-variants` (and their float32
    forms, and `flash-bf16-variants` for the bf16 forward at the built
    widths) build copies of a CUDA source with one part of a step dropped
    or changed by text edits, and stop on an edit whose text the source no
    longer holds: every edit of every variant applies to the sources as
    they stand.  Runs on the CPU: it only reads the sources."""
    import importlib
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "scripts"))
    try:
        probe = importlib.import_module("kernel_probe")
    finally:
        sys.path.remove(str(root / "scripts"))
    text = (root / "src" / "repro_torch" / "csrc" / f"{source}.cu") \
        .read_text()
    variants = getattr(probe, table)
    assert "as built" in variants and len(variants) > 5
    for name, edits in variants.items():
        for old, _ in edits:
            assert old in text, f"{table} {name!r}: {old[:60]!r}"
