"""Float32 flash attention at the built widths (Dh up to 256), which the
card runs on the same split-operand tensor-core kernels as past Dh 256:
the forward on its float32 tile (`fwd_tile`: 128 query rows by 64
keys, a block's two warpgroups), the backward on 64 x 64 tiles at every
width, a head 96 wide zero-padded to 128.

- The plain forward on the float32 tile (`chunked_attention` with the
  kernel's tile) against the Pallas kernel in interpret mode
  (`repro.kernels.ops.flash_attention`) at the reference's float32
  tolerance (`tests/test_kernels.py`: 2e-5).
- `flash_attention_bwd_plain` on the float32 backward's tiles against
  `jax.grad` of `repro.kernels.ref.flash_attention_ref` at 1e-5 of each
  gradient's largest magnitude, with a window, GQA, ragged Sq and Sk and
  Sq != Sk.
- The wrappers' card route with the ctypes launch swapped for the plain
  version (`tests/test_torch_kernel_widths.py`'s helpers): the width the
  kernels are handed (8 and 16 pad to 64, 96 to 128), the backward's
  scratch (each row's delta only), one launch of each counted, and o and
  the gradients equal to the plain version's at the true width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.nn import attention as attn
from test_torch_kernel_widths import PLAIN_FLASH, _OnCard, _qkv, _rel_close

TOL = 2e-5          # float32, tests/test_kernels.py
REL = 1e-5          # float32 gradients, of the largest magnitude

# (B, Sq, Sk, H, KvH, causal, window): GQA with a window across tiles at a
# ragged S, bidirectional with Sq > Sk (both ragged), causal Sq < Sk
SHAPES = [
    (1, 150, 150, 4, 2, True, 40),
    (1, 130, 70, 4, 2, False, None),
    (2, 70, 130, 2, 1, True, None),
]
WIDTHS = [64, 96, 128, 256]


@pytest.mark.parametrize("Dh", WIDTHS)
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,causal,window", SHAPES[:2])
def test_f32_forward_on_its_tile_matches_pallas(B, Sq, Sk, H, KvH, causal,
                                                window, Dh):
    """The plain forward on the float32 kernel's tile (128 x 64: the
    running max kept per 64-key tile, as the kernel keeps it) against the
    Pallas kernel in interpret mode on that tile, at 2e-5."""
    bq, bk = fa.fwd_tile(Dh, torch.float32)
    assert (bq, bk) == (128, 64) == fa.TILES[torch.bfloat16]["wide"]
    (jq, jk, jv), (tq, tk, tv, _) = _qkv(Sq + Dh + 5, B, Sq, Sk, H, KvH,
                                         Dh)
    bidirectional = not causal and window is None
    got = attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 chunk_q=bq, chunk_k=bk,
                                 bidirectional=bidirectional)
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Dh", WIDTHS)
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,causal,window", SHAPES)
def test_f32_bwd_plain_on_its_tiles_matches_jax_grad(B, Sq, Sk, H, KvH,
                                                     causal, window, Dh):
    """`flash_attention_bwd_plain` on the float32 backward's 64 x 64 tiles
    (at the width the kernel runs the head at: 96 at 128) against
    `jax.grad` of the reference's attention, within 1e-5 of each
    gradient's largest magnitude."""
    width = fa.kernel_width(Dh, torch.float32)
    assert width == (128 if Dh == 96 else Dh)
    assert fa.BWD_TILES[torch.float32][width] == (64, 64)
    (jq, jk, jv), (q, k, v, do) = _qkv(Sq + Dh + 6, B, Sq, Sk, H, KvH, Dh)
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
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=REL * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("Dh,width", [(8, 64), (16, 64), (64, 64),
                                      (96, 128), (128, 128), (256, 256)])
def test_f32_built_widths_on_the_card_route(monkeypatch, Dh, width):
    """A CUDA-typed float32 call at Dh up to 256, served and through
    `FlashAttention`: the forward and the backward each launch once
    (counted) at the head
    padded to the float32 kernels' width (96 at 128), with the true
    width's scale, and never reach the plain version; the backward's
    scratch is each row's delta (B H Sq floats) and nothing more; o and
    the gradients are the plain version's at the true width."""
    seen = []

    def call(fn, tensors, args, what):
        B, Sq, Sk, H, KvH, Dh_k, causal, window, scale, dtype = args
        ts = [None if t is None else t.as_subclass(torch.Tensor)
              for t in tensors]
        mask = dict(causal=bool(causal),
                    window=None if window < 0 else window, scale=scale)
        if fn == "forward":
            q, k, v, out, lse = ts
            seen.append((fn, Dh_k, dtype, scale, None))
            assert q.shape[3] == Dh_k
            out.copy_(PLAIN_FLASH(q, k, v, **mask))
            if lse is not None:
                lse.copy_(fa.flash_attention_lse_plain(q, k, **mask))
            return
        q, k, v, o, do, lse, scratch, dq, dk, dv = ts
        seen.append((fn, Dh_k, dtype, scale, scratch.numel()))
        for d, w in zip((dq, dk, dv), fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, **mask)):
            d.copy_(w)

    monkeypatch.setattr(fa, "_lib", lambda: "forward")
    monkeypatch.setattr(fa, "_bwd_lib", lambda: "backward")
    monkeypatch.setattr(fa, "_call", call)
    B, Sq, Sk, H, KvH = 1, 70, 90, 4, 2
    q, k, v, do = _qkv(Dh + 7, B, Sq, Sk, H, KvH, Dh)[1]
    do = do[:, :Sq]
    mask = dict(causal=False, window=None)
    want = PLAIN_FLASH(q, k, v, **mask)
    grads = fa.flash_attention_bwd_plain(
        q, k, v, want, do, fa.flash_attention_lse_plain(q, k, **mask),
        **mask)

    def refuse(*a, **kw):
        raise AssertionError("the card route reached the plain version")
    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    assert fa.kernel_width(Dh, torch.float32) == width
    before = fa.LAUNCHES
    with torch.no_grad():
        got = fa.flash_attention(*(t.as_subclass(_OnCard)
                                   for t in (q, k, v)), **mask)
    assert fa.LAUNCHES == before + 1
    _rel_close(got.as_subclass(torch.Tensor), want, f"Dh {Dh}")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    o = fa.FlashAttention.apply(*leaves, False, None, None)
    o.backward(do)
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    assert [s[:3] for s in seen] == [("forward", width, 0),
                                     ("forward", width, 0),
                                     ("backward", width, 0)]
    assert all(s[3] == pytest.approx(1.0 / np.sqrt(Dh)) for s in seen)
    assert seen[2][4] == B * H * Sq
    assert fa.bwd_scratch_floats(B, Sq, Sk, H, width, torch.float32) == \
        B * H * Sq
    _rel_close(o.detach(), want, "o")
    for name, a, w in zip("qkv", leaves, grads):
        assert a.grad.shape == w.shape and a.grad.dtype == torch.float32
        _rel_close(a.grad, w, "d" + name)
