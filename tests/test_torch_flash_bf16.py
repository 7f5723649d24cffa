"""The bf16 flash forward at the built widths (Dh 64, 96, 128, 256), which
the card runs on `flash_fwd_hb`: 128 query rows a block by kv tiles of
128 keys up to Dh 128 and 64 at Dh 256 (`fwd_tile`), Dh 96 at 96.

- The plain forward on that tile (`chunked_attention`: bf16 inputs, p
  rounded to v's dtype before its product, l from the unrounded p, the
  running max kept per kv tile, as the kernel keeps it) against the
  Pallas kernel in interpret mode (`repro.kernels.ops.flash_attention`)
  on the same bf16 inputs, at the reference's bf16 tolerance (2e-2,
  `tests/test_kernels.py`), at each width and the shapes of
  `tests/test_torch_flash_f32.py`.
- The wrapper's card route with the ctypes launch swapped for the plain
  version (`tests/test_torch_kernel_widths.py`'s helpers): each built
  width, 96 among them, is handed to the launch as it is, one launch is
  counted, the plain version is never reached, and the launch that also
  writes the row lse gives the same o as the serving one.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.nn import attention as attn
from test_torch_flash_f32 import SHAPES
from test_torch_kernel_widths import (PLAIN_FLASH, TOL, _OnCard,
                                      _flash_launches, _qkv)

WIDTHS = [64, 96, 128, 256]


@pytest.mark.parametrize("Dh", WIDTHS)
@pytest.mark.parametrize("B,Sq,Sk,H,KvH,causal,window", SHAPES)
def test_bf16_forward_on_its_tile_matches_pallas(B, Sq, Sk, H, KvH, causal,
                                                 window, Dh):
    """The plain forward on the bf16 kernel's tile at Dh (128 x 128 up to
    Dh 128, 128 x 64 at 256) against the Pallas kernel in interpret mode
    on that tile, at 2e-2: GQA with a window across tiles at a ragged S,
    bidirectional Sq > Sk, causal Sq < Sk."""
    bq, bk = fa.fwd_tile(Dh, torch.bfloat16)
    assert (bq, bk) == ((128, 128) if Dh <= 128 else (128, 64))
    (jq, jk, jv), (tq, tk, tv, _) = _qkv(Sq + Dh + 7, B, Sq, Sk, H, KvH, Dh,
                                         "bfloat16")
    bidirectional = not causal and window is None
    got = attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 chunk_q=bq, chunk_k=bk,
                                 bidirectional=bidirectional)
    want = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("Dh", WIDTHS)
def test_bf16_built_widths_on_the_card_route(monkeypatch, Dh):
    """A CUDA-typed bf16 call at a built width launches the kernel once
    (counted) at that width (96 unpadded: `kernel_width(96, bf16)` is
    96), with the true width's scale, never reaching the plain version,
    and equals it; the launch with the row lse (the autograd function's)
    writes the same o, bit for bit, as the serving one."""
    seen = []
    _flash_launches(monkeypatch, seen)

    def refuse(*a, **kw):
        raise AssertionError("the card route reached the plain version")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    assert fa.kernel_width(Dh, torch.bfloat16) == Dh
    _, (q, k, v, _) = _qkv(Dh + 1, 1, 70, 70, 4, 2, Dh, "bfloat16")
    want = PLAIN_FLASH(q, k, v, causal=True, window=24,
                       scale=1.0 / np.sqrt(Dh))
    card = [t.as_subclass(_OnCard) for t in (q, k, v)]
    before = fa.LAUNCHES
    got = fa.flash_attention(*card, causal=True, window=24)
    assert fa.LAUNCHES == before + 1
    assert seen[-1] == ("forward", Dh, 1.0 / np.sqrt(Dh))
    got = got.as_subclass(torch.Tensor)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, want)
    # the autograd function's launch (its lse on the tensors' own device)
    o, lse = fa._flash_cuda(q, k, v, causal=True, window=24, lse=True)
    assert fa.LAUNCHES == before + 2 and seen[-1][:2] == ("forward", Dh)
    assert torch.equal(o, got)
    assert lse.shape == (1, 4, 70) and lse.dtype == torch.float32


def test_fwd_tile_reads_the_width_the_kernel_runs():
    """`fwd_tile` reads `TILES` at the width a head runs at: a narrower
    bf16 head at the built width it is padded to, a wider one at the wide
    kernels' tile, float32 everywhere at 128 x 64."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.fwd_tile(8, bf16) == fa.fwd_tile(64, bf16) == (128, 128)
    assert fa.fwd_tile(80, bf16) == fa.TILES[bf16][96] == (128, 128)
    assert fa.fwd_tile(200, bf16) == fa.TILES[bf16][256] == (128, 64)
    assert fa.fwd_tile(320, bf16) == fa.TILES[bf16]["wide"] == (128, 64)
    for Dh in (8, 64, 96, 128, 256, 320):
        assert fa.fwd_tile(Dh, f32) == (128, 64)
