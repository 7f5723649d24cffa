"""Port parity of attention: the port's `flash_attention` on CPU tensors
(its plain version) against the reference Pallas kernel in interpret mode
(`repro.kernels.ops.flash_attention`) and its oracle
(`repro.kernels.ref.flash_attention_ref`), plus the port's `sdpa`,
`chunked_attention`, `decode_attention` and `rope` against the
reference's.  Inputs come from numpy and cross as arrays.

Tolerances are the reference's own (`tests/test_kernels.py`): 2e-5 in
float32, 2e-2 in bfloat16 (products and sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.nn import attention as j_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.nn import attention as t_attn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(J_DT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(T_DT[dtype]) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KvH,Dh,causal,window,bq,bk", [
    (1, 128, 2, 2, 32, True, None, 64, 64),
    (1, 256, 4, 1, 64, True, 96, 128, 128),     # GQA 4:1 + window
    (2, 192, 8, 4, 32, False, None, 64, 64),    # bidirectional, ragged S
    (1, 320, 4, 4, 128, True, None, 128, 64),   # uneven blocks, pad path
    (1, 192, 4, 4, 96, True, None, 64, 64),     # phi-3-vision's head width
    (1, 200, 8, 4, 256, True, 72, 64, 64),      # gemma3's: GQA, window, ragged
    (1, 130, 4, 2, 256, False, None, 64, 64),   # bidirectional Dh 256, ragged
])
def test_flash_matches_pallas_and_oracle(dtype, B, S, H, KvH, Dh, causal,
                                         window, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        S + H, dtype, (B, S, H, Dh), (B, S, KvH, Dh), (B, S, KvH, Dh))
    before = fa.LAUNCHES
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa.LAUNCHES == before            # CPU tensors: the plain version
    assert got.dtype == T_DT[dtype] and got.shape == (B, S, H, Dh)
    pallas = ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 block_q=bq, block_k=bk)
    _close(got, pallas, TOL[dtype])
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KvH,causal,window,cq,ck", [
    (96, 4, 2, True, None, 32, 32),
    (100, 4, 1, True, 24, 32, 48),              # ragged q and kv, window
    (70, 2, 2, False, None, 16, 32),            # bidirectional
])
def test_chunked_and_sdpa_match_reference(dtype, S, H, KvH, causal, window,
                                          cq, ck):
    Dh = 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        S, dtype, (2, S, H, Dh), (2, S, KvH, Dh), (2, S, KvH, Dh))
    bidir = not causal and window is None
    got = t_attn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                   chunk_q=cq, chunk_k=ck,
                                   bidirectional=bidir)
    want = j_attn.chunked_attention(jq, jk, jv, causal=causal,
                                    window=window, chunk_q=cq, chunk_k=ck,
                                    bidirectional=bidir)
    _close(got, want, TOL[dtype])
    got = t_attn.sdpa(tq, tk, tv, causal=causal, window=window,
                      bidirectional=bidir)
    want = j_attn.sdpa(jq, jk, jv, causal=causal, window=window,
                       bidirectional=bidir)
    _close(got, want, TOL[dtype])


def test_plain_flash_takes_chunked_path_beyond_2048():
    """Past 2048 query rows the plain version is `chunked_attention` with
    the model's default blocks, as the reference's model switches."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, "float32", (1, 2100, 2, 16), (1, 2100, 1, 16), (1, 2100, 1, 16))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    want = j_attn.chunked_attention(jq, jk, jv, causal=True)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, "float32", (2, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16))
    for cur in (1, 9, 24):
        got = t_attn.decode_attention(tq, tk, tv, cur, window=window)
        want = j_attn.decode_attention(jq, jk, jv, jnp.asarray(cur),
                                       window=window)
        _close(got, want, TOL["float32"])


def test_rope_matches_reference():
    (jx,), (tx,) = _inputs(4, "float32", (2, 10, 3, 32))
    pos = np.arange(10)[None, :] + 1000
    got = t_attn.rope(tx, torch.as_tensor(pos), 10_000.0)
    want = j_attn.rope(jx, jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_dispatch_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                           q)
    m = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(m, m, m)
