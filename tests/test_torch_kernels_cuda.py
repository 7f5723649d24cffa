"""The CUDA kernels (day scan, flash attention, SSD scan) against their
plain PyTorch versions on the card.

Needs an NVIDIA card with nvcc (the kernels have no CPU mode) and skips
without one; it imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import day_scan as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tables(n: int, t: int, n_lvl: int, seed: int, device) -> dict:
    """Random day tables that drive the throttle, thermal and SoC paths."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mw = rng.uniform(300.0, 2500.0, (t, 1, n)) \
        * np.linspace(1.0, 0.4, n_lvl)[None, :, None]
    const = {k: np.full(n, v) for k, v in {
        "temp_trip": 39.5, "temp_clear": 37.0, "soc_trip": 0.3,
        "soc_clear": 0.4, "max_level": float(n_lvl - 1),
        "standby_mw": 45.0, "ste_beta_c": 2.0,
        "ste_beta_soc": 60.0, "p_standby_mw": 18.0}.items()}
    const["has_puck"] = rng.integers(0, 2, n).astype(float)
    const["shutdown_c"] = rng.choice([40.0, 46.0], n)
    for pre, cap in (("", 900.0), ("p_", 4000.0)):
        const.update({pre + "v_full": np.full(n, 4.35),
                      pre + "sag_v": np.full(n, 0.75),
                      pre + "knee_v": np.full(n, 0.3),
                      pre + "knee_sharp": np.full(n, 12.0),
                      pre + "r_ohm": np.full(n, 0.25),
                      pre + "dsoc_coeff": np.full(n, 60.0 / (3600 * cap)),
                      pre + "g_soc_skin": np.full(n, 1 / 7.0),
                      pre + "g_skin_amb": np.full(n, 1 / 11.0),
                      pre + "dt_c_soc": rng.uniform(2.0, 4.0, n),
                      pre + "dt_c_skin": np.full(n, 60.0 / 80.0)})
    valid = np.ones((t, n))
    valid[t - t // 5:, ::3] = 0.0
    return {"step_mw": f32(mw), "step_mw_p": f32(mw * 0.6),
            "step_pods": f32(rng.uniform(0, 5e3, (t, n_lvl, n))),
            "act_mult": f32(np.linspace(1.0, 0.5, n_lvl)[:, None]
                            * np.ones((1, n))),
            "ambient": f32(rng.uniform(22.0, 36.0, (t, n))),
            "active": f32(rng.uniform(0.3, 1.0, (t, n))),
            "valid": f32(valid),
            "charge": f32(np.where(rng.uniform(size=(t, n)) < 0.1, 800.0,
                                   0.0)),
            "charge_p": f32(np.zeros((t, n))),
            "const": {k: f32(v) for k, v in const.items()}}


@pytest.mark.parametrize("n,t,n_lvl", [(1, 50, 1), (37, 300, 3),
                                       (70, 200, 6), (33, 120, 12)])
def test_kernel_matches_plain(cuda, n, t, n_lvl):
    tables = _tables(n, t, n_lvl, seed=n, device=cuda)
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


def test_kernel_rejects_too_many_levels(cuda):
    tables = _tables(4, 10, ds.MAX_LEVELS + 1, seed=0, device=cuda)
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
