"""Port parity of the SSD scan: the port's `ssd_scan` on CPU tensors (its
plain version) against the reference Pallas kernel in interpret mode
(`repro.kernels.ops.ssd_scan`), the sequential oracle `ssd_reference`
and `ssd_chunked`; a ragged sequence length against `ssd_chunked`; and
the port's `ssd_reference` / `ssd_step` against the reference's.  Inputs
come from numpy and cross as arrays.

Tolerances are the reference's own (`tests/test_kernels.py`): atol
max(tol, 1e-4) and rtol 5 tol, tol = 2e-5 (float32) or 2e-2 (bfloat16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.nn import ssd as j_ssd
from repro_torch.kernels import ssd_scan as ss
from repro_torch.nn import ssd as t_ssd

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, dtype, b, s, h, p, g, n, dt_scale=1.0):
    """x, dt (dt_scale x softplus of a normal), A (-exp of 0.3 normal),
    B, C."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 128, 2, 8, 1, 16, 64),
    (2, 256, 4, 16, 2, 32, 64),
    (2, 128, 4, 8, 4, 16, 32),      # groups == heads
])
def test_ssd_matches_pallas_and_oracles(dtype, b, s, h, p, g, n, chunk):
    j, t = _inputs(s + h + g, dtype, b, s, h, p, g, n)
    before = ss.LAUNCHES
    got = ss.ssd_scan(*t, chunk=chunk)
    assert ss.LAUNCHES == before            # CPU tensors: the plain version
    assert got.dtype == T_DT[dtype] and got.shape == (b, s, h, p)
    _close(got, ops.ssd_scan(*j, chunk=chunk), dtype)
    _close(got, ref.ssd_scan_ref(*j), dtype)
    _close(got, j_ssd.ssd_chunked(*j, chunk=chunk)[0], dtype)


@pytest.mark.parametrize("s", [100, 37])
def test_ragged_length_matches_ssd_chunked(s):
    """s not a multiple of the chunk: the dt = 0 tail pad, y and state."""
    j, t = _inputs(s, "float32", 2, s, 4, 8, 2, 16)
    y = ss.ssd_scan(*t, chunk=32)
    want_y, want_state = j_ssd.ssd_chunked(*j, chunk=32)
    assert y.shape == (2, s, 4, 8)
    _close(y, want_y, "float32")
    _, state = t_ssd.ssd_chunked(*t, chunk=32)
    _close(state, want_state, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 256, 2, 8, 1, 16, 128),     # mamba2-2.7b tuned: two whole chunks
    (2, 100, 4, 8, 2, 16, 128),     # s < chunk: one chunk of s rows
    (1, 300, 2, 8, 1, 16, 128),     # ragged: the dt = 0 tail pad
    (2, 96, 4, 8, 2, 16, 32),       # the reference's ssd32 variant
    (1, 70, 2, 8, 1, 16, 32),       # ragged at 32
])
def test_plain_at_config_chunks_matches_pallas_and_ssd_chunked(
        dtype, b, s, h, p, g, n, chunk):
    """The plain version at the chunks configs and perf variants ask for
    against the reference's `ssd_chunked` at that chunk and, where its
    launcher takes the length (s a multiple of min(chunk, s)), the
    Pallas kernel in interpret mode."""
    from repro.kernels import ssd_scan as j_kernel
    j, t = _inputs(s + chunk, dtype, b, s, h, p, g, n)
    got = ss.ssd_scan(*t, chunk=chunk)
    assert got.dtype == T_DT[dtype] and got.shape == (b, s, h, p)
    _close(got, j_ssd.ssd_chunked(*j, chunk=chunk)[0], dtype)
    if s % min(chunk, s) == 0:
        _close(got, j_kernel.ssd_scan(*j, chunk=chunk, interpret=True), dtype)


@pytest.mark.parametrize("chunk", [128, 32])
def test_tile_equals_config_chunk(chunk):
    """The kernels' own 64-row tile computes the function of any chunk:
    the plain version at `TILE` against the plain version and the
    reference's `ssd_chunked` at the config's chunk (float32 sum order
    only), on a ragged length with a slow decay (the carry counts)."""
    j, t = _inputs(7, "float32", 1, 1000, 4, 64, 1, 128, dt_scale=0.05)
    tiled = ss.ssd_scan_plain(*t, chunk=ss.TILE)
    _close(tiled, j_ssd.ssd_chunked(*j, chunk=chunk)[0], "float32")
    _close(tiled, ss.ssd_scan_plain(*t, chunk=chunk).numpy(), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,group", [
    (2, 100, 4, 8, 2, 16, 32, 2),   # ragged s, g = 2
    (1, 256, 2, 8, 1, 16, 32, 3),   # 3 groups do not divide 8 chunks
    (1, 128, 4, 8, 2, 16, 32, 1),   # one chunk per group
    (1, 128, 2, 8, 1, 16, 32, 8),   # one group holds every chunk
])
def test_split_scan_matches_pallas_and_ssd_chunked(dtype, b, s, h, p, g, n,
                                                   chunk, group):
    """The CUDA kernel's three-pass split (group states, state passing,
    per-group scan), mirrored in plain PyTorch.  dt is small (x 0.05), so
    the state carried between groups moves y by ~0.1 against |y| ~0.2:
    a group started from zero would miss the tolerance."""
    j, t = _inputs(s + group, dtype, b, s, h, p, g, n, dt_scale=0.05)
    got = ss.ssd_scan_split_plain(*t, chunk=chunk, group=group)
    assert got.dtype == T_DT[dtype] and got.shape == (b, s, h, p)
    assert ss.n_groups(s, chunk, group) == -(-(-(-s // chunk)) // group)
    _close(got, j_ssd.ssd_chunked(*j, chunk=chunk)[0], dtype)
    if s % chunk == 0:
        _close(got, ops.ssd_scan(*j, chunk=chunk), dtype)
    if ss.n_groups(s, chunk, group) > 1:     # the carry is visible
        span = group * chunk
        no_carry = torch.cat([ss.ssd_scan_plain(
            *(a[:, i:i + span] if a.dim() > 1 else a for a in t),
            chunk=chunk) for i in range(0, s, span)], 1)
        tol = TOL[dtype]
        assert not np.allclose(no_carry.float().numpy(),
                               got.float().numpy(), atol=max(tol, 1e-4),
                               rtol=5 * tol)


def test_ssd_reference_and_step_match_reference():
    j, t = _inputs(5, "float32", 2, 12, 4, 8, 2, 16)
    y, state = t_ssd.ssd_reference(*t)
    want_y, want_state = j_ssd.ssd_reference(*j)
    _close(y, want_y, "float32")
    _close(state, want_state, "float32")
    tx, tdt, tA, tB, tC = t
    jx, jdt, jA, jB, jC = j
    got_y, got_s = t_ssd.ssd_step(state, tx[:, 0], tdt[:, 0], tA, tB[:, 0],
                                  tC[:, 0])
    w_y, w_s = j_ssd.ssd_step(want_state, jx[:, 0], jdt[:, 0], jA, jB[:, 0],
                              jC[:, 0])
    _close(got_y, w_y, "float32")
    _close(got_s, w_s, "float32")


def test_dispatch_rejects_bad_inputs():
    _, (x, dt, A, B, C) = _inputs(0, "float32", 1, 8, 2, 4, 1, 4)
    with pytest.raises(ValueError, match="dt and A must be float32"):
        ss.ssd_scan(x, dt.double(), A, B, C)
    with pytest.raises(ValueError, match="one dtype"):
        ss.ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="do not fit"):
        ss.ssd_scan(x, dt[:, :4], A, B, C)
