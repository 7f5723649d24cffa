"""The bf16 SSD backward's host-side rules and its arithmetic on the CPU:
the plain version of the wgmma kernels' arithmetic
(`ssd_scan_bwd_fold_plain`: truncated three-part splits, the products'
orientations, dt folded into G o E, the walks' (M v)^T split, each
block's heads summed in head order) against `jax.grad` of the
reference's `nn/ssd.ssd_chunked` at the float32 tolerance of
tests/test_torch_ssd_bwd.py (each gradient within 1e-5 of its largest
magnitude), with a one-part control that misses it; the launches' grids
and the heads each chunk block takes (`bwd_launch_grids`,
`block_heads`, on meta tensors); that the backward's wrapper hands the
kernel the model's strided views uncopied where the TMA maps read them
(`_tma_ready`); and that every `ssd-bwd-variants` edit of
scripts/kernel_probe.py still finds its source text.  Inputs come from
numpy and cross as arrays.

dt is drawn at a quarter of the forward tests' scale, or at 0.05 where
the state carried between groups must count: the reference's masked
decay overflows past exp(88) and makes `jax.grad` NaN (see
tests/test_torch_ssd_bwd.py)."""
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssd as j_ssd
from repro_torch.kernels import ssd_scan as ss

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, b, s, h, p, g, n, dt_scale):
    """float32 numpy x, dt, A, B, C and the output weights w (= dy)."""
    rng = np.random.default_rng(seed)
    arrs = (0.5 * rng.standard_normal((b, s, h, p)),
            dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, h)))),
            -np.exp(0.3 * rng.standard_normal(h)),
            0.3 * rng.standard_normal((b, s, g, n)),
            0.3 * rng.standard_normal((b, s, g, n)),
            rng.standard_normal((b, s, h, p)))
    return [a.astype(np.float32) for a in arrs]


def _jax_grads(arrs):
    w = jnp.asarray(arrs[5])
    return jax.grad(lambda *a: jnp.sum(j_ssd.ssd_chunked(*a, chunk=64)[0]
                                       * w), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs[:5]))


def _errs(got, want):
    """Each gradient's largest error over its largest magnitude."""
    out = []
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        a = a.detach().float().numpy()
        assert a.shape == b.shape
        out.append(float(np.abs(a - b).max())
                   / max(float(np.abs(b).max()), 1e-30))
    return out


# (b, s, h, p, g, n, dt_scale, heads): one chunk; a ragged tail inside a
# group; three groups carrying the state and its gradient (dt x 0.05); g
# 2 with sets of heads that leave a short last set (5 heads of a group in
# sets of 2); the blocks' 8 heads with a short set (12 heads of a group)
FOLD_CASES = [(2, 40, 2, 16, 1, 16, 0.25, 8),
              (1, 150, 4, 8, 2, 16, 0.25, 8),
              (1, 1100, 2, 8, 1, 16, 0.05, 8),
              (1, 200, 10, 8, 2, 8, 0.25, 2),
              (1, 100, 12, 8, 1, 8, 0.25, 8)]


@pytest.mark.parametrize("b,s,h,p,g,n,dt_scale,heads", FOLD_CASES)
def test_bwd_fold_plain_matches_jax_grad(b, s, h, p, g, n, dt_scale, heads):
    """The bf16 backward's arithmetic (walks with (M v)^T split, the
    pass, each chunk's three phases with S, dS', W^T, (G o E)^T and G o E
    split into three truncated bf16 parts, dt_j folded into G o E, dB /
    dC summed over sets of `heads` heads in head order) is the gradient
    at the float32 tolerance: every gradient within 1e-5 of its largest
    magnitude of `jax.grad` of the reference."""
    arrs = _inputs(b * s + h + heads, b, s, h, p, g, n, dt_scale)
    t = [torch.from_numpy(a) for a in arrs]
    got = ss.ssd_scan_bwd_fold_plain(*t, heads=heads)
    errs = _errs(got, _jax_grads(arrs))
    assert max(errs) <= REL, dict(zip(NAMES, errs))


def test_bwd_fold_plain_one_part_misses_the_float32_tolerance():
    """The control: with one truncated bf16 part for each float32 operand
    the gradients leave the float32 tolerance by two orders of magnitude
    (dx, dB and dC each), where three parts keep it."""
    arrs = _inputs(3, 1, 600, 2, 16, 1, 16, 0.05)
    t = [torch.from_numpy(a) for a in arrs]
    want = _jax_grads(arrs)
    three = _errs(ss.ssd_scan_bwd_fold_plain(*t), want)
    one = _errs(ss.ssd_scan_bwd_fold_plain(*t, parts=1), want)
    assert max(three) <= REL
    assert min(one[k] for k in (0, 3, 4)) > 100 * REL, one


def test_bwd_fold_plain_takes_the_forward_states():
    """Given the forward's group states in the kernels' layout (b, h, G,
    n, p), the fold gives the gradients it computes from scratch; a bf16
    call returns dx, dB and dC in bf16, ddt and dA in float32, within the
    card's 5e-4 relative RMS of the plain backward on the same inputs."""
    arrs = _inputs(8, 1, 700, 4, 64, 1, 64, 0.05)
    t = [torch.from_numpy(a) for a in arrs]
    kept = ss.ssd_split_states_plain(*t[:5], chunk=64) \
        .permute(0, 2, 1, 4, 3).contiguous()
    a = ss.ssd_scan_bwd_fold_plain(*t)
    b = ss.ssd_scan_bwd_fold_plain(*t, kept)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    low = [u.to(torch.bfloat16) if k in (0, 3, 4, 5) else u
           for k, u in enumerate(t)]
    got = ss.ssd_scan_bwd_fold_plain(*low)
    want = ss.ssd_scan_bwd_plain(*low, chunk=64)
    for k, (x, w) in enumerate(zip(got, want)):
        assert x.dtype == w.dtype == (torch.bfloat16 if k in (0, 3, 4)
                                      else torch.float32)
        x, w = x.float(), w.float()
        rms = float((x - w).square().mean().sqrt() / w.square().mean().sqrt())
        assert rms <= 5e-4, (NAMES[k], rms)


@pytest.mark.parametrize("b,s,h,g,n,dtype", [
    (2, 4096, 64, 1, 64, torch.bfloat16),     # zamba2-1.2b's prefill
    (2, 4096, 80, 1, 128, torch.bfloat16),    # mamba2-2.7b's: 10 sets
    (1, 1100, 8, 2, 128, torch.bfloat16),     # g 2: one set a group
    (3, 700, 6, 3, 64, torch.bfloat16),       # 2 heads a group
    (1, 1000, 20, 1, 64, torch.bfloat16),     # 8 + 8 + 4
    (2, 600, 10, 2, 64, torch.bfloat16),      # 5 a group: a short set
    (1, 500, 3, 1, 64, torch.bfloat16),       # one group: no pass
    (2, 600, 4, 2, 64, torch.float32),        # float32: a head a block
])
def test_bwd_launch_grids_cover_every_head_once(b, s, h, g, n, dtype):
    """The backward's launches on meta tensors: the walks over 2 G
    groups and every head, the pass over n p / 256 (G > 1), the chunk
    blocks over every tile and sets of `BWD_HEADS` heads of one B/C
    group, each head taken by exactly one block of its own group, the
    rows of dB / dC the wrapper sums (`bwd_rows`) one a set; the grid's
    y within the card's 65 535."""
    x = torch.empty((b, s, h, 64), dtype=dtype, device="meta")
    B = torch.empty((b, s, g, n), dtype=dtype, device="meta")
    grids = ss.bwd_launch_grids(x, B)
    G, nc = ss.n_groups(s), -(-s // ss.TILE)
    assert len(grids) == ss.bwd_kernel_launches(s)
    names = [name for name, *_ in grids]
    if dtype == torch.float32:
        assert names == (["state", "pass", "scan"] if G > 1
                         else ["state", "scan"])
        assert all(grid == ((n * 64 // 256) if name == "pass" else G, h, b)
                   for name, grid, *_ in grids)
        return
    assert names == (["walk", "pass", "chunk"] if G > 1 else ["walk", "chunk"])
    for name, (gx, gy, gz), threads, heads in grids:
        assert gz == b and gy <= ss.MAX_GRID_YZ
        if name == "walk":
            assert (gx, gy, threads, heads) == (2 * G, h, 128, 1)
        elif name == "pass":
            assert (gx, gy, threads) == (n * 64 // 256, h, 256)
        else:
            assert (gx, threads, heads) == (nc, 128, ss.BWD_HEADS)
            assert gy == ss.bwd_rows(h, g, dtype)
            taken = [ss.block_heads(h, g, heads, y) for y in range(gy)]
            assert sorted(hd for hs in taken for hd in hs) == list(range(h))
            for y, hs in enumerate(taken):
                assert 1 <= len(hs) <= heads
                assert {hd // (h // g) for hd in hs} == {y // (gy // g)}
                assert hs == list(range(hs[0], hs[0] + len(hs)))


def _record_bwd(monkeypatch):
    """Swap the backward's launcher for a recorder of the tensors and the
    int / stride arguments `_bwd_block` hands it."""
    seen = []
    monkeypatch.setattr(ss, "_bwd_lib", lambda: "ssd_scan_bwd_launch")
    monkeypatch.setattr(ss, "_call", lambda fn, tensors, args, what:
                        seen.append((tensors, args)))
    return seen


def test_bwd_reads_the_model_views_where_they_lie(monkeypatch):
    """`SSDScan` saves the model's x / B / C, views into the conv output
    (rows d_inner + 2 g n wide), and dy may come strided too: the bf16
    backward's wrapper hands all four to the kernel uncopied with their
    strides (`_tma_ready`), dx dense; a dy whose row stride is off 16
    bytes, and every float32 input, is copied dense."""
    seen = _record_bwd(monkeypatch)
    b, s, h, g, n = 2, 600, 4, 1, 64
    row = h * 64 + 2 * g * n
    xbc = torch.zeros((b, s, row), dtype=torch.bfloat16)
    x = xbc[..., :h * 64].reshape(b, s, h, 64)
    B = xbc[..., h * 64:h * 64 + g * n].reshape(b, s, g, n)
    C = xbc[..., h * 64 + g * n:].reshape(b, s, g, n)
    wide = torch.zeros((b, s, h * 64 + 8), dtype=torch.bfloat16)
    dy = wide[..., :h * 64].reshape(b, s, h, 64)
    dt, A = torch.ones((b, s, h)), -torch.ones(h)
    G = ss.n_groups(s)
    states = torch.zeros((b, h, G, n, 64))
    assert all(ss._tma_ready(t) for t in (x, B, C, dy))
    ss._bwd_block(x, dt, A, B, C, dy, states, False)
    tensors, args = seen[-1]
    assert [t.data_ptr() for t in (tensors[0], tensors[3], tensors[4],
                                   tensors[5])] == \
        [t.data_ptr() for t in (x, B, C, dy)]
    assert args[:9] == (b, s, h, 64, g, n, ss.TILE, ss.GROUP_CHUNKS, 1)
    assert args[9:] == (64, row, s * row, n, row, s * row, n, row, s * row,
                        64, h * 64 + 8, s * (h * 64 + 8))
    assert tensors[12].is_contiguous() and tensors[12].dtype == torch.bfloat16
    odd = torch.zeros((b, s, h * 64 + 4), dtype=torch.bfloat16)
    dy_odd = odd[..., :h * 64].reshape(b, s, h, 64)
    assert not ss._tma_ready(dy_odd)
    ss._bwd_block(x, dt, A, B, C, dy_odd, states, True)
    tensors, args = seen[-1]
    assert tensors[5].is_contiguous() and args[8] == 2
    assert args[18:] == (64, h * 64, s * h * 64)
    assert tensors[12].dtype == torch.float32
    f32 = [t.float() for t in (x, B, C, dy)]
    ss._bwd_block(f32[0], dt, A, f32[1], f32[2], f32[3], states, False)
    tensors, args = seen[-1]
    assert all(tensors[i].is_contiguous() for i in (0, 3, 4, 5))
    assert args[9:] == (64, h * 64, s * h * 64, n, g * n, s * g * n, n,
                        g * n, s * g * n, 64, h * 64, s * h * 64)


def test_ssd_autograd_backward_takes_dy_as_it_comes(monkeypatch):
    """`SSDScan.backward` passes dy to the backward's wrapper as autograd
    hands it: a strided dy is not copied on the way."""
    got = []

    def fwd(x, dt, A, B, C, *, states=False):
        return ss.ssd_scan_plain(x, dt, A, B, C), None

    def bwd(x, dt, A, B, C, dy, states):
        got.append(dy)
        return tuple(torch.zeros_like(t) for t in (x, dt, A, B, C))

    monkeypatch.setattr(ss, "_ssd_cuda", fwd)
    monkeypatch.setattr(ss, "_ssd_bwd_cuda", bwd)
    t = [torch.from_numpy(a) for a in _inputs(1, 1, 70, 2, 64, 1, 64, 0.25)]
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    dy = torch.zeros((1, 70, 2, 72))[..., :64]
    ss.SSDScan.apply(*leaves).backward(dy)
    assert len(got) == 1 and got[0].stride() == dy.stride()


def test_kernel_probe_ssd_bwd_variant_edits_apply():
    """scripts/kernel_probe.py's `ssd-bwd-variants` builds copies of
    csrc/ssd_scan_bwd.cu with one switch of the bf16 backward flipped by
    a text edit (levers a-e and the diagnostics without exps or
    products), and stops on an edit whose text the source no longer
    holds: every edit applies, and each variant changes the source."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        probe = importlib.import_module("kernel_probe")
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    sources = probe.ssd_bwd_variant_sources()
    text = (ROOT / "src" / "repro_torch" / "csrc" /
            "ssd_scan_bwd.cu").read_text()
    assert sources["as built"] == text
    for lever in "abcde":
        assert any(name.startswith(lever + ":") for name in sources), lever
    for name in ("no exps (every decay 1)", "no products (no wgmma issued)"):
        assert name in sources
    for name, src in sources.items():
        assert name == "as built" or src != text, name
    assert f"constexpr int HEADS = {ss.BWD_HEADS};" in text
    assert f"constexpr int HB_THREADS = {ss.BWD_THREADS};" in text
    # both wgmma wrappers (shared-memory A and register A) return at once
    assert sources["no products (no wgmma issued)"].count(
        "int accumulate) {\n  return;\n") == 2
    assert [name for name, src in sources.items()
            if "constexpr int HEADS = 4;" in src] == [
        "d: four heads a chunk block (twice the dB / dC rows)"]
