"""Port parity of the SSD scan's gradient: the backward's plain version
`ssd_scan_bwd_plain` against `jax.grad` of sum(y * w) through the
reference's `nn/ssd.ssd_chunked` and against torch autograd of
`ssd_scan_plain`; the plain mirror of the bf16 kernel
(`ssd_scan_bwd_fold_plain`: walks, pass, chunk blocks summing the dB /
dC of a set of heads) against the unsplit one and `jax.grad`; a bf16
split of float32 operands (`trunc_parts`, `split=`) against the card
check's limit; and the wiring of `SSDScan`, the
autograd function of the card's route, with the CUDA launchers swapped
for their plain versions.  Inputs come from numpy.

Tolerance, all float32: each of dx, ddt, dA, dB and dC within 1e-5 of
its largest magnitude (the sums run in other orders; dA sums every
row's dt da, so it carries the most rounding).  The split emulation on
bf16 inputs is held to the card check's own limit, 5e-4 relative RMS
(chip_smoke.SSD_BWD_BF16_RMS).

dt is drawn at a quarter of the forward tests' scale for the parity
cases.  The reference masks its decay matrix with `where(i >= j,
exp(c_i - c_j), 0)`, so once a chunk's decay passes exp(88) the masked
entries overflow and their zero cotangent times inf makes ddt and dA NaN
in `jax.grad` (at zamba2's full width a few % of chunks do).  The port's
`ssd_chunked` takes exp only below the diagonal and its backward never
forms the masked entries; `test_bwd_plain_finite_where_the_reference_
overflows` pins that difference."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssd as j_ssd
from repro_torch.kernels import ssd_scan as ss

REL = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, b, s, h, p, g, n, dt_scale=1.0):
    """float32 numpy x, dt, A, B, C and the output weights w (= dy)."""
    rng = np.random.default_rng(seed)
    arrs = (0.5 * rng.standard_normal((b, s, h, p)),
            dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, h)))),
            -np.exp(0.3 * rng.standard_normal(h)),
            0.3 * rng.standard_normal((b, s, g, n)),
            0.3 * rng.standard_normal((b, s, g, n)),
            rng.standard_normal((b, s, h, p)))
    return [a.astype(np.float32) for a in arrs]


def _close(got, want, label):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b, np.float32)
        a = a.detach().float().numpy()
        assert a.shape == b.shape, (label, name)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * scale,
                                   err_msg=f"{label}: {name}")


def _autograd_plain(t, chunk):
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    y = ss.ssd_scan_plain(*leaves, chunk=chunk)
    return torch.autograd.grad(y, leaves, t[5])


# (b, s, h, p, g, n, dt_scale): ragged s, g = 1 and g > 1, s within one
# chunk, s past a group of 8 chunks (dt small, so the carried state counts)
CASES = [(2, 100, 4, 8, 1, 16, 0.25),
         (1, 150, 4, 8, 2, 16, 0.25),
         (2, 40, 2, 16, 1, 16, 0.25),
         (1, 64, 6, 8, 3, 8, 0.25),
         (1, 581, 2, 8, 1, 16, 0.05)]


@pytest.mark.parametrize("b,s,h,p,g,n,dt_scale", CASES)
def test_bwd_plain_matches_jax_grad(b, s, h, p, g, n, dt_scale):
    arrs = _inputs(b + s + h + g, b, s, h, p, g, n, dt_scale)
    w = jnp.asarray(arrs[5])

    def loss(x, dt, A, B, C):
        return jnp.sum(j_ssd.ssd_chunked(x, dt, A, B, C, chunk=64)[0] * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs[:5]))
    t = [torch.from_numpy(a) for a in arrs]
    got = ss.ssd_scan_bwd_plain(*t, chunk=64)
    _close(got, want, "vs jax.grad")
    _close(got, _autograd_plain(t, 64), "vs autograd")


# mamba2-2.7b's tuned config scans at chunk 128 (and the reference's perf
# variants at 32): s ragged, s under one chunk, s over several
CHUNK_CASES = [(1, 300, 2, 8, 1, 16, 128, 0.25),
               (2, 100, 4, 8, 2, 16, 128, 0.25),
               (1, 581, 2, 8, 1, 16, 128, 0.05),
               (1, 100, 2, 8, 1, 16, 32, 0.25),
               (2, 20, 4, 8, 2, 16, 32, 0.25)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,dt_scale", CHUNK_CASES)
def test_bwd_plain_at_config_chunks_matches_jax_grad(b, s, h, p, g, n, chunk,
                                                     dt_scale):
    arrs = _inputs(chunk + s + h, b, s, h, p, g, n, dt_scale)
    w = jnp.asarray(arrs[5])

    def loss(x, dt, A, B, C):
        return jnp.sum(j_ssd.ssd_chunked(x, dt, A, B, C, chunk=chunk)[0] * w)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs[:5]))
    t = [torch.from_numpy(a) for a in arrs]
    got = ss.ssd_scan_bwd_plain(*t, chunk=chunk)
    _close(got, want, f"chunk {chunk} vs jax.grad")
    _close(got, _autograd_plain(t, chunk), f"chunk {chunk} vs autograd")


def test_bwd_plain_finite_where_the_reference_overflows():
    """At the forward tests' dt scale some chunk decays pass exp(88):
    `jax.grad` of the reference gives NaN in ddt and dA there; the plain
    backward and autograd of the port's plain scan stay finite and
    agree, and dx, dB, dC (which never see the masked decay's cotangent)
    agree with the reference's."""
    arrs = _inputs(9, 2, 100, 4, 8, 1, 16, 1.0)
    w = jnp.asarray(arrs[5])
    want = jax.grad(lambda *a: jnp.sum(j_ssd.ssd_chunked(*a, chunk=64)[0]
                                       * w), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs[:5]))
    t = [torch.from_numpy(a) for a in arrs]
    got = ss.ssd_scan_bwd_plain(*t, chunk=64)
    assert np.isnan(np.asarray(want[1])).any()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close(got, _autograd_plain(t, 64), "vs autograd")
    keep = (0, 3, 4)
    _close([got[i] for i in keep], [want[i] for i in keep], "finite part")


def test_bwd_plain_keeps_the_dtypes():
    """bf16 x / B / C / dy: dx, dB, dC come back bf16, ddt and dA
    float32, one bf16 rounding from the float32 run on the same
    values."""
    t = [torch.from_numpy(a) for a in _inputs(3, 1, 70, 2, 8, 1, 16)]
    low = [x.to(torch.bfloat16) if i in (0, 3, 4, 5) else x
           for i, x in enumerate(t)]
    got = ss.ssd_scan_bwd_plain(*low, chunk=64)
    ref = ss.ssd_scan_bwd_plain(*(x.float() for x in low), chunk=64)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b, rtol=2 ** -8, atol=1e-6)


def test_bwd_rounded_control_differs():
    """The control of the card's bf16 check (W and GE rounded to bf16)
    moves the gradients by far more than float32 rounding."""
    t = [torch.from_numpy(a) for a in _inputs(4, 1, 128, 2, 16, 1, 16)]
    exact = ss.ssd_scan_bwd_plain(*t, chunk=64)
    ctrl = ss.ssd_scan_bwd_plain(*t, chunk=64, rounded=True)
    for name, a, b in zip(NAMES, ctrl, exact):
        if name == "dA":
            continue
        assert float((a - b).abs().max() / b.abs().max()) > 1e-4, name


# (b, s, h, p, g, n, chunk, group): groups of 2 chunks of 8 with a ragged
# tail; the kernel's own chunk 64 and group 8 at three groups
SPLITS = [(2, 61, 4, 8, 2, 8, 8, 2),
          (1, 40, 2, 8, 1, 8, 8, 2),
          (1, 1100, 2, 8, 1, 16, 64, 8)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,group", SPLITS)
def test_bwd_split_plain_matches_unsplit(b, s, h, p, g, n, chunk, group):
    """Launches 1-2's group composition: each group's own state gradient
    and decay, the pass from the last group, then each group from its
    forward state and its outgoing gradient, against the unsplit
    backward (dt x 0.05: the carried state and its gradient count)."""
    t = [torch.from_numpy(a)
         for a in _inputs(s + chunk, b, s, h, p, g, n, 0.05)]
    want = ss.ssd_scan_bwd_plain(*t, chunk=chunk)
    got = ss.ssd_scan_bwd_fold_plain(*t, chunk=chunk, group=group)
    _close(got, [x.numpy() for x in want], "split")
    G = ss.n_groups(s, chunk, group)
    kept = ss.ssd_split_states_plain(*t[:5], chunk=chunk, group=group) \
        .permute(0, 2, 1, 4, 3).contiguous()       # the kernel's layout
    again = ss.ssd_scan_bwd_fold_plain(*t, kept if G > 1 else None,
                                       chunk=chunk, group=group)
    for a, c in zip(got, again):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


# (b, s, h, p, g, n, dt_scale, heads): head sets of the kernel's chunk
# blocks that are whole (h / g = heads), short (h 6 g 3 under 8 heads),
# split with a short last set (12 heads of one group in sets of 5) and
# several sets a group (h 8 g 2 in sets of 2), across groups of chunks
HEAD_SETS = [(1, 64, 6, 8, 3, 8, 0.25, 8),
             (2, 100, 12, 8, 1, 16, 0.25, 5),
             (1, 150, 8, 8, 2, 16, 0.25, 2),
             (1, 581, 4, 8, 1, 16, 0.05, 4)]


@pytest.mark.parametrize("b,s,h,p,g,n,dt_scale,heads", HEAD_SETS)
def test_bwd_split_plain_matches_jax_grad(b, s, h, p, g, n, dt_scale,
                                          heads):
    """The bf16 kernel's plain mirror (walks from each group's state and
    from a zero gradient, the pass, each chunk from its state and dS' =
    local + decay x its group's gradient, dB / dC summed over sets of
    `heads`) against `jax.grad` of the reference."""
    arrs = _inputs(b * s + h + heads, b, s, h, p, g, n, dt_scale)
    w = jnp.asarray(arrs[5])
    want = jax.grad(lambda *a: jnp.sum(j_ssd.ssd_chunked(*a, chunk=64)[0]
                                       * w), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrs[:5]))
    t = [torch.from_numpy(a) for a in arrs]
    _close(ss.ssd_scan_bwd_fold_plain(*t, chunk=64, heads=heads), want,
           "split vs jax.grad")


def test_head_sets_sum_each_group_in_order():
    """`head_sets`: (b, s, h, n) rows to (b, s, g, nsplit, n), each set
    the sum of its own heads of one B/C group, the short last set padded
    with nothing but zeros."""
    t = torch.arange(2 * 3 * 12 * 4, dtype=torch.float32).reshape(2, 3, 12, 4)
    got = ss.head_sets(t, 2, 4)                  # 6 heads a group: 4 + 2
    assert got.shape == (2, 3, 2, 2, 4)
    torch.testing.assert_close(got[:, :, 0, 0], t[:, :, 0:4].sum(2))
    torch.testing.assert_close(got[:, :, 0, 1], t[:, :, 4:6].sum(2))
    torch.testing.assert_close(got[:, :, 1, 1], t[:, :, 10:12].sum(2))
    torch.testing.assert_close(got.sum(3), t.reshape(2, 3, 2, 6, 4).sum(3))


def test_bwd_rows_sum_heads_in_the_bf16_kernel():
    """The rows of float32 dB / dC the backward kernel writes a position:
    one a head in float32; in bf16 one a block of `BWD_HEADS` heads of a
    B/C group (the kernel sums them), so never one a head where a group
    has more heads than one."""
    assert ss.BWD_HEADS == 8
    for h, g, want in ((64, 1, 8), (80, 1, 10), (6, 3, 3), (8, 2, 2),
                       (20, 1, 3), (2, 1, 1)):
        assert ss.bwd_rows(h, g, torch.float32) == h
        assert ss.bwd_rows(h, g, torch.bfloat16) == want


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_split_parts_reconstruct(parts):
    """The kernel's split of a float32 operand into bf16 parts, each the
    top 8 significant bits of what the parts before leave (`trunc_parts`):
    with three, the parts sum back to every value bit for bit (over
    float32's normal range, signs and exponents mixed); with fewer, the
    remainder is under one spacing of the last part: 2^-(7 parts) of the
    value (a truncation leaves less than its last bit's weight)."""
    rng = np.random.default_rng(parts)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-30, 30, 4096))
                         .astype(np.float32))
    got = ss.trunc_parts(v, parts)
    assert len(got) == parts
    assert all(torch.equal(q, q.to(torch.bfloat16).float()) for q in got)
    total = got[0]
    for q in got[1:]:
        total = total + q
    if parts == 3:
        assert torch.equal(total, v)
    rel = ((total - v).abs() / v.abs()).max()
    assert float(rel) < 2.0 ** -(7 * parts)


# phase 23 c's SSD_BWD_SHAPES (name, b, s, h, g, n, dt scale) and its
# bf16 limit SSD_BWD_BF16_RMS: the widths, the ragged tail, the one group
# and g = 2 as the card checks them; the batch cut to 1 and the prefill
# length 4096 to 1024 for the CPU's time (a relative RMS over rows does
# not depend on their count)
PHASE_23C = (("zamba2", 1, 1024, 64, 1, 64, 1.0),
             ("mamba2-2.7b", 1, 1024, 80, 1, 128, 1.0),
             ("ragged", 1, 1000, 64, 1, 64, 0.05),
             ("one group", 1, 500, 64, 1, 64, 0.05),
             ("g=2", 1, 1100, 8, 2, 128, 0.05))
BF16_RMS = 5e-4


def _rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt()
                 / b.square().mean().sqrt().clamp_min(1e-30))


@functools.lru_cache(maxsize=1)
def _phase_23c(i):
    """bf16 inputs at phase 23 c's shape i (its scales, drawn with numpy),
    the unsplit plain backward and the rounded control's."""
    _, b, s, h, g, n, dt_scale = PHASE_23C[i]
    arrs = _inputs(i, b, s, h, 64, g, n, dt_scale)
    t = [torch.from_numpy(a).to(torch.bfloat16) if k in (0, 3, 4, 5)
         else torch.from_numpy(a) for k, a in enumerate(arrs)]
    return (t, ss.ssd_scan_bwd_plain(*t, chunk=64),
            ss.ssd_scan_bwd_plain(*t, chunk=64, rounded=True))


@pytest.fixture
def two_threads():
    """Hold torch to two threads for the test: the suite runs several
    workers at once, and wall-clock tests elsewhere feel the load."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("parts", [3, 2])
@pytest.mark.parametrize("i", range(len(PHASE_23C)))
def test_bwd_split_emulation_within_the_bf16_limit(two_threads, i, parts):
    """The bf16 kernel's arithmetic in plain PyTorch (every operand it
    splits taken as the sum of its bf16 parts) stays within the card
    check's 5e-4 relative RMS of the unsplit plain version on each
    gradient at phase 23 c's widths, and the rounded control (W and GE
    one bf16 each) does not on dx, dB and dC: three parts are the
    float32 operand itself."""
    t, want, ctrl = _phase_23c(i)
    got = ss.ssd_scan_bwd_plain(*t, chunk=64, split=parts)
    rms = [_rel_rms(a, w) for a, w in zip(got, want)]
    assert max(rms) <= BF16_RMS, (PHASE_23C[i][0], rms)
    if parts == 3:
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert min(_rel_rms(ctrl[k], want[k]) for k in (0, 3, 4)) > BF16_RMS


def _plain_launchers(monkeypatch, asked=None):
    """Swap the CUDA launchers for their plain versions, counting as the
    launchers count; `asked` records whether each forward asked for the
    group states."""
    def fwd(x, dt, A, B, C, *, states=False):
        chunk = ss.TILE
        ss.LAUNCHES += ss.kernel_launches(x.shape[1])
        if asked is not None:
            asked.append(states)
        y = ss.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        if not states:
            return y
        if ss.n_groups(x.shape[1]) == 1:
            return y, None
        return y, ss.ssd_split_states_plain(x, dt, A, B, C, chunk=chunk) \
            .permute(0, 2, 1, 4, 3).contiguous()

    def bwd(x, dt, A, B, C, dy, states):
        ss.BWD_LAUNCHES += 1
        return ss.ssd_scan_bwd_fold_plain(x, dt, A, B, C, dy, states,
                                          chunk=ss.TILE)

    monkeypatch.setattr(ss, "_ssd_cuda", fwd)
    monkeypatch.setattr(ss, "_ssd_bwd_cuda", bwd)


@pytest.mark.parametrize("b,s,h,p,g,n,dt_scale", CASES)
def test_ssd_autograd_function_wiring(monkeypatch, b, s, h, p, g, n,
                                      dt_scale):
    """`SSDScan` (the forward asking for its group states, saved tensors,
    the backward on dy as it comes, one count each) gives autograd's
    gradients of the plain version."""
    asked = []
    _plain_launchers(monkeypatch, asked)
    t = [torch.from_numpy(a)
         for a in _inputs(7 + s, b, s, h, p, g, n, dt_scale)]
    want = _autograd_plain(t, 64)
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    y = ss.SSDScan.apply(*leaves)
    # a non-contiguous output gradient reaches the backward as it is (its
    # wrapper copies what the kernel's maps cannot read)
    y.backward(t[5].transpose(1, 2).contiguous().transpose(1, 2))
    assert ss.LAUNCHES - f0 == ss.kernel_launches(s)
    assert ss.BWD_LAUNCHES - b0 == 1 and asked == [True]
    _close([x.grad for x in leaves], [x.numpy() for x in want], "SSDScan")


def _recording_launchers(monkeypatch, dims):
    """Swap the ctypes launchers for their plain versions at the chunk
    they are handed (float32 only), recording the int arguments each
    launch gets: what `_call` passes to csrc/ssd_scan*.cu."""
    monkeypatch.setattr(ss, "_lib", lambda entry="ssd_scan_launch": entry)
    monkeypatch.setattr(ss, "_bwd_lib", lambda: "ssd_scan_bwd_launch")

    def call(fn, tensors, d, what):
        dims.append((fn, d))
        tile, group = d[6], d[7]
        if fn == "ssd_scan_launch":
            x, dt, A, B, C, y, st, _ = tensors
            y.copy_(ss.ssd_scan_plain(x, dt, A, B, C, chunk=tile))
            if st is not None:
                st.copy_(ss.ssd_split_states_plain(
                    x, dt, A, B, C, chunk=tile, group=group)
                    .permute(0, 2, 1, 4, 3))
            return
        x, dt, A, B, C, dy, st, *_, dx, ddt, dBp, dCp, dAp = tensors
        grads = ss.ssd_scan_bwd_fold_plain(x, dt, A, B, C, dy, st,
                                           chunk=tile, group=group)
        b, s, h, _ = x.shape
        g, n = B.shape[2], B.shape[3]
        dx.copy_(grads[0])
        ddt.copy_(grads[1])
        dAp.zero_()
        dAp[0, :, 0] = grads[2]
        for rows, d_ in ((dBp, grads[3]), (dCp, grads[4])):
            rows.zero_()
            rows.view(b, s, g, h // g, n)[:, :, :, 0] = d_

    monkeypatch.setattr(ss, "_call", call)


@pytest.mark.parametrize("chunk", [128, 64, 32])
def test_ssd_card_route_runs_the_tile_at_any_chunk(monkeypatch, chunk):
    """A scan asked for at any chunk reaches both launchers with the
    kernels' tile (64), counts the launches of chunk 64, and gives the
    plain version's y and gradients at the chunk asked for (the chunk
    orders the sums, not the function)."""
    dims = []
    _recording_launchers(monkeypatch, dims)
    b, s, h, p, g, n = 1, 600, 2, 64, 1, 64
    t = [torch.from_numpy(a) for a in _inputs(3, b, s, h, p, g, n, 0.05)]
    want_y = ss.ssd_scan_plain(*t[:5], chunk=chunk)
    want = _autograd_plain(t, chunk)
    leaves = [x.clone().requires_grad_() for x in t[:5]]
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    y = ss.SSDScan.apply(*leaves)
    y.backward(t[5])
    assert (ss.LAUNCHES - f0, ss.BWD_LAUNCHES - b0) == \
        (ss.kernel_launches(s), 1) == (3, 1)
    assert [(fn, d[:9]) for fn, d in dims] == [
        (fn, (b, s, h, p, g, n, 64, ss.GROUP_CHUNKS, 0))
        for fn in ("ssd_scan_launch", "ssd_scan_bwd_launch")]
    # the element strides of x, B, C (head or group, row, batch), and the
    # backward's of dy: dense, as float32 launches take them
    dense = (p, h * p, s * h * p, n, g * n, s * g * n, n, g * n, s * g * n)
    assert [d[9:] for _, d in dims] == [dense, dense + (p, h * p, s * h * p)]
    np.testing.assert_allclose(y.detach().numpy(), want_y.numpy(),
                               atol=1e-4, rtol=1e-4)
    _close([x.grad for x in leaves], [x.numpy() for x in want],
           f"tile at chunk {chunk}")
    dims.clear()
    y2 = ss._ssd_cuda(*t[:5])
    assert torch.equal(y2, y.detach()) and len(dims) == 1 \
        and dims[0][1][6] == ss.TILE


def test_ssd_autograd_survives_checkpoint(monkeypatch):
    """Under non-reentrant activation checkpointing the forward runs (and
    counts) again in the backward pass; the gradients are unchanged."""
    from torch.utils.checkpoint import checkpoint
    _plain_launchers(monkeypatch)
    t = [torch.from_numpy(a) for a in _inputs(5, 1, 600, 4, 8, 2, 16, 0.05)]

    def f(*ins):
        return ss.SSDScan.apply(*ins) * 2.0

    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in t[:5]]
        f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
        y = checkpoint(f, *leaves, use_reentrant=False) if remat \
            else f(*leaves)
        y.backward(t[5])
        assert (ss.LAUNCHES - f0, ss.BWD_LAUNCHES - b0) == \
            ((6 if remat else 3), 1)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _CudaLike:
    """What the dispatch reads of a CUDA tensor: its device type and
    whether it requires a gradient."""
    device = torch.device("cuda")
    shape = (1, 64, 2, 64)

    def __init__(self, requires_grad: bool):
        self.requires_grad = requires_grad


def test_ssd_dispatch_routes_grads_through_the_function(monkeypatch):
    """CUDA inputs go through `SSDScan` when autograd needs a gradient of
    any of them, to the forward launch alone otherwise (no grad required,
    or grad mode off), asking for no group states; CPU inputs take the
    plain version."""
    calls = []
    monkeypatch.setattr(ss, "_check", lambda *a: None)
    monkeypatch.setattr(ss, "_ssd_cuda", lambda *a, **kw: calls.append(
        ("forward", len(a), kw.get("states", False))))
    monkeypatch.setattr(ss.SSDScan, "apply",
                        lambda *a: calls.append(("autograd", len(a))))
    for i in range(5):
        ins = [_CudaLike(j == i) for j in range(5)]
        ss.ssd_scan(*ins, chunk=64)
        with torch.no_grad():
            ss.ssd_scan(*ins, chunk=128)
    ss.ssd_scan(*[_CudaLike(False) for _ in range(5)], chunk=128)
    # the five inputs alone: the caller's chunk never reaches the card
    assert calls == [("autograd", 5), ("forward", 5, False)] * 5 \
        + [("forward", 5, False)]
    t = [torch.from_numpy(a) for a in _inputs(1, 1, 30, 2, 8, 1, 8)]
    y = ss.ssd_scan(t[0].requires_grad_(), *t[1:5], chunk=64)
    assert y.grad_fn is not None and len(calls) == 11
