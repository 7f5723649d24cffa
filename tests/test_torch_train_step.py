"""Port parity of the training step: each family's `loss_fn` value and
every gradient against `jax.value_and_grad` of the reference's on the
smoke configs, one `make_train_step` against the reference's, the flash
backward's plain version against autograd of the plain forward, the
autograd function's wiring (with the CUDA launchers swapped for their
plain versions), the SSD family's loss through the SSD's card route
(`SSDScan`, launchers swapped the same way), the day scan's guard (the
one kernel without a backward), and the seed contract of the inits
(every draw on a CPU generator, then moved).

Both packages get the same numpy weights (`convert.lm_params_numpy`) and
the same batch.  Tolerances, all float32: the loss within 1e-5 relative;
each gradient leaf within 2e-5 of its largest magnitude (the two
frameworks sum products, softmaxes and the cross-entropy chunks in other
orders, and the backward passes differ in their association); the MoE's
expert choice is discrete and taken on the same logits in both, so its
gradients are held the same way.  The flash backward's plain version
against autograd: 2e-6 of each gradient's largest magnitude."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.models import registry as j_reg
from repro_torch import convert
from repro_torch import tree as t_tree
from repro_torch.kernels import day_scan as ds
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import guard
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_reg
from repro_torch.nn import core as t_core

LOSS_RTOL = 1e-5
GRAD_REL = 2e-5
ARCHS = ("olmo-1b", "gemma3-4b", "moonshot-v1-16b-a3b", "phi-3-vision-4.2b",
         "zamba2-1.2b", "mamba2-2.7b", "whisper-medium")
B, S = 2, 32                     # S past gemma3 smoke's window of 16


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    mask[1, :3] = 0.0
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_embed_dim)).astype(np.float32)
    return batch


def _setup(arch):
    jcfg, jmodel = j_reg.get(arch, smoke=True)
    tcfg, tmodel = t_reg.get(arch, smoke=True)
    tree = convert.lm_params_numpy(tcfg, seed=11)
    batch = _batch(tcfg)
    return {"jcfg": jcfg, "jmodel": jmodel, "tcfg": tcfg, "tmodel": tmodel,
            "jp": jax.tree.map(jnp.asarray, tree),
            "tp": convert.lm_params_from_numpy(tree, tcfg, device="cpu"),
            "jb": {k: jnp.asarray(v) for k, v in batch.items()},
            "tb": {k: torch.from_numpy(v) for k, v in batch.items()}}


def _close_grads(tg, jg):
    t_leaves, j_leaves = t_tree.leaves(tg), jax.tree.leaves(jg)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=GRAD_REL * scale)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad(arch, remat):
    lm = _setup(arch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: lm["jmodel"].loss_fn(p, lm["jcfg"], lm["jb"], env=None,
                                       remat=False))(lm["jp"])
    tloss, tgrads = t_steps.value_and_grad(
        lambda p: lm["tmodel"].loss_fn(p, lm["tcfg"], lm["tb"], remat=remat),
        lm["tp"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _close_grads(tgrads, jgrads)
    # value_and_grad leaves the parameters as they were
    assert not any(t.requires_grad for t in t_tree.leaves(lm["tp"]))


def test_moe_aux_enters_the_loss():
    """moonshot's loss is the cross-entropy plus moe_aux_weight x aux."""
    lm = _setup("moonshot-v1-16b-a3b")
    cfg0 = dataclasses.replace(lm["tcfg"], moe_aux_weight=0.0)
    with torch.no_grad():
        full = lm["tmodel"].loss_fn(lm["tp"], lm["tcfg"], lm["tb"])
        ce = lm["tmodel"].loss_fn(lm["tp"], cfg0, lm["tb"])
        _, aux = lm["tmodel"].forward(lm["tp"], lm["tcfg"],
                                      lm["tb"]["tokens"])
    assert float(aux) > 0
    torch.testing.assert_close(full, ce + lm["tcfg"].moe_aux_weight * aux)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-medium"])
def test_train_step_matches_reference(arch):
    lm = _setup(arch)
    from repro.training import optimizer as j_opt
    from repro_torch.training import optimizer as t_opt
    jstep = j_steps.make_train_step(lm["jcfg"], lm["jmodel"], None)
    tstep = t_steps.make_train_step(lm["tcfg"], lm["tmodel"])
    jp, jo, jm = jstep(lm["jp"], j_opt.init(lm["jp"]), lm["jb"])
    tp, to, tm = tstep(lm["tp"], t_opt.init(lm["tp"]), lm["tb"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    # lr 3e-7 at step 1 of the default warmup: the parameters move by
    # ~1e-7, so the update is held to 1e-6 of each leaf's magnitude
    for a, b in zip(t_tree.leaves(tp), jax.tree.leaves(jp)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * max(float(np.abs(b).max()),
                                                   1e-30))
    _close_grads(to["m"], jo["m"])
    assert int(to["count"]) == int(jo["count"]) == 1


def test_chunked_softmax_xent_matches_reference():
    from repro.nn import core as j_core
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    h = rng.standard_normal((2, 24, 16)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    mask = (rng.uniform(size=(2, 24)) > 0.3).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        for chunk in (8, 24):
            got = t_core.chunked_softmax_xent(
                torch.from_numpy(table), torch.from_numpy(h),
                torch.from_numpy(labels),
                None if m is None else torch.from_numpy(m), chunk=chunk)
            want = j_core.chunked_softmax_xent(
                jnp.asarray(table), jnp.asarray(h), jnp.asarray(labels),
                None if m is None else jnp.asarray(m), chunk=chunk)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(AssertionError):
        t_core.chunked_softmax_xent(torch.from_numpy(table),
                                    torch.from_numpy(h),
                                    torch.from_numpy(labels), chunk=7)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_activations_match_reference(activation, gated):
    from repro.nn import core as j_core
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((8, 16)).astype(np.float32),
         "wo": rng.standard_normal((16, 8)).astype(np.float32)}
    if gated:
        p["wg"] = rng.standard_normal((8, 16)).astype(np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    got = t_core.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), activation=activation)
    want = j_core.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    init = t_core.mlp_init(torch.Generator().manual_seed(0), 8, 16,
                           torch.float32, gated=gated, device="cpu")
    assert set(init) == set(p)


# ---------------------------------------------------------------------------
# the flash backward's plain version and the autograd function
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Sq, Sk, H, KvH, Dh, causal, window
    (2, 130, 130, 4, 4, 64, True, None),       # causal, ragged
    (1, 150, 150, 8, 2, 128, True, 40),        # GQA 4:1 + window
    (2, 100, 100, 4, 1, 64, False, None),      # bidirectional, GQA 4:1
    (1, 70, 150, 4, 2, 96, True, None),        # Sq < Sk causal
    (1, 150, 70, 2, 2, 64, False, None),       # Sq > Sk bidirectional
    (1, 90, 150, 4, 4, 64, False, 20),         # window without causal
    (1, 100, 100, 4, 2, 256, True, 5),         # Dh 256, window < a tile
    (1, 37, 37, 2, 2, 96, True, None),         # below one tile
]


def _qkv(B, Sq, Sk, H, KvH, Dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, Sq, H, Dh), generator=g),
            torch.randn((B, Sk, KvH, Dh), generator=g),
            torch.randn((B, Sk, KvH, Dh), generator=g),
            torch.randn((B, Sq, H, Dh), generator=g))


def _autograd_plain(q, k, v, do, causal, window):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    o.backward(do)
    return o.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", FLASH_CASES)
def test_flash_bwd_plain_matches_autograd(B, Sq, Sk, H, KvH, Dh, causal,
                                          window):
    q, k, v, do = _qkv(B, Sq, Sk, H, KvH, Dh)
    o, want = _autograd_plain(q, k, v, do, causal, window)
    lse = fa.flash_attention_lse_plain(q, k, causal=causal, window=window)
    assert lse.shape == (B, H, Sq)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-6 * float(b.abs().max()))


def _rounded_bwd(q, k, v, o, do, lse, causal, window, rounded=True):
    """The backward in float32, untiled, from bf16 inputs: P rounded to
    bf16 before dV's product and dS before dQ's and dK's (`rounded`), as
    the bf16 kernel rounds its tensor-core operands, or neither."""
    B, Sq, H, Dh = q.shape
    Sk, KvH = k.shape[1], k.shape[2]
    G = H // KvH
    scale = 1.0 / math.sqrt(Dh)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if rounded \
        else (lambda t: t)
    qf, dof, of = (t.float().reshape(B, Sq, KvH, G, Dh) for t in (q, do, o))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    qi = torch.arange(Sq)[:, None]
    kj = torch.arange(Sk)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    p = torch.where(ok, torch.exp(s - lse.reshape(B, KvH, G, Sq, 1)), 0.0)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = rnd(p * (dp - delta))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dof)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return dq.reshape(B, Sq, H, Dh), dk, dv


def test_flash_bwd_plain_bf16_keeps_the_dtype():
    q, k, v, do = (t.to(torch.bfloat16) for t in _qkv(1, 64, 64, 2, 2, 64))
    o = fa.flash_attention_plain(q, k, v)
    lse = fa.flash_attention_lse_plain(q, k)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert all(g.dtype == torch.bfloat16 for g in got)
    ref = _rounded_bwd(q, k, v, o, do, lse, True, None)
    for a, b in zip(got, ref):          # one bf16 rounding of the result
        torch.testing.assert_close(a.float(), b, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", [
    (1, 150, 150, 4, 2, 64, True, 40),
    (1, 100, 100, 4, 2, 256, True, None),
    (1, 70, 130, 2, 2, 96, False, None),
])
def test_flash_bwd_plain_rounds_p_and_ds_like_the_kernel(B, Sq, Sk, H, KvH,
                                                         Dh, causal, window):
    """In bf16 the plain version rounds P before dV's product and dS
    before dQ's and dK's, once each, as the kernel does: its gradients
    are one bf16 rounding from that computation's, and further than that
    from the same computation without the two roundings (the control)."""
    q, k, v, do = (t.to(torch.bfloat16)
                   for t in _qkv(B, Sq, Sk, H, KvH, Dh, seed=3))
    o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    lse = fa.flash_attention_lse_plain(q, k, causal=causal, window=window)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    want = _rounded_bwd(q, k, v, o, do, lse, causal, window)
    unrounded = _rounded_bwd(q, k, v, o, do, lse, causal, window, False)
    for a, b, c in zip(got, want, unrounded):
        torch.testing.assert_close(a.float(), b, rtol=2 ** -8, atol=1e-6)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(a.float(), c, rtol=2 ** -8, atol=1e-6)


def _plain_launchers(monkeypatch):
    """Swap the CUDA launchers for their plain versions, counting calls as
    the launchers count launches."""
    def fwd(q, k, v, *, causal=True, window=None, scale=None, lse=False):
        fa.LAUNCHES += 1
        o = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
        if not lse:
            return o
        return o, fa.flash_attention_lse_plain(q, k, causal=causal,
                                               window=window, scale=scale)

    def bwd(q, k, v, o, do, lse, **kw):
        assert do.is_contiguous()
        fa.BWD_LAUNCHES += 1
        return fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)

    monkeypatch.setattr(fa, "_flash_cuda", fwd)
    monkeypatch.setattr(fa, "_flash_bwd_cuda", bwd)


@pytest.mark.parametrize("B,Sq,Sk,H,KvH,Dh,causal,window", FLASH_CASES[:4])
def test_flash_autograd_function_wiring(monkeypatch, B, Sq, Sk, H, KvH, Dh,
                                        causal, window):
    """`FlashAttention` (forward with lse, saved tensors, backward on a
    contiguous dO, one count each) gives autograd's gradients."""
    _plain_launchers(monkeypatch)
    q, k, v, do = _qkv(B, Sq, Sk, H, KvH, Dh, seed=1)
    _, want = _autograd_plain(q, k, v, do, causal, window)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    o = fa.FlashAttention.apply(qg, kg, vg, causal, window, None)
    # a non-contiguous output gradient reaches the kernel contiguous
    o.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
    assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == (1, 1)
    for a, b in zip((qg.grad, kg.grad, vg.grad), want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-6 * float(b.abs().max()))


def test_flash_autograd_survives_checkpoint(monkeypatch):
    """Under non-reentrant activation checkpointing the forward runs (and
    counts) again in the backward pass; the gradients are unchanged."""
    from torch.utils.checkpoint import checkpoint
    _plain_launchers(monkeypatch)
    q, k, v, do = _qkv(1, 96, 96, 4, 2, 64, seed=2)

    def f(q, k, v):
        return fa.FlashAttention.apply(q, k, v, True, None, None) * 2.0

    grads = []
    for remat in (False, True):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
        o = checkpoint(f, qg, kg, vg, use_reentrant=False) if remat \
            else f(qg, kg, vg)
        o.backward(do)
        assert (fa.LAUNCHES - f0, fa.BWD_LAUNCHES - b0) == \
            (2 if remat else 1, 1)
        grads.append((qg.grad, kg.grad, vg.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _CudaLike:
    """What the dispatch reads of a CUDA tensor: its device type and
    whether it requires a gradient."""
    device = torch.device("cuda")

    def __init__(self, requires_grad: bool):
        self.requires_grad = requires_grad


def test_flash_dispatch_routes_grads_through_the_function(monkeypatch):
    """CUDA inputs go through the autograd function when autograd needs
    their gradient, to the forward launch alone otherwise (no grad
    required, or grad mode off); CPU inputs take the plain version."""
    calls = []
    monkeypatch.setattr(fa, "_check", lambda *a: None)
    monkeypatch.setattr(fa, "_flash_cuda",
                        lambda *a, **kw: calls.append("forward"))
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: calls.append("autograd"))
    for grad in (True, False):
        q = _CudaLike(grad)
        fa.flash_attention(q, _CudaLike(False), _CudaLike(False))
        with torch.no_grad():
            fa.flash_attention(q, _CudaLike(False), _CudaLike(False))
    assert calls == ["autograd", "forward", "forward", "forward"]
    q, k, v, _ = _qkv(1, 8, 8, 2, 2, 64)
    o = fa.flash_attention(q.requires_grad_(), k, v)
    assert o.grad_fn is not None and len(calls) == 4


# ---------------------------------------------------------------------------
# the day scan has no backward: its launcher raises
# ---------------------------------------------------------------------------

def test_guard_raises_only_for_grad_inputs():
    x = torch.zeros(3)
    guard.refuse_grad("k", x, {"a": {"b": x}}, [x])          # no grad: fine
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        guard.refuse_grad("k", x, {"a": {"b": w}})
    with pytest.raises(RuntimeError, match="k: an input requires"):
        guard.refuse_grad("k", [x, (w,)])
    with torch.no_grad():
        guard.refuse_grad("k", w)                  # autograd records nothing


def test_day_scan_kernel_refuses_grad_inputs():
    from torch_day_tables import random_tables
    tables = random_tables(3, 20, 2, 0, "cpu")
    tables["step_mw"] = tables["step_mw"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="day_scan: .*ROADMAP.md"):
        ds._day_scan_cuda(tables)
    tables["const"] = {k: v.clone().requires_grad_() if i == 0 else v
                       for i, (k, v) in enumerate(tables["const"].items())}
    tables["step_mw"] = tables["step_mw"].detach()
    with pytest.raises(RuntimeError, match="day_scan"):
        ds._day_scan_cuda(tables, full=True)


# ---------------------------------------------------------------------------
# the SSD family's loss through the SSD's card route
# ---------------------------------------------------------------------------

def _plain_ssd_route(monkeypatch):
    """Send every SSD scan through `SSDScan` (the card's route for inputs
    that need a gradient) with its CUDA launchers swapped for their plain
    versions, counting calls as the launchers count."""
    def fwd(x, dt, A, B, C, *, states=False):
        chunk = ss.TILE
        ss.LAUNCHES += ss.kernel_launches(x.shape[1])
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
    monkeypatch.setattr(ss, "ssd_scan",
                        lambda x, dt, A, B, C, *, chunk=64:
                        ss.SSDScan.apply(x, dt, A, B, C))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_ssm_loss_through_the_ssd_route_matches_the_cpu_path(monkeypatch,
                                                             arch):
    """The loss and every gradient with each mamba layer's scan through
    `SSDScan` (one forward with its group states and one backward call a
    layer) equal the CPU path's (autograd of the plain scan) within the
    float32 tolerance."""
    lm = _setup(arch)
    loss_of = lambda p: lm["tmodel"].loss_fn(  # noqa: E731
        p, lm["tcfg"], lm["tb"], remat=False)
    want_loss, want = t_steps.value_and_grad(loss_of, lm["tp"])
    _plain_ssd_route(monkeypatch)
    f0, b0 = ss.LAUNCHES, ss.BWD_LAUNCHES
    loss, grads = t_steps.value_and_grad(loss_of, lm["tp"])
    n = lm["tcfg"].n_layers
    assert ss.BWD_LAUNCHES - b0 == n
    assert ss.LAUNCHES - f0 == n * ss.kernel_launches(S)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for a, b in zip(t_tree.leaves(grads), t_tree.leaves(want)):
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_REL * scale)
    mamba = grads["layers"]["mamba"]
    for key in ("A_log", "dt_bias", "in_proj", "conv_w", "out_proj"):
        assert all(bool((mamba[key][i] != 0).any()) for i in range(n)), key


# ---------------------------------------------------------------------------
# seeds: every init draws on a CPU generator and moves the result
# ---------------------------------------------------------------------------

FAMILIES = ("olmo-1b", "moonshot-v1-16b-a3b", "phi-3-vision-4.2b",
            "zamba2-1.2b", "mamba2-2.7b", "whisper-medium")


def _record_draws(monkeypatch):
    """Wrap the draws the inits use, recording each one's tensor and
    generator devices."""
    seen = []
    trunc, rand, randn = torch.nn.init.trunc_normal_, torch.rand, torch.randn

    def rec_trunc(x, *a, generator=None, **kw):
        seen.append((x.device.type, generator.device.type))
        return trunc(x, *a, generator=generator, **kw)

    def rec(fn):
        def draw(*a, generator=None, **kw):
            out = fn(*a, generator=generator, **kw)
            seen.append((out.device.type, generator.device.type))
            return out
        return draw

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", rec_trunc)
    monkeypatch.setattr(torch, "rand", rec(rand))
    monkeypatch.setattr(torch, "randn", rec(randn))
    return seen


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_draws_on_the_host_whatever_the_device(monkeypatch, arch):
    """`init` for another device (here "meta", which holds no values)
    draws every value on the CPU generator it is given and moves the
    result; the same seed on the CPU gives the weights it gave before
    the draws moved to the host (the goldens and training tests hold
    those values)."""
    cfg, model = t_reg.get(arch, smoke=True)
    seen = _record_draws(monkeypatch)
    params = model.init(torch.Generator().manual_seed(0), cfg, "meta")
    assert seen and set(seen) == {("cpu", "cpu")}
    assert {x.device.type for x in t_tree.leaves(params)} == {"meta"}
    cpu = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    again = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for a, b, m in zip(t_tree.leaves(cpu), t_tree.leaves(again),
                       t_tree.leaves(params)):
        assert torch.equal(a, b) and a.shape == m.shape and a.dtype == m.dtype


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-medium"])
def test_side_inputs_draw_on_the_host(monkeypatch, arch):
    from repro_torch.launch import train as t_train
    cfg, _ = t_reg.get(arch, smoke=True)
    want = t_train.side_inputs(cfg, 2, 3, "cpu")
    seen = _record_draws(monkeypatch)
    got = t_train.side_inputs(cfg, 2, 3, "meta")
    assert seen == [("cpu", "cpu")]
    (k, v), = got.items()
    assert v.device.type == "meta" and v.shape == want[k].shape


class _CardGenerator:
    """What an init reads of a generator on the card: its device."""
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_refuses_a_generator_off_the_host(arch):
    cfg, model = t_reg.get(arch, smoke=True)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        model.init(_CardGenerator(), cfg, "cpu")
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        t_core.trunc_normal(_CardGenerator(), (2, 2), torch.float32, 1.0,
                            "cpu")
