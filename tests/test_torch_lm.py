"""Port parity of the Mamba2 / Zamba2 serving path: configs, forward,
prefill step, decode steps with every cache entry, the Mamba2 block's
step against its sequence form, and the serving engine, against the JAX
reference on the zamba2 and mamba2 smoke configs in float32.

Both packages get the same weights (`convert.lm_params_numpy`, seeded
numpy) and the same tokens.  Tolerance: 1e-5 relative to the largest
magnitude for hidden states and logits (float32 sums in another order);
token ids exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as j_steps
from repro.models import registry as j_reg
from repro.nn import ssd as j_ssd
from repro.serving import engine as j_engine
from repro_torch import convert
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_reg
from repro_torch.nn import ssd as t_ssd
from repro_torch.serving import engine as t_engine

ARCHS = ("zamba2-1.2b", "mamba2-2.7b")
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    jcfg, jmodel = j_reg.get(arch, smoke=True)
    tcfg, tmodel = t_reg.get(arch, smoke=True)
    tree = convert.lm_params_numpy(tcfg, seed=3)
    return {"arch": arch, "jcfg": jcfg, "jmodel": jmodel, "tcfg": tcfg,
            "tmodel": tmodel, "tree": tree,
            "jp": jax.tree.map(jnp.asarray, tree),
            "tp": convert.lm_params_from_numpy(tree, tcfg, device="cpu"),
            "tokens": np.random.default_rng(4).integers(
                0, tcfg.vocab, (2, 21))}


def test_configs_match_reference(lm):
    j, t = lm["jcfg"], lm["tcfg"]
    for f in dataclasses.fields(t):
        if f.name not in ("param_dtype", "compute_dtype", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    assert str(t.compute_dtype).split(".")[-1] == jnp.dtype(
        j.compute_dtype).name
    assert t.n_params == j.n_params
    full_t, _ = t_reg.get(lm["arch"])
    full_j, _ = j_reg.get(lm["arch"])
    assert full_t.n_params == full_j.n_params


def test_numpy_params_have_reference_tree(lm):
    want = jax.eval_shape(lambda: lm["jmodel"].init(jax.random.PRNGKey(0),
                                                    lm["jcfg"]))
    got = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       lm["jp"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    # the port's own initializer (torch.Generator) builds the same tree
    port = lm["tmodel"].init(torch.Generator().manual_seed(0), lm["tcfg"],
                            device="cpu")
    shapes = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype)[6:])), port)
    assert jax.tree.structure(shapes) == jax.tree.structure(want)
    assert jax.tree.leaves(shapes) == jax.tree.leaves(want)
    ht, _ = lm["tmodel"].forward(port, lm["tcfg"],
                                 torch.as_tensor(lm["tokens"]))
    assert torch.isfinite(ht).all()


def test_forward_and_prefill_match(lm):
    toks = lm["tokens"]
    hj, _ = lm["jmodel"].forward(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                 remat=False)
    ht, aux = lm["tmodel"].forward(lm["tp"], lm["tcfg"],
                                   torch.as_tensor(toks))
    _close(ht, hj)
    assert float(aux) == 0.0
    pj = j_steps.make_prefill_step(lm["jcfg"], lm["jmodel"], None)(
        lm["jp"], {"tokens": jnp.asarray(toks)})
    pt = t_steps.make_prefill_step(lm["tcfg"], lm["tmodel"])(
        lm["tp"], {"tokens": torch.as_tensor(toks)})
    _close(pt, pj)


def test_forward_goes_through_the_kernel_dispatches(lm, monkeypatch):
    """Every mamba layer's scan goes through `kernels.ssd_scan.ssd_scan`
    and every shared-block attention through `kernels.flash_attention.
    flash_attention`: the calls that launch the kernels on the card."""
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss
    calls = {"ssd": 0, "flash": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ss, "ssd_scan", counted("ssd", ss.ssd_scan))
    monkeypatch.setattr(fa, "flash_attention",
                        counted("flash", fa.flash_attention))
    cfg = lm["tcfg"]
    lm["tmodel"].forward(lm["tp"], cfg, torch.as_tensor(lm["tokens"]))
    want_flash = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert calls == {"ssd": cfg.n_layers, "flash": want_flash}


def test_three_decode_steps_match(lm):
    jc = lm["jmodel"].init_cache(lm["jcfg"], 2, 16, jnp.float32)
    tc = lm["tmodel"].init_cache(lm["tcfg"], 2, 16, torch.float32, "cpu")
    assert set(tc) == set(jc)
    j_dec = j_steps.make_decode_step(lm["jcfg"], lm["jmodel"], None)
    t_dec = t_steps.make_decode_step(lm["tcfg"], lm["tmodel"])
    for t in range(3):
        tok = lm["tokens"][:, t]
        lj, jc = j_dec(lm["jp"], jnp.asarray(tok), jc, jnp.asarray(t))
        lt, tc = t_dec(lm["tp"], torch.as_tensor(tok), tc, t)
        _close(lt, lj)
        for k in jc:
            _close(tc[k], jc[k])


def test_mamba2_step_matches_apply(lm):
    """Token-by-token `mamba2_step` equals the sequence form
    `mamba2_apply` (plain SSD), and both equal the reference's apply."""
    cfg = lm["tcfg"].ssm
    p_np = jax.tree.map(lambda a: a[0], lm["tree"]["layers"]["mamba"])
    tp = convert.lm_params_from_numpy(p_np, lm["tcfg"], device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 11, cfg.d_model)) \
        .astype(np.float32)
    seq = t_ssd.mamba2_apply(tp, cfg, torch.from_numpy(x))
    _close(seq, j_ssd.mamba2_apply(jax.tree.map(jnp.asarray, p_np),
                                   lm["jcfg"].ssm, jnp.asarray(x)))
    cache = t_ssd.mamba2_init_cache(cfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(x.shape[1]):
        y, cache = t_ssd.mamba2_step(tp, cfg, torch.from_numpy(x[:, t]),
                                     cache)
        steps.append(y)
    _close(torch.stack(steps, dim=1), seq.numpy())


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in (7, 4, 9)]


def test_server_tokens_equal_reference(lm):
    """Three requests over two slots (left padding, a second batch):
    every generated token equal to the reference Server's."""
    prompts = _prompts(lm["tcfg"].vocab)
    js = j_engine.Server(lm["jcfg"], lm["jmodel"], lm["jp"], batch_slots=2,
                         max_len=32, eos=-1)
    ts = t_engine.Server(lm["tcfg"], lm["tmodel"], lm["tp"], batch_slots=2,
                         max_len=32, eos=-1)
    for i, pr in enumerate(prompts):
        js.submit(j_engine.Request(i, pr, max_new_tokens=5))
        ts.submit(t_engine.Request(i, pr, max_new_tokens=5))
    jd, td = js.run(), ts.run()
    assert [r.rid for r in td] == [r.rid for r in jd] == [0, 1, 2]
    for a, b in zip(td, jd):
        assert a.out_tokens == [int(x) for x in b.out_tokens]
        assert len(a.out_tokens) == 5
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def test_bf16_server_raises_where_reference_fails():
    jcfg, jmodel = j_reg.get("zamba2-1.2b", smoke=True)
    tcfg, tmodel = t_reg.get("zamba2-1.2b", smoke=True)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    tree = convert.lm_params_numpy(tcfg, seed=0)
    js = j_engine.Server(jcfg, jmodel, jax.tree.map(jnp.asarray, tree),
                         batch_slots=1, max_len=16, eos=-1)
    js.submit(j_engine.Request(0, np.arange(1, 4, dtype=np.int32), 2))
    with pytest.raises(TypeError, match="carry"):
        js.run()
    with pytest.raises(ValueError, match="float32 only"):
        t_engine.Server(tcfg, tmodel,
                        convert.lm_params_from_numpy(tree, tcfg, "cpu"))
    # the prefill step itself runs at bf16 in both
    toks = np.arange(1, 9)[None]
    hj = j_steps.make_prefill_step(jcfg, jmodel, None)(
        jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(toks)})
    ht = t_steps.make_prefill_step(tcfg, tmodel)(
        convert.lm_params_from_numpy(tree, tcfg, "cpu"),
        {"tokens": torch.as_tensor(toks)})
    assert ht.dtype == torch.bfloat16
    _close(ht, hj, rtol=5e-2)


def test_registry_names_unported_archs():
    """Every arch of the reference is ported (whisper-medium, the last,
    came with the training slice); an unknown id raises, naming the
    ported ones."""
    assert t_reg.arch_names() == j_reg.arch_names()
    with pytest.raises(NotImplementedError, match="ported: "):
        t_reg.get("no-such-arch")
