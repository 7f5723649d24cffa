"""Port parity of the transformer family's serving path (dense, local /
global, VLM, MoE): configs, parameter tree, forward, prefill (hidden and
every cache entry), decode steps against a prefilled cache, and the
serving engine, against the JAX reference on each arch's smoke config in
float32.

Both packages get the same weights (`convert.lm_params_numpy`, seeded
numpy) and the same tokens.  Tolerance: 1e-5 relative to the largest
magnitude for hidden states, caches and logits (float32 sums in another
order), as in tests/test_torch_lm.py; token ids exactly.  gemma3's smoke
window is 16, so its 21- and 40-token prompts mask keys on the local
layers while the global layer sees them all."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as j_gemma3
from repro.launch import steps as j_steps
from repro.models import registry as j_reg
from repro.models import transformer as j_tf
from repro.nn import attention as j_attn
from repro.nn import core as j_core
from repro.serving import engine as j_engine
from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs import gemma3_4b as t_gemma3
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_reg
from repro_torch.models import transformer as t_tf
from repro_torch.nn import attention as t_attn
from repro_torch.nn import core as t_core
from repro_torch.serving import engine as t_engine

ARCHS = ("olmo-1b", "gemma3-4b", "granite-3-2b", "yi-34b",
         "phi-3-vision-4.2b", "moonshot-v1-16b-a3b", "dbrx-132b")
RTOL = 1e-5
S = 21                       # > gemma3 smoke's window of 16


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


def _same_config(t, j) -> None:
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert _dtype_name(a) == _dtype_name(b), f.name
        elif f.name == "ssm":
            assert (a is None) == (b is None)
        else:
            assert a == b, f.name
    assert {f.name for f in dataclasses.fields(t)} == \
        {f.name for f in dataclasses.fields(j)}
    assert (t.n_params, t.n_active_params) == (j.n_params, j.n_active_params)


def _lm(arch, cfg_fn=None):
    jcfg, jmodel = j_reg.get(arch, smoke=True)
    tcfg, tmodel = t_reg.get(arch, smoke=True)
    if cfg_fn is not None:
        jcfg, tcfg = cfg_fn(jcfg), cfg_fn(tcfg)
    tree = convert.lm_params_numpy(tcfg, seed=3)
    lm = {"arch": arch, "jcfg": jcfg, "jmodel": jmodel, "tcfg": tcfg,
          "tmodel": tmodel, "tree": tree,
          "jp": jax.tree.map(jnp.asarray, tree),
          "tp": convert.lm_params_from_numpy(tree, tcfg, device="cpu"),
          "tokens": np.random.default_rng(4).integers(0, tcfg.vocab, (2, S)),
          "jkw": {}, "tkw": {}}
    if tcfg.vision_tokens:
        ve = np.random.default_rng(5).standard_normal(
            (2, tcfg.vision_tokens, tcfg.vision_embed_dim)).astype(np.float32)
        lm["jkw"] = {"vision_embeds": jnp.asarray(ve)}
        lm["tkw"] = {"vision_embeds": torch.from_numpy(ve)}
    return lm


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _lm(request.param)


def test_configs_match_reference(lm):
    _same_config(lm["tcfg"], lm["jcfg"])
    _same_config(t_reg.get(lm["arch"])[0], j_reg.get(lm["arch"])[0])


@pytest.mark.parametrize("arch", ["gemma3-4b", "yi-34b",
                                  "moonshot-v1-16b-a3b", "dbrx-132b",
                                  "mamba2-2.7b"])
def test_tuned_configs_match_reference(arch):
    mod = j_reg.ARCHS[arch][0].split(".")[-1]
    j_mod = __import__(f"repro.configs.{mod}", fromlist=["tuned"])
    t_mod = __import__(f"repro_torch.configs.{mod}", fromlist=["tuned"])
    t, j = t_mod.tuned(), j_mod.tuned()
    _same_config(t, j)
    if j.ssm is not None:               # mamba2-2.7b: SSD chunk 128
        assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)


def test_shapes_match_reference():
    from repro.configs import base as j_base
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    for arch in ARCHS:
        for name in t_base.SHAPES:
            assert t_base.shape_applicable(
                t_reg.get(arch)[0], t_base.SHAPES[name]) == \
                j_base.shape_applicable(j_reg.get(arch)[0],
                                        j_base.SHAPES[name])


def test_numpy_params_have_reference_tree(lm):
    want = jax.eval_shape(lambda: lm["jmodel"].init(jax.random.PRNGKey(0),
                                                    lm["jcfg"]))
    got = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                       lm["jp"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    # the port's own initializer (torch.Generator) builds the same tree,
    # with the router in float32 whatever the param dtype
    cfg16 = dataclasses.replace(lm["tcfg"], param_dtype=torch.bfloat16)
    port = lm["tmodel"].init(torch.Generator().manual_seed(0), cfg16,
                             device="cpu")
    want16 = jax.eval_shape(lambda: lm["jmodel"].init(
        jax.random.PRNGKey(0), dataclasses.replace(
            lm["jcfg"], param_dtype=jnp.bfloat16)))
    shapes = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype)[6:])), port)
    assert jax.tree.structure(shapes) == jax.tree.structure(want16)
    assert jax.tree.leaves(shapes) == jax.tree.leaves(want16)
    assert t_core.count_params(port) == j_core.count_params(want16)
    assert t_core.param_bytes(port) == j_core.param_bytes(want16)
    ht, _ = lm["tmodel"].forward(port, dataclasses.replace(
        cfg16, compute_dtype=torch.float32), torch.as_tensor(lm["tokens"]))
    assert torch.isfinite(ht).all()


def test_layer_flags_match_reference(lm):
    jf = j_tf.layer_flags(lm["jcfg"])
    tf = t_tf.layer_flags(lm["tcfg"])
    assert tf["window"] == np.asarray(jf["window"]).tolist()
    assert tf["theta"] == np.asarray(jf["theta"]).tolist()


def test_forward_matches(lm):
    toks = lm["tokens"]
    hj, aj = lm["jmodel"].forward(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                  remat=False, **lm["jkw"])
    ht, at = lm["tmodel"].forward(lm["tp"], lm["tcfg"],
                                  torch.as_tensor(toks), **lm["tkw"])
    _close(ht, hj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=0)
    if lm["tcfg"].n_experts:
        assert float(at) > 0


def test_prefill_step_and_cache_match(lm):
    toks = lm["tokens"]
    inputs_j = {"tokens": jnp.asarray(toks), **lm["jkw"]}
    inputs_t = {"tokens": torch.as_tensor(toks), **lm["tkw"]}
    hj, cj = j_steps.make_prefill_step(lm["jcfg"], lm["jmodel"], None)(
        lm["jp"], inputs_j)
    ht, ct = t_steps.make_prefill_step(lm["tcfg"], lm["tmodel"])(
        lm["tp"], inputs_t)
    _close(ht, hj)
    assert set(ct) == set(cj) == {"k", "v"}
    for key in cj:
        _close(ct[key], cj[key])
    # padded to max_len past the prompt, as the reference pads
    hj, cj = lm["jmodel"].prefill(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                  max_len=S + 5, **lm["jkw"])
    ht, ct = lm["tmodel"].prefill(lm["tp"], lm["tcfg"],
                                  torch.as_tensor(toks), max_len=S + 5,
                                  **lm["tkw"])
    _close(ht, hj)
    for key in cj:
        _close(ct[key], cj[key])
        assert not ct[key][:, :, S:].any()


def test_three_decode_steps_match(lm):
    """Three decode steps on the cache the prompt's prefill left (its
    positions past the window masked on gemma3's local layers), every
    cache entry compared after each step."""
    toks = lm["tokens"]
    _, jc = lm["jmodel"].prefill(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                 max_len=S + 3)
    _, tc = lm["tmodel"].prefill(lm["tp"], lm["tcfg"],
                                 torch.as_tensor(toks), max_len=S + 3)
    j_dec = j_steps.make_decode_step(lm["jcfg"], lm["jmodel"], None)
    t_dec = t_steps.make_decode_step(lm["tcfg"], lm["tmodel"])
    for t in range(3):
        tok = toks[:, t]
        lj, jc = j_dec(lm["jp"], jnp.asarray(tok), jc, jnp.asarray(S + t))
        lt, tc = t_dec(lm["tp"], torch.as_tensor(tok), tc, S + t)
        _close(lt, lj)
        for key in jc:
            _close(tc[key], jc[key])
    empty = lm["tmodel"].init_cache(lm["tcfg"], 2, 8, torch.float32, "cpu")
    want = lm["jmodel"].init_cache(lm["jcfg"], 2, 8, jnp.float32)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: v.shape for k, v in want.items()}


def test_forward_goes_through_the_flash_dispatch(lm, monkeypatch):
    """Every layer's prefill attention goes through `kernels.
    flash_attention.flash_attention` (the call that launches the kernel on
    the card): a global layer with no window, a local one with its own."""
    from repro_torch.kernels import flash_attention as fa
    windows = []
    real = fa.flash_attention

    def counted(q, k, v, **kw):
        windows.append(kw["window"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", counted)
    cfg = lm["tcfg"]
    lm["tmodel"].forward(lm["tp"], cfg, torch.as_tensor(lm["tokens"]),
                         **lm["tkw"])
    want = [None if w >= t_tf.BIG_WINDOW else w
            for w in t_tf.layer_flags(cfg)["window"]]
    assert windows == want and len(windows) == cfg.n_layers


def _prompts(vocab):
    rng = np.random.default_rng(6)
    return [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in (7, 4, 19)]


def test_server_tokens_equal_reference(lm):
    """Three requests over two slots (left padding, a second batch, a
    gemma3 prompt past its window): every token equal to the reference
    Server's, with the float32 cache both build."""
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


def test_gemma3_static_window_path_matches():
    """`tuned()`'s static-window path (the reference's grouped scan with
    `local_chunked_attention` once S > 2 x window) at 40 tokens: forward,
    prefill and its cache against the reference's."""
    def static(cfg):
        return dataclasses.replace(cfg, static_local_attn=True)
    lm = _lm("gemma3-4b", static)
    toks = np.random.default_rng(7).integers(0, lm["tcfg"].vocab, (2, 40))
    hj, aj = lm["jmodel"].forward(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                  remat=False)
    hf, at = lm["tmodel"].forward(lm["tp"], lm["tcfg"],
                                  torch.as_tensor(toks))
    _close(hf, hj)
    assert float(at) == float(aj) == 0.0
    hj, cj = lm["jmodel"].prefill(lm["jp"], lm["jcfg"], jnp.asarray(toks),
                                  max_len=44)
    ht, ct = lm["tmodel"].prefill(lm["tp"], lm["tcfg"],
                                  torch.as_tensor(toks), max_len=44)
    _close(ht, hj)
    for key in cj:
        _close(ct[key], cj[key])
    # and equal to the plain path on the same weights
    plain = dataclasses.replace(lm["tcfg"], static_local_attn=False)
    _close(lm["tmodel"].forward(lm["tp"], plain, torch.as_tensor(toks))[0],
           hf.numpy())


def test_local_chunked_attention_matches_reference():
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    for window, chunk in ((16, 16), (5, 8), (40, 48)):
        want = j_attn.local_chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            chunk_q=chunk)
        got = t_attn.local_chunked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window, chunk_q=chunk)
        _close(got, want)
    with pytest.raises(ValueError, match="multiple"):
        t_attn.local_chunked_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), window=4,
                                       chunk_q=20)


def test_embed_scale_rounds_sqrt_d_to_the_compute_dtype():
    """In bf16 sqrt(2560) becomes 50.5 before the multiply, as in the
    reference: embeddings equal bit for bit."""
    def cut(cfg):
        return dataclasses.replace(cfg, vocab=64)
    jcfg = dataclasses.replace(cut(j_gemma3.config()),
                               compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(cut(t_gemma3.config()),
                               compute_dtype=torch.bfloat16)
    table = np.random.default_rng(9).standard_normal((64, 2560)) \
        .astype(np.float32)
    toks = np.arange(8)[None]
    want = j_tf.embed_tokens({"embed": {"table": jnp.asarray(table)}}, jcfg,
                             jnp.asarray(toks))
    got = t_tf.embed_tokens({"embed": {"table": torch.from_numpy(table)}},
                            tcfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(torch.tensor(2560 ** 0.5, dtype=torch.bfloat16)) == 50.5
    unrounded = (torch.from_numpy(table[:8]).bfloat16().float()
                 * 2560 ** 0.5).bfloat16()
    assert not torch.equal(got[0], unrounded)


def test_vlm_puts_vision_rows_first():
    """phi-3-vision: the projected vision rows lead and the last text
    positions drop out (the sequence keeps its length)."""
    lm = _lm("phi-3-vision-4.2b")
    tp, cfg = lm["tp"], lm["tcfg"]
    toks = torch.as_tensor(lm["tokens"])
    ve = lm["tkw"]["vision_embeds"]
    h = t_tf.embed_tokens(tp, cfg, toks, ve)
    n = cfg.vision_tokens
    assert h.shape == (2, S, cfg.d_model)
    _close(h[:, :n], (ve @ tp["patch_proj"]).numpy())
    _close(h[:, n:], t_tf.embed_tokens(tp, cfg, toks)[:, :S - n].numpy())
    with pytest.raises(KeyError):
        t_steps.make_prefill_step(cfg, t_tf)(tp, {"tokens": toks})


def test_nonparametric_layernorm_and_norms_match_reference():
    x = np.random.default_rng(10).standard_normal((3, 5, 64)) \
        .astype(np.float32) * 3 + 1
    _close(t_core.nonparametric_layernorm(torch.from_numpy(x)),
           j_core.nonparametric_layernorm(jnp.asarray(x)))
    # the population variance: the unbiased one would miss by ~1/128
    assert abs(float(t_core.nonparametric_layernorm(
        torch.from_numpy(x)).square().mean()) - 1.0) < 1e-4
    scale = {"scale": np.linspace(0.5, 2, 64).astype(np.float32)}
    for kind in ("nonparametric_ln", "rmsnorm"):
        params = {} if kind == "nonparametric_ln" else scale
        assert t_core.norm_init(kind, 64, torch.float32, "cpu").keys() == \
            j_core.norm_init(kind, 64, jnp.float32).keys()
        _close(t_core.norm_apply(kind, {k: torch.from_numpy(v)
                                        for k, v in params.items()},
                                 torch.from_numpy(x)),
               j_core.norm_apply(kind, {k: jnp.asarray(v)
                                        for k, v in params.items()},
                                 jnp.asarray(x)))
    policy = t_core.DTypePolicy()
    cast = policy.cast({"a": torch.ones(2), "b": {"c": torch.zeros(3)}})
    assert cast["a"].dtype == cast["b"]["c"].dtype == torch.bfloat16
    assert _dtype_name(policy.param_dtype) == _dtype_name(
        j_core.DTypePolicy().param_dtype)


def test_transformer_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    cfg, model = t_reg.get("gemma3-4b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 4, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(convert.lm_params_numpy(cfg, 0), cfg)
