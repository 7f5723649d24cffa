"""Port parity of whisper-medium (the encoder-decoder family): configs,
the parameter tree, `encode`, `forward`, the prefill step (last hidden
and every cache entry: decoder K / V padded to max_len, the encoder's
cross-attention K / V) and 3 decode steps on the prefilled cache,
against the JAX reference on the smoke config in float32.

Both packages get the same numpy weights (`convert.lm_params_numpy`) and
the same tokens and frames.  Tolerance: 1e-5 relative to the largest
magnitude (float32 sums in another order), as tests/test_torch_lm.py and
test_torch_transformer.py hold the other families."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_medium as j_cfgs
from repro.launch import steps as j_steps
from repro.models import registry as j_reg
from repro.models import whisper as j_wh
from repro_torch import convert
from repro_torch.configs import whisper_medium as t_cfgs
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_reg
from repro_torch.models import whisper as t_wh

RTOL = 1e-5
S, MAX_LEN = 12, 20


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _same_config(t, j):
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name == "ssm":
            assert (a is None) == (b is None)
        else:
            assert a == b, f.name
    assert (t.n_params, t.n_active_params) == (j.n_params, j.n_active_params)


@pytest.fixture(scope="module")
def wh():
    jcfg, _ = j_reg.get("whisper-medium", smoke=True)
    tcfg, model = t_reg.get("whisper-medium", smoke=True)
    assert model is t_wh
    tree = convert.lm_params_numpy(tcfg, seed=5)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab, (2, S)).astype(np.int32)
    frames = rng.standard_normal((2, tcfg.audio_frames, tcfg.d_model)) \
        .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    jh, jcache = j_steps.make_prefill_step(jcfg, j_wh, None)(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    return {"jcfg": jcfg, "tcfg": tcfg, "tree": tree, "jp": jp, "tp": tp,
            "tokens": tokens, "frames": frames, "jh": jh, "jcache": jcache}


def test_configs_match_reference():
    for name in ("config", "smoke", "tuned"):
        _same_config(getattr(t_cfgs, name)(), getattr(j_cfgs, name)())
    cfg = t_cfgs.config()
    assert (cfg.n_layers, cfg.dec_layers, cfg.d_model, cfg.audio_frames) \
        == (24, 24, 1024, 1500)


def test_param_tree_matches_reference_init(wh):
    """The numpy tree, the port's init and the reference's init share
    every path, shape and dtype."""
    want = j_wh.init(jax.random.PRNGKey(0), wh["jcfg"])

    def shapes(tree):
        return {jax.tree_util.keystr(p): (tuple(np.shape(x)),
                                          str(np.asarray(x).dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}

    init = t_wh.init(torch.Generator().manual_seed(0), wh["tcfg"], "cpu")
    init_np = jax.tree.map(lambda t: t.numpy(), init)
    assert shapes(wh["tree"]) == shapes(want) == shapes(init_np)
    assert "wg" not in init["enc_layers"]["mlp"]            # ungated GELU
    # the pos_embed scale: Normal(0, 0.02) truncated at 2 std
    pe = init["pos_embed"]
    assert float(pe.abs().max()) <= 0.04 and 0.01 < float(pe.std()) < 0.02


def test_encode_matches_reference(wh):
    got = t_wh.encode(wh["tp"], wh["tcfg"], torch.from_numpy(wh["frames"]))
    want = j_wh.encode(wh["jp"], wh["jcfg"], jnp.asarray(wh["frames"]))
    _close(got, want)


def test_forward_matches_reference(wh):
    h, aux = t_wh.forward(wh["tp"], wh["tcfg"],
                          torch.from_numpy(wh["tokens"]),
                          frames=torch.from_numpy(wh["frames"]))
    jh, _ = j_wh.forward(wh["jp"], wh["jcfg"], jnp.asarray(wh["tokens"]),
                         frames=jnp.asarray(wh["frames"]))
    _close(h, jh)
    assert float(aux) == 0.0


def test_prefill_step_matches_reference(wh):
    h, cache = t_steps.make_prefill_step(wh["tcfg"], t_wh)(
        wh["tp"], {"tokens": torch.from_numpy(wh["tokens"]),
                   "frames": torch.from_numpy(wh["frames"])})
    _close(h, wh["jh"])
    assert set(cache) == set(wh["jcache"]) == {"k", "v", "xk", "xv"}
    for key in cache:
        _close(cache[key], wh["jcache"][key])


def test_decode_steps_match_reference(wh):
    """3 decode steps on a cache prefilled to MAX_LEN (zero past S): the
    logits and every cache entry after each step; the port writes its
    rows into the cache in place."""
    tcfg, jcfg = wh["tcfg"], wh["jcfg"]
    toks = torch.from_numpy(wh["tokens"])
    frames = torch.from_numpy(wh["frames"])
    _, tc = t_wh.prefill(wh["tp"], tcfg, toks, frames, max_len=MAX_LEN)
    _, jc = j_wh.prefill(wh["jp"], jcfg, jnp.asarray(wh["tokens"]),
                         jnp.asarray(wh["frames"]), max_len=MAX_LEN)
    for key in tc:
        _close(tc[key], jc[key])
    rng = np.random.default_rng(7)
    step = t_steps.make_decode_step(tcfg, t_wh)
    for i in range(3):
        tok = rng.integers(0, tcfg.vocab, (2,)).astype(np.int32)
        before = tc["k"]
        tl, tc = step(wh["tp"], torch.from_numpy(tok), tc, S + i)
        assert tc["k"] is before
        jl, jc = j_wh.decode_step(wh["jp"], jcfg, jnp.asarray(tok), jc,
                                  jnp.asarray(S + i))
        _close(tl, jl)
        for key in tc:
            _close(tc[key], jc[key])


def test_init_cache_matches_reference(wh):
    got = t_wh.init_cache(wh["tcfg"], 2, MAX_LEN, torch.float32, "cpu")
    want = j_wh.init_cache(wh["jcfg"], 2, MAX_LEN, jnp.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_registry_and_steps_take_encdec():
    cfg, model = t_reg.get("whisper-medium")
    assert model is t_wh and cfg.family == "encdec"
    t_steps.make_train_step(cfg, model)
    t_steps.make_decode_step(cfg, model)
