"""Port parity of the training substrate: AdamW's schedule, update and
global norm, int8 compression with error feedback, the synthetic data
pipeline, checkpoints (round trip, atomicity, GC, both directions between
the packages), the single-device elastic and pipeline helpers, the
watchdog and the training driver (resume equivalence), against the JAX
reference on the CPU.

Tolerances: the optimizer's float32 arithmetic follows the reference's
step for step, but XLA and PyTorch sum the global norm in different
orders and may fuse or reorder scalar operations, so updated parameters
and moments are held to 2e-6 relative to each leaf's largest magnitude
and the schedule to 1e-6 relative; int8 values, data batches and
checkpoint leaves are held bit for bit."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_data
from repro.training import checkpoint as j_ckpt
from repro.training import compression as j_comp
from repro.training import optimizer as j_opt
from repro.training import pipeline as j_pipe
from repro_torch import tree as t_tree
from repro_torch.data import pipeline as t_data
from repro_torch.launch import train as t_train
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import compression as t_comp
from repro_torch.training import elastic as t_el
from repro_torch.training import optimizer as t_opt
from repro_torch.training import pipeline as t_pipe

REL = 2e-6


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close_tree(got, want, rel=REL):
    g, w = t_tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "a": rng.standard_normal((3, 2)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 3.0,
        params)
    return params, grads


def _torch(tree):
    return t_tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = t_opt.schedule(t_opt.OptConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    want = j_opt.schedule(j_opt.OptConfig(**cfg), jnp.asarray(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_global_norm_sums_in_flatten_order():
    _, grads = _trees()
    for a, b in zip(t_tree.leaves(_torch(grads)), jax.tree.leaves(grads)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(float(t_opt.global_norm(_torch(grads))),
                               float(j_opt.global_norm(_jax(grads))),
                               rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_adamw_update_matches_reference(clip):
    """Three AdamW steps (clipped and unclipped) from the same start."""
    params, grads = _trees()
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    tp, tg = _torch(params), _torch(grads)
    jp, jg = _jax(params), _jax(grads)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for _ in range(3):
        tp, ts, tm = t_opt.update(t_opt.OptConfig(**cfg), tg, ts, tp)
        jp, js, jm = j_opt.update(j_opt.OptConfig(**cfg), jg, js, jp)
        _close_tree(tp, jp)
        _close_tree(ts["m"], js["m"])
        _close_tree(ts["v"], js["v"])
        assert int(ts["count"]) == int(js["count"])
        assert ts["count"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def test_adamw_converges():
    target = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 4)),
                             dtype=torch.float32)
    params = {"w": torch.zeros((8, 4))}
    cfg = t_opt.OptConfig(lr=5e-2, weight_decay=0.0, warmup_steps=5,
                          total_steps=300)
    state = t_opt.init(params)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target) / target.numel()}
        params, state, _ = t_opt.update(cfg, g, state, params)
    assert float(torch.mean((params["w"] - target) ** 2)) < 1e-3


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_matches_reference_bit_for_bit():
    g = np.random.default_rng(1).standard_normal(257).astype(np.float32)
    g[:3] = [0.0, 2.5, -1e-9]
    q, scale = t_comp.quantize_leaf(torch.from_numpy(g))
    jq, jscale = j_comp.quantize_leaf(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(
        t_comp.dequantize_leaf(q, scale).numpy(),
        np.asarray(j_comp.dequantize_leaf(jq, jscale)))


def test_compress_grads_matches_reference():
    """Two rounds with error feedback: values and residuals equal."""
    _, grads = _trees(2)
    te, je = t_comp.init_error_state(_torch(grads)), \
        j_comp.init_error_state(_jax(grads))
    for _ in range(2):
        tg, te = t_comp.compress_grads(_torch(grads), te)
        jg, je = j_comp.compress_grads(_jax(grads), je)
        for a, b in zip(t_tree.leaves(tg) + t_tree.leaves(te),
                        jax.tree.leaves(jg) + jax.tree.leaves(je)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compression_error_feedback_preserves_signal():
    g = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0))}
    dq, e2 = t_comp.compress_grads(g, t_comp.init_error_state(g))
    torch.testing.assert_close(dq["w"] + e2["w"], g["w"], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("step", [0, 7])
def test_lm_batch_bit_equal(host, step):
    kw = dict(vocab=97, seq_len=16, global_batch=8, seed=3, n_hosts=2,
              host_id=host)
    got = t_data.lm_batch(t_data.DataConfig(**kw), step, device="cpu")
    want = j_data.lm_batch(j_data.DataConfig(**kw), step)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype


def test_lm_batches_and_egocentric_batch_bit_equal():
    kw = dict(vocab=50, seq_len=12, global_batch=2, seed=1)
    it = t_data.lm_batches(t_data.DataConfig(**kw), 4, device="cpu")
    for step in (4, 5):
        np.testing.assert_array_equal(
            next(it)["tokens"].numpy(),
            np.asarray(j_data.lm_batch(j_data.DataConfig(**kw), step)
                       ["tokens"]))
    got = t_data.egocentric_batch(t_data.DataConfig(**kw), 3, device="cpu")
    want = j_data.egocentric_batch(j_data.DataConfig(**kw), 3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_data.lm_batch(t_data.DataConfig(8, 4, 2), 0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32),
                  "a": torch.tensor(2.5)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _ckpt_tree()
    t_ckpt.save(tmp_path, tree, step=7)
    like = t_tree.map(torch.zeros_like, tree)
    restored, step = t_ckpt.restore(tmp_path, like)
    assert step == 7
    for x, y in zip(t_tree.leaves(tree), t_tree.leaves(restored)):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    tree = {"a": torch.zeros(4)}
    t_ckpt.save(tmp_path, tree, step=1)
    t_ckpt.save(tmp_path, tree, step=2)
    assert t_ckpt.latest_step(tmp_path) == 2
    (tmp_path / ".tmp_step_00000009").mkdir()
    (tmp_path / "step_00000011").mkdir()        # no index.json: partial
    assert t_ckpt.latest_step(tmp_path) == 2
    assert t_ckpt.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(tmp_path / "missing", tree)


def test_async_checkpointer_and_gc(tmp_path):
    c = t_ckpt.AsyncCheckpointer(tmp_path, keep=2)
    tree = {"a": torch.ones(8)}
    for s in (1, 2, 3, 4):
        c.submit(t_tree.map(lambda a: a * s, tree), s)
    tree["a"].fill_(-1.0)             # submitted copies are already taken
    c.wait()
    c.close()
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4] and c.last_saved == 4
    restored, _ = t_ckpt.restore(tmp_path, tree, 4)
    torch.testing.assert_close(restored["a"], torch.full((8,), 4.0))


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """(params, opt_state) saved by one package restore leaf for leaf in
    the other: the leaf files follow jax.tree's flatten order."""
    params, _ = _trees(5)
    jtree = (_jax(params), j_opt.init(_jax(params)))
    ttree = (_torch(params), t_opt.init(_torch(params)))
    if direction == "jax->port":
        j_ckpt.save(tmp_path, jtree, 3)
        got, step = t_ckpt.restore(tmp_path, ttree)
        pairs = zip(t_tree.leaves(got), jax.tree.leaves(jtree))
    else:
        ttree[1]["count"] += 4
        t_ckpt.save(tmp_path, ttree, 3)
        got, step = j_ckpt.restore(tmp_path, jtree)
        pairs = zip(jax.tree.leaves(got), t_tree.leaves(ttree))
    assert step == 3
    n = 0
    for a, b in pairs:
        np.testing.assert_array_equal(_np(a), _np(b))
        assert _np(a).dtype == _np(b).dtype
        n += 1
    assert n == len(jax.tree.leaves(jtree))


# ---------------------------------------------------------------------------
# elastic, pipeline, watchdog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp", [(512, 16), (256, 16), (240, 16),
                                  (250, 16), (1, 16), (7, 4), (12, 8)])
def test_best_mesh_shape_matches_reference(n, mp):
    from repro.training.elastic import best_mesh_shape
    assert t_el.best_mesh_shape(n, mp) == best_mesh_shape(n, mp)


def test_single_device_mesh_and_reshard():
    mesh = t_el.make_elastic_mesh(16, device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    host = {"w": np.arange(4, dtype=np.float32),
            "n": {"c": np.array(3, np.int32)}}
    out = t_el.reshard(host, device="cpu")
    assert out["w"].dtype == torch.float32 and out["n"]["c"].dtype == \
        torch.int32
    np.testing.assert_array_equal(out["w"].numpy(), host["w"])


def test_run_with_restarts_recovers():
    calls = {"n": 0, "failed": False}

    def step(s):
        calls["n"] += 1
        if s == 3 and not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("simulated node failure")

    final, restarts = t_el.run_with_restarts(step, 0, 6,
                                             on_failure=lambda s, e: 2)
    assert (final, restarts, calls["n"]) == (6, 1, 8)
    def always(s):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):       # no on_failure
        t_el.run_with_restarts(always, 0, 2)
    with pytest.raises(RuntimeError, match="down"):       # out of restarts
        t_el.run_with_restarts(always, 0, 2, max_restarts=2,
                               on_failure=lambda s, e: s)


def test_watchdog_flags_stragglers(monkeypatch):
    """The watchdog on a monkeypatched clock (no sleeps): five 2 ms steps,
    then a 50 ms one is flagged."""
    now = {"t": 0.0}
    monkeypatch.setattr(t_el.time, "monotonic", lambda: now["t"])
    wd = t_el.StepWatchdog(factor=3.0)
    for s in range(6):
        wd.start()
        now["t"] += 0.002
        assert not wd.stop(s)
    wd.start()
    now["t"] += 0.05
    assert wd.stop(99)
    assert wd.slow_steps[0][0] == 99
    assert wd.slow_steps[0][1] == pytest.approx(0.05)


@pytest.mark.parametrize("n_micro,n_stages", [(4, 2), (8, 4), (3, 3),
                                              (1, 2)])
def test_pipeline_apply_is_the_sequential_run(n_micro, n_stages):
    rng = np.random.default_rng(n_micro * 10 + n_stages)
    w = rng.standard_normal((n_stages, 6, 6)).astype(np.float32) * 0.5
    b = rng.standard_normal((n_stages, 6)).astype(np.float32)
    x = rng.standard_normal((n_micro, 2, 6)).astype(np.float32)

    def t_layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def j_layer(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    tp = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = t_pipe.pipeline_apply(t_layer, tp, torch.from_numpy(x))
    ref = t_pipe.reference_apply(t_layer, tp, torch.from_numpy(x))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    want = j_pipe.reference_apply(j_layer, {"w": jnp.asarray(w),
                                            "b": jnp.asarray(b)},
                                  jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert t_pipe.bubble_fraction(n_micro, n_stages) == \
        j_pipe.bubble_fraction(n_micro, n_stages) == pytest.approx(
            (n_stages - 1) / (n_micro + n_stages - 1))


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def test_train_resume_equivalence(tmp_path):
    """An 8-step run stopped by SIGTERM after step 3 (it checkpoints step
    4 and exits), then restarted from that checkpoint, ends with the
    parameters of an uninterrupted 8-step run, bit for bit, having seen
    the same losses."""
    import os
    import signal
    kw = dict(smoke=True, steps=8, batch=2, seq=16, lr=1e-2, log_every=100,
              device="cpu", ckpt_every=100)
    full, losses = t_train.train("olmo-1b", **kw)

    def stop_after_3(s, m):
        if s == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    _, l1 = t_train.train("olmo-1b", ckpt_dir=str(tmp_path),
                          on_step=stop_after_3, **kw)
    assert len(l1) == 4 and t_ckpt.latest_step(tmp_path) == 4
    resumed, l2 = t_train.train("olmo-1b", ckpt_dir=str(tmp_path), **kw)
    assert l1 + l2 == losses
    for x, y in zip(t_tree.leaves(resumed), t_tree.leaves(full)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_train_step_metrics_and_compression():
    seen = []
    params, losses = t_train.train(
        "olmo-1b", smoke=True, steps=3, batch=2, seq=16, device="cpu",
        compress_grads=True, on_step=lambda s, m: seen.append((s, m)))
    assert [s for s, _ in seen] == [0, 1, 2]
    for _, m in seen:
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert all(math.isfinite(float(v)) for v in m.values())
    assert losses == [float(m["loss"]) for _, m in seen]


def test_train_cuts_the_depth():
    """`layers` trains the config's first layers at full width: every
    stacked layer leaf has that many rows, the rest of the tree is the
    full config's; a depth outside 1..n_layers raises."""
    from repro_torch.models import registry
    cfg, model = registry.get("gemma3-4b", smoke=True)
    params, losses = t_train.train("gemma3-4b", smoke=True, steps=1,
                                   batch=2, seq=16, device="cpu", layers=2)
    assert len(losses) == 1 and math.isfinite(losses[0])
    full = model.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(params) == set(full)
    for leaf, want in zip(t_tree.leaves(params["layers"]),
                          t_tree.leaves(full["layers"])):
        assert leaf.shape == (2,) + tuple(want.shape[1:])
    with pytest.raises(ValueError):
        t_train.train("gemma3-4b", smoke=True, steps=1, batch=2, seq=16,
                      device="cpu", layers=cfg.n_layers + 1)


@pytest.mark.parametrize("arch", ["whisper-medium", "phi-3-vision-4.2b"])
def test_side_inputs_are_seeded_per_step(arch):
    from repro_torch.models import registry
    cfg, _ = registry.get(arch, smoke=True)
    a = t_train.side_inputs(cfg, 2, 5, "cpu")
    b = t_train.side_inputs(cfg, 2, 5, "cpu")
    c = t_train.side_inputs(cfg, 2, 6, "cpu")
    (k,) = a
    torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a[k], c[k])
    want = (2, cfg.audio_frames, cfg.d_model) if cfg.family == "encdec" \
        else (2, cfg.vision_tokens, cfg.vision_embed_dim)
    assert tuple(a[k].shape) == want
    assert t_train.side_inputs(dataclasses.replace(cfg, family="dense"), 2,
                               5, "cpu") == {}
