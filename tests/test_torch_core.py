"""Port parity: platform registry, scenario engine and offload sizing of
`repro_torch` against the JAX reference `repro`, on the same inputs.

Both packages run on the CPU; inputs cross as numpy arrays or plain
data.  Tolerances are the reference's own (`tests/test_platform_api.py`
holds the batched engine to rtol 1e-6)."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aria2 as j_aria2
from repro.core import dse as j_dse
from repro.core import offload as j_offload
from repro_torch.core import aria2 as t_aria2
from repro_torch.core import offload as t_offload
from repro_torch.core import scenarios as t_scen
from repro_torch import convert

REPO = Path(__file__).resolve().parents[1]
SKUS = ("aria2", "aria2_display", "aria2_capture_only", "rayban_cam",
        "aria2_puck_split")


def _plats(mod):
    return {p.name: p for p in mod.platforms()}


@pytest.mark.parametrize("name", SKUS)
def test_platform_to_dict_equal(name):
    """Registry data (incl. the taskgraph duty tables and the frozen
    FLOPs-derived IP rates) is identical in both packages."""
    assert _plats(t_aria2)[name].to_dict() == _plats(j_aria2)[name].to_dict()


def test_platform_from_reference_dict_roundtrips():
    ref = _plats(j_aria2)["aria2_puck_split"]
    port = convert.platform_from_dict(ref.to_dict())
    assert port == _plats(t_aria2)["aria2_puck_split"]


@pytest.mark.parametrize("sc", [
    j_aria2.FULL_OFFLOAD, j_aria2.FULL_ON_DEVICE,
    j_aria2.Scenario("mix", ("vio", "asr"), compression=20.0, fps_scale=2.0),
    j_aria2.Scenario("et", ("eye_tracking",), compression=4.0,
                     fps_scale=4.0),
], ids=lambda s: s.name)
def test_legacy_total_mw_equal(sc):
    port_sc = t_aria2.Scenario(sc.name, sc.on_device, sc.compression,
                               sc.fps_scale)
    for theta in (None, {"wifi_mw_per_mbps": 7.5, "eff_scale": 0.97}):
        want = float(j_aria2.legacy_total_mw(sc, theta))
        got = float(t_aria2.legacy_total_mw(port_sc, theta))
        assert got == want


@pytest.mark.parametrize("name", SKUS)
def test_evaluate_matches_over_grid_sweep(name):
    """`scenarios.evaluate` totals / loads / uplink over the
    `dse.grid_sweep` placement x compression x fps grid."""
    ref = j_dse.grid_sweep(platform=name)
    s = ref.sset
    sset = t_scen.ScenarioSet(s.placement, s.compression, s.fps_scale,
                              s.mcs_tier, s.upload_duty, s.brightness,
                              s.names, s.primitives)
    got = t_scen.evaluate(_plats(t_aria2)[name], sset, device="cpu")
    np.testing.assert_allclose(got.total_mw.numpy(),
                               np.asarray(ref.total_mw), rtol=1e-6)
    np.testing.assert_allclose(got.loads_mw.numpy(),
                               np.asarray(ref.loads_mw), rtol=1e-6)
    np.testing.assert_allclose(got.offloaded_mbps.numpy(),
                               np.asarray(ref.offloaded_mbps), rtol=1e-6)


def test_evaluate_mcs_duty_brightness_knobs():
    """The knobs the day tables vary (MCS tier, upload duty, brightness)
    on the display SKU, with a theta override."""
    rng = np.random.default_rng(0)
    n = 96
    rows = [{"on_device": tuple(p for p, b in zip(
                 ("vio", "eye_tracking", "asr", "hand_tracking"),
                 rng.integers(0, 2, 4)) if b),
             "compression": float(rng.choice([2.0, 8.0, 32.0])),
             "fps_scale": float(rng.choice([1.0, 2.0, 8.0])),
             "mcs_tier": int(rng.integers(0, 3)),
             "upload_duty": float(rng.uniform(0, 1)),
             "brightness": float(rng.uniform(0, 1))} for _ in range(n)]
    theta = {"pj_ht": 11.0, "eff_scale": 1.01}
    from repro.core import scenarios as j_scen
    ref = j_scen.evaluate(_plats(j_aria2)["aria2_display"],
                          j_scen.ScenarioSet.build(rows), theta)
    got = t_scen.evaluate(_plats(t_aria2)["aria2_display"],
                          t_scen.ScenarioSet.build(rows), theta,
                          device="cpu")
    for a, b in ((got.total_mw, ref.total_mw),
                 (got.pd_loss_mw, ref.pd_loss_mw),
                 (got.offloaded_mbps, ref.offloaded_mbps)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the same engine fed the reference's merged theta through convert
    plat = _plats(j_aria2)["aria2_display"]
    th = {**plat.theta_dict(), **theta}
    out = t_scen.batched_fn(_plats(t_aria2)["aria2_display"])(
        t_scen.ScenarioSet.build(rows).vec("cpu"),
        convert.theta_from_numpy(th, device="cpu"))
    assert torch.equal(out["total"], got.total_mw)


def test_stream_rates_equal():
    ref = j_offload.stream_rates()
    got = t_offload.stream_rates()
    for k in ("streams", "archs", "cells", "sources"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["tok_per_cap"], ref["tok_per_cap"],
                               rtol=1e-6)


def test_pods_streams_device_equal():
    rng = np.random.default_rng(1)
    r = 64
    asr = rng.integers(0, 2, r).astype(np.float32)
    fps = rng.choice([1.0, 2.0, 4.0, 16.0], r).astype(np.float32)
    duty = rng.uniform(0, 1, r).astype(np.float32)
    rates = j_offload.stream_rates()["tok_per_cap"].astype(np.float32)
    gate = np.float32(1e6)
    want_tot, want_st = j_offload.pods_streams_device(
        jnp.asarray(asr), jnp.asarray(fps), jnp.asarray(duty),
        jnp.asarray(rates), jnp.asarray(gate))
    got_tot, got_st = t_offload.pods_streams_device(
        *(torch.as_tensor(x) for x in (asr, fps, duty, rates)),
        torch.tensor(gate))
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               rtol=1e-6)
    np.testing.assert_allclose(got_tot.numpy(), np.asarray(want_tot),
                               rtol=1e-6)


def test_pod_cost_equal():
    ph = np.array([0.0, 12.5, 3e4])
    want, got = j_offload.pod_cost(ph), t_offload.pod_cost(ph)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert t_offload.pod_cost(7.0) == j_offload.pod_cost(7.0)


def test_port_imports_neither_jax_nor_reference():
    """Every repro_torch module imports without pulling in jax or any
    module of the reference package."""
    src = REPO / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(src).with_suffix("").parts)
        for p in src.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    for m in ("models.mamba_lm", "models.registry", "serving.engine",
              "launch.steps", "kernels.flash_attention", "kernels.ssd_scan",
              "nn.attention", "nn.ssd", "configs.zamba2_1p2b"):
        assert "repro_torch." + m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 30


def test_default_device_needs_a_card():
    """Entry points default to CUDA and never drop to the CPU on their
    own: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core import dse
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dse.day_pareto(dt_s=600.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_scen.evaluate(_plats(t_aria2)["aria2"],
                        t_scen.ScenarioSet.grid())
    from repro_torch.models import registry
    cfg, model = registry.get("zamba2-1.2b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8, torch.float32)


def _lm_inits():
    """Every parameter or cache initializer of the LM slice, as a call
    that forwards `device` when it is given and otherwise leaves the
    default."""
    from repro_torch.configs import zamba2_1p2b
    from repro_torch.models import mamba_lm
    from repro_torch.nn import attention, core, ssd
    cfg = zamba2_1p2b.smoke()
    f32 = torch.float32
    return {
        "mamba_lm.init": lambda g, **d: mamba_lm.init(g, cfg, **d),
        "mamba_lm.init_cache": lambda g, **d: mamba_lm.init_cache(
            cfg, 1, 8, f32, **d),
        "ssd.mamba2_init": lambda g, **d: ssd.mamba2_init(g, cfg.ssm, f32,
                                                          **d),
        "ssd.mamba2_init_cache": lambda g, **d: ssd.mamba2_init_cache(
            cfg.ssm, 1, f32, **d),
        "attention.attn_init": lambda g, **d: attention.attn_init(
            g, 8, 2, 2, 4, f32, **d),
        "core.trunc_normal": lambda g, **d: core.trunc_normal(
            g, (4,), f32, 1.0, **d),
        "core.dense_init": lambda g, **d: core.dense_init(g, (4, 4), f32,
                                                          **d),
        "core.rmsnorm_init": lambda g, **d: core.rmsnorm_init(4, f32, **d),
        "core.mlp_init": lambda g, **d: core.mlp_init(g, 4, 8, f32, **d),
        "core.embed_init_params": lambda g, **d: core.embed_init_params(
            g, 16, 4, f32, **d),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("name", sorted(_lm_inits()))
def test_lm_init_defaults_to_the_card(name):
    """The LM slice's initializers default to CUDA too: without a card the
    default raises, and device="cpu" builds every tensor on the CPU."""
    fn = _lm_inits()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(torch.Generator().manual_seed(0))
    out = fn(torch.Generator().manual_seed(0), device="cpu")
    leaves = list(_leaves(out))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
