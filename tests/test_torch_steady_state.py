"""Port parity: the steady-state layer (the paper's Fig 4-6, Table III,
the power-delivery share, the DSE sweeps, sensitivity, fleet sizing and
the joint device + backend front) of `repro_torch` against the JAX
reference `repro`, on the same inputs, both on the CPU.

Tolerances are the reference's own: totals at rtol 1e-6
(`tests/test_platform_api.py`), fronts, skips and argmins exactly.  The
rows the sweeps return round their numbers (total_mw to 0.1, Mbps to
0.01); two totals equal to rtol 1e-6 may round one unit apart when they
straddle a rounding boundary, and `_assert_rows` allows exactly that.
Where the reference's paper tests fail (Fig 4's all-on-device delta,
two Table III buckets), the port must give the reference's values."""
import numpy as np
import pytest

from repro.core import aria2 as j_aria2
from repro.core import dse as j_dse
from repro.core import offload as j_offload
from repro.core import scaling as j_scaling
from repro.core import scenarios as j_scen
from repro_torch.core import aria2 as t_aria2
from repro_torch.core import dse as t_dse
from repro_torch.core import offload as t_offload
from repro_torch.core import scaling as t_scaling
from repro_torch.core import scenarios as t_scen

CPU = "cpu"
RTOL = 1e-6
PRIMS = tuple(j_aria2.PRIMITIVES)
# the six placements of tests/test_system.py's Fig 4 cases
FIG4 = [("hand_tracking",), ("eye_tracking",), ("asr",), ("vio",),
        ("vio", "hand_tracking"), PRIMS]
# rounding units of the sweeps' row fields
UNITS = {"total_mw": 0.1, "delta_pct": 0.01, "offload_mbps": 0.01,
         "device_mw": 0.1, "uplink_mbps": 0.01, "backend_pods": 0.1,
         "delta_mw_vs_baseline": 0.1, "usd_per_day": 1.0,
         "kgco2_per_day": 1.0}


def _port(sc):
    return t_aria2.Scenario(sc.name, tuple(sc.on_device), sc.compression,
                            sc.fps_scale, sc.mcs_tier, sc.upload_duty,
                            sc.brightness)


def _assert_rows(got, want, path="rows"):
    """Rows equal, rounded numbers at most one rounding unit apart."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_row_value(got[k], want[k], k, f"{path}.{k}")
    else:
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_row_value(g, w, None, f"{path}[{i}]")


def _assert_row_value(got, want, key, path):
    if isinstance(want, (dict, list)):
        _assert_rows(got, want, path)
    elif isinstance(want, float) and key in UNITS:
        assert abs(got - want) <= UNITS[key] * (1 + 1e-9), (path, got, want)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL), (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------------------
# the paper's figures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", FIG4, ids="+".join)
def test_fig4_placement_deltas(placement):
    def delta(total):
        p0 = float(total(j_aria2.Scenario("t", ())))
        p = float(total(j_aria2.Scenario("t", placement)))
        return p0, p, 100 * (p - p0) / p0

    w0, w, want = delta(j_aria2.total_mw)
    g0, g, got = delta(lambda s: t_aria2.total_mw(_port(s), device=CPU))
    assert g0 == pytest.approx(w0, rel=RTOL)
    assert g == pytest.approx(w, rel=RTOL)
    # a delta of two totals each within rtol 1e-6
    assert abs(got - want) <= 100 * RTOL * (g + g0) / g0 * 1.01


def _component_rows(aria2, sc, **kw):
    rep = aria2.build_system(sc, **kw).evaluate()
    rev = {p: part for part, parts in j_aria2.PART_AGGREGATION.items()
           for p in parts}
    agg = {}
    for n, p in rep.per_component():
        agg[rev.get(n, n)] = agg.get(rev.get(n, n), 0.0) + p
    return sorted(agg.values(), reverse=True)


@pytest.fixture(scope="module")
def table3():
    return (_component_rows(t_aria2, _port(j_aria2.FULL_ON_DEVICE),
                            device=CPU),
            _component_rows(j_aria2, j_aria2.FULL_ON_DEVICE))


def test_table3_component_rows(table3):
    got, want = table3
    assert len(got) == len(want) == 145
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("threshold", (0.001, 0.005, 0.01, 0.05, 0.10))
def test_table3_buckets(table3, threshold):
    """The reference's bucket counts and shares, not the paper's (two
    buckets miss the paper in the reference)."""
    def bucket(rows):
        tot = sum(rows)
        sel = [p for p in rows if p <= threshold * tot]
        return len(sel), 100 * sum(sel) / tot

    (n_got, s_got), (n_want, s_want) = bucket(table3[0]), bucket(table3[1])
    assert n_got == n_want
    assert s_got == pytest.approx(s_want, rel=RTOL)


def test_table3_amdahl_bound(table3):
    got, want = (sum(r[:2]) / sum(r) for r in table3)
    assert got == pytest.approx(want, rel=RTOL)


def test_build_system_matches(table3):
    sc = j_aria2.Scenario("mix", ("vio", "asr"), compression=20.0,
                          fps_scale=2.0)
    theta = {"eff_scale": 0.97, "wifi_mw_per_mbps": 7.5}
    got = t_aria2.build_system(_port(sc), theta, device=CPU)
    want = j_aria2.build_system(sc, theta)
    assert [c.name for c in got.components] == \
        [c.name for c in want.components]
    assert {k: r.efficiency for k, r in got.rails.items()} == \
        {k: r.efficiency for k, r in want.rails.items()}
    g, w = got.evaluate(), want.evaluate()
    np.testing.assert_allclose(g.loads_mw, w.loads_mw, rtol=RTOL)
    assert g.total_mw == pytest.approx(w.total_mw, rel=RTOL)
    assert g.by_category() == pytest.approx(w.by_category(), rel=RTOL)


@pytest.mark.parametrize("sc", [j_aria2.FULL_ON_DEVICE, j_aria2.FULL_OFFLOAD,
                                j_aria2.Scenario("m", ("asr",), 40.0, 4.0)],
                         ids=lambda s: s.name)
def test_single_scenario_wrappers(sc):
    assert float(t_aria2.pd_share(_port(sc), device=CPU)) == pytest.approx(
        float(j_aria2.pd_share(sc)), rel=RTOL)
    assert float(t_aria2.offloaded_mbps(_port(sc), device=CPU)) == \
        pytest.approx(float(j_aria2.offloaded_mbps(sc)), rel=RTOL)
    theta = {"pj_ht": 3.0}
    got, th_got = t_aria2.component_loads(_port(sc), theta, device=CPU)
    want, th_want = j_aria2.component_loads(sc, theta)
    assert th_got == th_want and list(got) == list(want)
    np.testing.assert_allclose([float(v) for v in got.values()],
                               [float(v) for v in want.values()], rtol=RTOL)


def test_pd_share_is_the_references():
    got = float(t_aria2.pd_share(_port(j_aria2.FULL_ON_DEVICE), device=CPU))
    assert got == pytest.approx(float(j_aria2.pd_share(
        j_aria2.FULL_ON_DEVICE)), rel=RTOL)
    assert abs(got - 0.20) < 0.03


def test_fig5_scaling_projection():
    got = t_scaling.project(t_aria2.build_system(
        _port(j_aria2.FULL_ON_DEVICE), device=CPU), n_steps=4)
    want = j_scaling.project(j_aria2.build_system(j_aria2.FULL_ON_DEVICE),
                             n_steps=4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert list(g) == list(w) and g["node"] == w["node"]
        for k in w:
            if k == "node":
                continue
            tol = 0.1 if k.endswith("_mw") and k not in ("total_mw",
                                                         "pd_mw") else 0.0
            assert abs(g[k] - w[k]) <= max(tol * (1 + 1e-9),
                                           RTOL * abs(w[k])), (k, g, w)
    assert (t_scaling.STEP_FACTOR, t_scaling.NODE_NAMES,
            t_scaling.PD_STEP_FACTOR) == (j_scaling.STEP_FACTOR,
                                          j_scaling.NODE_NAMES,
                                          j_scaling.PD_STEP_FACTOR)


@pytest.mark.parametrize("comps,fps", [((1, 8, 64, 128), (1,)),
                                       ((1, 2, 4, 8, 16, 32, 64, 128),
                                        (1, 2, 4, 8, 16, 32))])
def test_fig6_compression_sweep(comps, fps):
    _assert_rows(t_dse.compression_sweep(comps, fps, device=CPU),
                 j_dse.compression_sweep(comps, fps))


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", (None, "aria2_display",
                                      "aria2_capture_only"))
def test_placement_sweep(platform):
    _assert_rows(t_dse.placement_sweep(platform, device=CPU),
                 j_dse.placement_sweep(platform))


@pytest.mark.parametrize("platform", (None, "rayban_cam"))
def test_pareto_points_and_front(platform):
    pts, front = t_dse.pareto(platform=platform, device=CPU)
    want_pts, want_front = j_dse.pareto(platform=platform)
    _assert_rows(pts, want_pts)
    key = [(r["on_device"], r["compression"]) for r in front]
    assert key == [(r["on_device"], r["compression"]) for r in want_front]


@pytest.mark.parametrize("platform,knobs", [
    (None, {}), ("aria2_display", {"brightnesses": (0.0, 0.5, 1.0)}),
    ("aria2_puck_split", {"mcs_tiers": (0, 2), "upload_duties": (0.3, 1.0)}),
])
def test_grid_sweep_totals(platform, knobs):
    got = t_dse.grid_sweep(platform, device=CPU, **knobs)
    want = j_dse.grid_sweep(platform, **knobs)
    np.testing.assert_array_equal(got.sset.placement, want.sset.placement)
    for k in ("total_mw", "offloaded_mbps", "pd_loss_mw", "loads_mw"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=RTOL,
                                   atol=1e-4 if k == "pd_loss_mw" else 0.0,
                                   err_msg=k)
    np.testing.assert_allclose(got.pd_share().numpy(),
                               np.asarray(want.pd_share()), rtol=RTOL)
    cats_got, cats_want = got.category_breakdown(), want.category_breakdown()
    assert sorted(cats_got) == sorted(cats_want)
    for c in cats_want:
        np.testing.assert_allclose(cats_got[c].numpy(),
                                   np.asarray(cats_want[c]), rtol=RTOL,
                                   err_msg=c)
    _assert_rows(got.rows(), want.rows())
    assert got.component_loads(5) == pytest.approx(
        want.component_loads(5), rel=RTOL)


def test_platform_ablation():
    names = ["aria2", "aria2_display", "aria2_capture_only", "rayban_cam",
             "aria2_puck_split"]
    for kw in ({}, {"on_device": PRIMS, "compression": 20.0}):
        _assert_rows(t_dse.platform_ablation(names, device=CPU, **kw),
                     j_dse.platform_ablation(names, **kw))


def test_sensitivity_gradients():
    sc = j_aria2.Scenario("m", ("vio", "hand_tracking"), 20.0, 2.0)
    for scenario, port_sc in ((None, None), (sc, _port(sc))):
        got = t_dse.sensitivity(port_sc, device=CPU)
        want = j_dse.sensitivity(scenario)
        assert [r["theta"] for r in got] == [r["theta"] for r in want]
        for g, w in zip(got, want):
            assert g["value"] == w["value"]
            for k in ("d_total_mw_d_theta", "elasticity"):
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-12), (
                    g["theta"], k)


# ---------------------------------------------------------------------------
# ScenarioSet surface and the module-level evaluators
# ---------------------------------------------------------------------------

def test_scenario_set_surface():
    scs = [j_aria2.FULL_ON_DEVICE, j_aria2.FULL_OFFLOAD,
           j_aria2.Scenario("", ("asr",), 40.0, 4.0, mcs_tier=2,
                            upload_duty=0.5)]
    got = t_scen.ScenarioSet.from_scenarios([_port(s) for s in scs])
    want = j_scen.ScenarioSet.from_scenarios(scs)
    for f in ("placement", "compression", "fps_scale", "mcs_tier",
              "upload_duty", "brightness"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert [got.label(i) for i in range(3)] == \
        [want.label(i) for i in range(3)]
    assert [got.on_device(i) for i in range(3)] == \
        [want.on_device(i) for i in range(3)]
    grid = t_scen.ScenarioSet.grid(compressions=(2.0, 4.0, 2.0))
    jgrid = j_scen.ScenarioSet.grid(compressions=(2.0, 4.0, 2.0))
    np.testing.assert_array_equal(grid.row_matrix(), jgrid.row_matrix())
    (u, inv), (ju, jinv) = grid.dedupe(), jgrid.dedupe()
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(u.row_matrix(), ju.row_matrix())
    knobbed = grid.with_knob(mcs_tier=0, upload_duty=0.25)
    jknobbed = jgrid.with_knob(mcs_tier=0, upload_duty=0.25)
    np.testing.assert_array_equal(knobbed.row_matrix(),
                                  jknobbed.row_matrix())
    assert knobbed.mcs_tier.dtype == jknobbed.mcs_tier.dtype
    with pytest.raises(ValueError, match="mcs_tier"):
        grid.with_knob(mcs_tier=3)
    with pytest.raises(ValueError, match="upload_duty"):
        grid.with_knob(upload_duty=1.5)


def test_module_level_evaluators():
    plat_t = t_aria2.aria2_display_platform()
    plat_j = j_aria2.aria2_display_platform()
    sset_t = t_scen.ScenarioSet.grid(brightnesses=(0.3,))
    sset_j = j_scen.ScenarioSet.grid(brightnesses=(0.3,))
    theta = {"wifi_link_mw": 150.0}
    for name in ("total_mw", "component_loads", "offloaded_mbps"):
        np.testing.assert_allclose(
            getattr(t_scen, name)(plat_t, sset_t, theta, CPU).numpy(),
            np.asarray(getattr(j_scen, name)(plat_j, sset_j, theta)),
            rtol=RTOL, err_msg=name)
    got = t_scen.category_breakdown(plat_t, sset_t, theta, CPU)
    want = j_scen.category_breakdown(plat_j, sset_j, theta)
    for c in want:
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                   rtol=RTOL, err_msg=c)
    out = t_scen.evaluate_batched(plat_t, sset_t.vec(CPU), theta)
    ref = j_scen.evaluate_batched(plat_j, sset_j.vec(), theta)
    for k in ("loads", "total", "pd_loss", "mbps"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=1e-4 if k == "pd_loss"
                                   else 0.0, err_msg=k)


# ---------------------------------------------------------------------------
# fleet sizing and the joint device + backend front
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sc", [
    j_aria2.FULL_OFFLOAD, j_aria2.FULL_ON_DEVICE,
    j_aria2.Scenario("gated", ("vio",), 20.0, 4.0, upload_duty=0.4),
], ids=lambda s: s.name)
def test_size_fleet_and_offload_summary(sc):
    for kw in ({}, {"n_users": 2.5e5, "duty": 0.8}):
        assert t_offload.size_fleet(_port(sc), **kw) == \
            j_offload.size_fleet(sc, **kw)
    _assert_rows(t_offload.offload_summary(_port(sc), device=CPU),
                 j_offload.offload_summary(sc))
    assert [d.__dict__ for d in t_offload.backend_demand(_port(sc))] == \
        [d.__dict__ for d in j_offload.backend_demand(sc)]


def test_fleet_sizing_rejects_bad_args():
    with pytest.raises(ValueError, match="n_users"):
        t_offload.size_fleet(t_aria2.FULL_OFFLOAD, n_users=0)
    with pytest.raises(ValueError, match="duty"):
        t_offload.pods_breakdown(t_scen.ScenarioSet.grid(), duty=1.5)
    assert t_offload.usd_per_pod_hour() == j_offload.usd_per_pod_hour()


def test_fleet_grid_and_pods_vector():
    kw = {"compressions": (4.0, 32.0), "fps_scales": (1.0, 8.0),
          "upload_duties": (0.5, 1.0)}
    sset_t, sset_j = t_scen.ScenarioSet.grid(**kw), \
        j_scen.ScenarioSet.grid(**kw)
    _assert_rows(t_offload.fleet_grid(sset_t, n_users=3e5, device=CPU),
                 j_offload.fleet_grid(sset_j, n_users=3e5))
    pods, src = t_offload.pods_vector(sset_t)
    jpods, jsrc = j_offload.pods_vector(sset_j)
    np.testing.assert_array_equal(pods, jpods)
    assert src == jsrc
    assert t_offload.missing_streams(src) == j_offload.missing_streams(jsrc)
    bd, jbd = t_offload.pods_breakdown(sset_t), j_offload.pods_breakdown(
        sset_j)
    assert bd.missing_streams() == jbd.missing_streams()
    assert (bd.archs, bd.cells) == (jbd.archs, jbd.cells)


@pytest.fixture(scope="module")
def joint():
    return t_dse.joint_pareto(device=CPU), j_dse.joint_pareto()


def test_joint_pareto_2304(joint):
    got, want = joint
    assert len(got) == len(want) == 2304
    np.testing.assert_allclose(got.device_mw, want.device_mw, rtol=RTOL)
    np.testing.assert_allclose(got.uplink_mbps, want.uplink_mbps, rtol=RTOL)
    np.testing.assert_array_equal(got.backend_pods, want.backend_pods)
    np.testing.assert_array_equal(got.front_mask, want.front_mask)
    assert got.sources == want.sources
    assert got.missing_streams() == want.missing_streams()
    assert got.stream_archs() == want.stream_archs()
    _assert_rows(got.front_rows(), want.front_rows())


@pytest.mark.parametrize("budgets", [
    {}, {"pod_budget": 40.0}, {"power_budget_mw": 1100.0},
    {"usd_budget_per_day": 3.0e5}, {"pod_budget": 1e-3},
])
def test_co_optimize_rows(joint, budgets):
    got, want = (t_dse.co_optimize(joint[0], **budgets),
                 j_dse.co_optimize(joint[1], **budgets))
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], dict):
            assert got[k]["index"] == want[k]["index"], k
    _assert_rows(got, want)


def test_joint_pareto_duty_axis():
    kw = {"compressions": (4.0, 16.0), "fps_scales": (1.0, 4.0),
          "upload_duties": (0.25, 1.0), "platform": "aria2_display",
          "brightnesses": (0.0, 0.8)}
    got, want = t_dse.joint_pareto(device=CPU, **kw), j_dse.joint_pareto(**kw)
    np.testing.assert_allclose(got.objectives(), want.objectives(),
                               rtol=RTOL)
    np.testing.assert_array_equal(got.front_mask, want.front_mask)


def _entry_points():
    """Every entry point of this slice that runs torch ops, as a call
    that forwards `device` when it is given and otherwise leaves the
    default (small inputs)."""
    from repro_torch.core import daysim
    sc = t_aria2.FULL_ON_DEVICE
    plat = t_aria2.aria2_platform()
    sset = t_scen.ScenarioSet.grid(compressions=(4.0,), fps_scales=(1.0,))
    small = {"compressions": (4.0,), "fps_scales": (1.0,)}
    return {
        "aria2.total_mw": lambda **d: t_aria2.total_mw(sc, **d),
        "aria2.pd_share": lambda **d: t_aria2.pd_share(sc, **d),
        "aria2.offloaded_mbps": lambda **d: t_aria2.offloaded_mbps(sc, **d),
        "aria2.component_loads": lambda **d: t_aria2.component_loads(
            sc, **d),
        "aria2.build_system": lambda **d: t_aria2.build_system(sc, **d),
        "scenarios.total_mw": lambda **d: t_scen.total_mw(plat, sset, **d),
        "scenarios.category_breakdown": lambda **d:
            t_scen.category_breakdown(plat, sset, **d),
        "offload.offload_summary": lambda **d: t_offload.offload_summary(
            sc, **d),
        "offload.fleet_grid": lambda **d: t_offload.fleet_grid(sset, **d),
        "dse.grid_sweep": lambda **d: t_dse.grid_sweep(**small, **d),
        "dse.placement_sweep": lambda **d: t_dse.placement_sweep(**d),
        "dse.compression_sweep": lambda **d: t_dse.compression_sweep(
            (4,), (1,), **d),
        "dse.sensitivity": lambda **d: t_dse.sensitivity(**d),
        "dse.pareto": lambda **d: t_dse.pareto((4,), **d),
        "dse.joint_pareto": lambda **d: t_dse.joint_pareto(
            **small, mcs_tiers=(1,), **d),
        "dse.platform_ablation": lambda **d: t_dse.platform_ablation(
            ["aria2", "rayban_cam"], **d),
        "daysim.simulate": lambda **d: daysim.simulate(
            "rayban_cam", daysim.DEFAULT_DESIGNS[0], "desk_day", dt_s=600.0,
            **d),
        "daysim.scan_integrate": lambda **d: daysim.scan_integrate(
            daysim.compiled_tables("rayban_cam", daysim.DEFAULT_DESIGNS[0],
                                   "desk_day", dt_s=600.0, device=CPU), **d),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_the_card(name):
    """Without a card the default device raises; device="cpu" runs."""
    import torch
    fn = _entry_points()[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert fn(device=CPU) is not None
