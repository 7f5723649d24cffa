"""The port's legacy day engine (on the CPU, through the day scan's plain
version): `day_grid(engine="legacy")` / `dse.day_pareto(engine="legacy")`
against the JAX legacy engine and against the port's fused engine, the
row cache, `cache_stats()`, `simulate_users` and `compiled_tables`.

Against the reference, discrete outputs are exact and continuous ones
within `torch_day_reports.assert_reports_match`'s tolerances.  Against
the port's own fused engine the contract is the reference's
(`tests/test_twin.py`): front, survival and shutdown flags identical,
trace extrema equal, sums (float64 on the host vs float32 on the
device) within rtol 1e-5 / atol 1e-5."""
import numpy as np
import pytest

from repro.core import daysim as j_daysim
from repro.core import dse as j_dse
from repro_torch.core import daysim, dse
from torch_day_reports import assert_reports_match

DT = 60.0


@pytest.fixture(scope="module")
def legacy_day():
    return dse.day_pareto(dt_s=DT, engine="legacy", device="cpu")


@pytest.fixture
def scans(monkeypatch):
    """Record the combo width N of every day-scan call of the engines."""
    widths = []
    scan = daysim._ds.day_scan

    def recording(tables):
        widths.append(tables["step_mw"].shape[-1])
        return scan(tables)

    monkeypatch.setattr(daysim._ds, "day_scan", recording)
    return widths


def test_legacy_matches_reference_legacy(legacy_day):
    want = j_dse.day_pareto(dt_s=DT, engine="legacy")
    assert_reports_match(legacy_day, want)
    assert legacy_day.front_mask.sum() >= 1


def test_legacy_matches_fused(legacy_day):
    fused = dse.day_pareto(dt_s=DT, device="cpu")
    assert fused.combos == legacy_day.combos
    assert fused.skipped == legacy_day.skipped
    np.testing.assert_array_equal(fused.front_mask, legacy_day.front_mask)
    np.testing.assert_array_equal(fused.survives(), legacy_day.survives())
    np.testing.assert_array_equal(fused.shutdown, legacy_day.shutdown)
    for k in ("end_soc", "peak_skin_c", "steady_mw", "day_hours"):
        np.testing.assert_array_equal(getattr(fused, k),
                                      getattr(legacy_day, k), err_msg=k)
    for k in ("time_to_empty_h", "pod_hours", "energy_mwh", "throttled_h"):
        np.testing.assert_allclose(getattr(fused, k), getattr(legacy_day, k),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_legacy_is_one_scan_and_a_repeat_hits_the_row_cache(scans):
    """One day scan at N = the number of combos (no bucket padding); a
    repeat evaluates no row again."""
    kw = dict(platforms=("aria2_display", "rayban_cam"),
              schedules=("commuter",), dt_s=DT, device="cpu")
    daysim.clear_row_cache()
    first = daysim.day_grid(engine="legacy", **kw)
    assert scans == [len(first)]
    assert first.front_mask is None
    stats = dict(daysim.CACHE_STATS)
    assert stats["evaluate_calls"] == 2             # one per platform
    again = daysim.day_grid(engine="legacy", with_front=True, **kw)
    assert daysim.CACHE_STATS["evaluate_calls"] == 2
    assert daysim.CACHE_STATS["misses"] == stats["misses"]
    assert daysim.CACHE_STATS["hits"] > stats["hits"]
    np.testing.assert_array_equal(again.front_mask, dse.non_dominated(
        again.objectives(), maximize=(0,)))
    for k in ("time_to_empty_h", "peak_skin_c", "pod_hours"):
        np.testing.assert_array_equal(getattr(first, k), getattr(again, k))


def test_row_cache_dedupes_rows_per_platform():
    """Policies share a design's level-0 rows: one row-stage pass for the
    platform, fewer rows than the combos list."""
    daysim.clear_row_cache()
    grid = dict(platforms=("aria2_display",),
                schedules=("commuter", "field_day"),
                policies=("none", "thermal_governor", "battery_saver"),
                device="cpu")
    daysim.build_combos(**grid)
    stats = dict(daysim.CACHE_STATS)
    assert stats["evaluate_calls"] == 1
    assert stats["misses"] < 3 * 2 * (5 * 6 + 1)
    daysim.build_combos(**grid)
    assert daysim.CACHE_STATS["evaluate_calls"] == 1
    assert daysim.CACHE_STATS["misses"] == stats["misses"]


def test_row_cache_fifo_eviction(monkeypatch):
    """Oldest rows go first past _ROW_CACHE_MAX, after the call that
    crossed the limit has read its rows (the reference's test)."""
    daysim.clear_row_cache()
    grid = dict(platforms=("rayban_cam",),
                designs=({"name": "d0", "on_device": ()},
                         {"name": "d1", "on_device": (),
                          "compression": 20.0}),
                schedules=("commuter",), policies=("none",), device="cpu")
    daysim.build_combos(**grid)
    n_rows = len(daysim._ROW_CACHE)
    assert n_rows > 4
    monkeypatch.setattr(daysim, "_ROW_CACHE_MAX", n_rows - 2)
    daysim.CACHE_STATS.update(hits=0, misses=0)
    daysim.build_combos(**grid)
    assert len(daysim._ROW_CACHE) == n_rows - 2
    assert daysim.CACHE_STATS["misses"] == 0
    daysim.CACHE_STATS.update(hits=0, misses=0)
    daysim.build_combos(**grid)
    assert len(daysim._ROW_CACHE) == n_rows - 2
    assert daysim.CACHE_STATS["misses"] == 2
    assert daysim.CACHE_STATS["hits"] > 0
    daysim.clear_row_cache()


def test_cache_stats_tiers():
    kw = dict(platforms=("rayban_cam",), schedules=("commuter",), dt_s=DT,
              device="cpu")
    daysim.clear_exec_cache()
    stats = daysim.cache_stats()
    assert set(stats) == {"rows", "assemblies", "pipelines", "exec"}
    for tier in stats.values():
        assert {"hits", "misses", "size"} <= set(tier)
    assert stats["assemblies"]["size"] == stats["pipelines"]["size"] == 0
    dse.day_pareto(**kw)
    dse.day_pareto(**kw)
    dse.day_pareto(engine="legacy", **kw)
    stats = daysim.cache_stats()
    assert stats["assemblies"]["misses"] == 1
    assert stats["assemblies"]["hits"] == 1
    assert stats["pipelines"]["size"] == 1
    assert stats["rows"]["size"] > 0
    assert stats["exec"] == {"hits": 0, "misses": 0, "traces": 0, "size": 0}
    daysim.clear_exec_cache()
    assert daysim.cache_stats()["pipelines"] == {
        "hits": 0, "misses": 0, "evictions": 0, "size": 0}


@pytest.mark.parametrize("fades,offsets", [
    ([0.0, 0.4], None),
    (None, [0.0, 8.0]),
    ([0.0, 0.2, 0.4], [-3.0, 0.0, 5.0]),
])
def test_simulate_users_matches_reference(fades, offsets, scans):
    args = ("aria2_display", "commuter", "battery_saver")
    want = j_daysim.simulate_users(
        args[0], j_daysim.DEFAULT_DESIGNS[0], *args[1:], fades=fades,
        ambient_offsets_c=offsets, dt_s=120.0)
    got = daysim.simulate_users(
        args[0], daysim.DEFAULT_DESIGNS[0], *args[1:], fades=fades,
        ambient_offsets_c=offsets, dt_s=120.0, device="cpu")
    assert scans == [len(want)]
    got.front_mask = dse.non_dominated(got.objectives(), maximize=(0,))
    want.front_mask = j_dse.non_dominated(want.objectives(), maximize=(0,))
    assert_reports_match(got, want)
    np.testing.assert_array_equal(got.battery_fade, want.battery_fade)
    assert got.rows() == want.rows()


def test_simulate_users_effects():
    rep = daysim.simulate_users(
        "aria2_display", daysim.DEFAULT_DESIGNS[0], "commuter",
        "battery_saver", fades=[0.0, 0.4], ambient_offsets_c=[0.0, 8.0],
        dt_s=120.0, device="cpu")
    assert rep.time_to_empty_h[1] < rep.time_to_empty_h[0]
    assert rep.peak_skin_c[1] > rep.peak_skin_c[0] + 4.0
    assert rep.row(1)["battery_fade"] == 0.4
    assert "battery_fade" not in rep.row(0)


@pytest.mark.parametrize("schedule,policy", [
    ("commuter", "none"),
    ("commuter", "battery_saver"),
    ("field_day", "thermal_governor"),
])
def test_compiled_tables_match_reference(schedule, policy):
    """Every table equal to the reference's; the glasses and puck power
    within rtol 1e-6 (the row stage's tolerance, `test_torch_core.py`:
    XLA contracts multiply-adds such as the puck's base + mW/Mbps x
    Mbps into one rounding)."""
    want = j_daysim.compiled_tables("aria2_puck_split",
                                    j_daysim.DEFAULT_DESIGNS[1], schedule,
                                    policy, dt_s=DT)
    got = daysim.compiled_tables("aria2_puck_split",
                                 daysim.DEFAULT_DESIGNS[1], schedule,
                                 policy, dt_s=DT, device="cpu")
    assert set(got) == set(want)
    assert got["const"] == {k: np.float32(v)
                            for k, v in want["const"].items()}
    power = ("step_mw", "step_mw_p")
    for k in set(want) - {"const", *power}:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in power:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_day_grid_defaults_to_the_legacy_engine(legacy_day):
    """`day_grid()` with no engine is the reference's default, legacy:
    bit-equal to engine="legacy" and to the JAX default in the fields
    where the fused engine's float32 sums differ."""
    got = daysim.day_grid(dt_s=DT, device="cpu")
    legacy = daysim.day_grid(dt_s=DT, engine="legacy", device="cpu")
    want = j_daysim.day_grid(dt_s=DT)
    assert got.combos == legacy.combos == want.combos
    for k in ("pod_hours", "time_to_empty_h", "throttled_h"):
        np.testing.assert_array_equal(getattr(got, k), getattr(legacy, k))
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        np.testing.assert_array_equal(getattr(got, k),
                                      getattr(legacy_day, k))
