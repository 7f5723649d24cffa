"""Port parity of the whole slice: `repro_torch` day-Pareto pipeline and
design twin (on the CPU, through the day scan's plain version) against
the JAX reference's fused pipeline on the default grid.

Discrete outputs must be exactly equal; continuous ones are held to
the reference's own tolerances (`torch_day_reports.assert_reports_match`
states them and why bit equality is not expected)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import daysim as j_daysim
from repro.core import dse as j_dse
from repro.serving.twin import DesignTwin as JTwin
from repro_torch.core import daysim as t_daysim
from repro_torch.core import dse as t_dse
from repro_torch.kernels import day_scan as ds
from repro_torch.serving.twin import DesignTwin as TTwin
from torch_day_reports import assert_reports_match

DT = 60.0


@pytest.fixture(scope="module")
def ref_day():
    return j_dse.day_pareto(dt_s=DT)


@pytest.fixture(scope="module")
def port_day():
    return t_dse.day_pareto(dt_s=DT, device="cpu")


def test_discrete_outputs_exact(port_day, ref_day):
    assert port_day.combos == ref_day.combos
    assert port_day.skipped == ref_day.skipped
    np.testing.assert_array_equal(port_day.front_mask, ref_day.front_mask)
    np.testing.assert_array_equal(port_day.survives(), ref_day.survives())
    np.testing.assert_array_equal(port_day.shutdown, ref_day.shutdown)
    assert port_day.front_mask.sum() >= 1


def test_trace_extrema_and_sums(port_day, ref_day):
    assert_reports_match(port_day, ref_day)
    # on this grid the end SoC comes out bit-equal as well (peak skin
    # temperatures differ in the last ulp on some combos)
    np.testing.assert_array_equal(port_day.end_soc, ref_day.end_soc)


def test_survives_day(port_day, ref_day):
    np.testing.assert_array_equal(
        t_dse.survives_day(port_day, skin_limit_c=41.0),
        j_dse.survives_day(ref_day, skin_limit_c=41.0))
    with pytest.raises(TypeError, match="one or the other"):
        t_dse.survives_day(port_day, dt_s=DT)


def test_twin_what_if_battery_saver():
    jt = JTwin(dt_s=DT, warm=False)
    tt = TTwin(dt_s=DT, device="cpu", warm=False)
    want = jt.what_if(policy="battery_saver")
    got = tt.what_if(policy="battery_saver")
    assert {cb["policy"] for cb in got.combos} == {"battery_saver"}
    assert_reports_match(got, want)
    assert tt.stats.queries == 1 and tt.stats.traces == 0


def test_twin_value_what_ifs_with_survivors():
    """A bigger battery and hotter thresholds: value-level what-ifs that
    make combos survive, through both twins."""
    pol = dataclasses.replace(j_daysim.get_policy("thermal_governor"),
                              name="hot", temp_trip_c=41.0,
                              temp_clear_c=38.0)
    t_pol = dataclasses.replace(t_daysim.get_policy("thermal_governor"),
                                name="hot", temp_trip_c=41.0,
                                temp_clear_c=38.0)
    want = JTwin(dt_s=DT, warm=False).what_if(
        policy=pol, battery=j_daysim.BatterySpec("xl", 6000.0))
    got = TTwin(dt_s=DT, device="cpu", warm=False).what_if(
        policy=t_pol, battery=t_daysim.BatterySpec("xl", 6000.0))
    assert got.survives().any()
    assert_reports_match(got, want)


def test_twin_pipeline_cache_and_launch_count():
    """Repeat queries hit the resident pipeline; on the CPU the kernel
    counter never moves."""
    tt = TTwin(dt_s=600.0, device="cpu")
    before = ds.LAUNCHES
    tt.query()
    tt.query()
    assert tt.stats.pipeline_hits >= 2
    assert ds.LAUNCHES == before
    assert len(t_daysim._PIPELINES) <= t_daysim._PIPELINES_MAX


def test_bucket_padding_invisible():
    """A 9-combo grid pads to 16 lanes; the report has 9 rows and the
    same front as the reference."""
    kw = dict(platforms=("aria2_display",), designs=t_daysim.DEFAULT_DESIGNS,
              schedules=("commuter",),
              policies=("none", "thermal_governor", "battery_saver"),
              dt_s=120.0)
    got = t_dse.day_pareto(device="cpu", **kw)
    want = j_dse.day_pareto(**{**kw, "designs": j_daysim.DEFAULT_DESIGNS})
    assert len(got) == 9
    assert_reports_match(got, want)


@pytest.mark.parametrize("n,k,maximize,seed", [
    (64, 2, (), 0),
    (128, 3, (0,), 1),
    (257, 3, (0, 2), 2),
    (32, 4, (1,), 3),
])
def test_non_dominated_torch_random(n, k, maximize, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, k)).astype(np.float32)
    pts = np.round(pts * 4) / 4         # plenty of exact ties
    want = j_dse.non_dominated(pts, maximize=maximize)
    got = t_dse.non_dominated_torch(torch.as_tensor(pts),
                                    maximize=maximize).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_dse.non_dominated(pts, maximize), want)


def test_non_dominated_torch_duplicates_kept():
    pts = np.array([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0],
                    [0.0, 1.0]], np.float32)
    got = t_dse.non_dominated_torch(torch.as_tensor(pts)).numpy()
    assert got.tolist() == [True, True, True, False, True]


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        t_dse.day_pareto(engine="magic", dt_s=DT, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        t_daysim.day_grid(engine="magic", dt_s=DT, device="cpu")
