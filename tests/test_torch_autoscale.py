"""Port parity: `offload.curve_cost` and the autoscaler
(`core/autoscale.py`) against the JAX reference on the CPU.

`curve_cost` is host numpy in float64 in both packages: its results are
held bit for bit.  The autoscaler's capacity scan is float32 in both
(XLA's scan there, eager PyTorch steps here): its outputs are held to
rtol 1e-6 and its event counts exactly, on the pinned ramp, the `INSTANT`
spec, the default spec on a fleet curve (dropped stream-hours), and the
hysteresis band."""
import json

import numpy as np
import pytest
import torch

from repro.core import autoscale as j_autoscale
from repro.core import fleet as j_fleet
from repro.core import offload as j_offload
from repro_torch.core import autoscale, fleet, offload
from repro_torch.core.autoscale import AutoscalerSpec

CPU = "cpu"
COUNTS = ("scale_down_events",)


def jspec(spec: AutoscalerSpec):
    return j_autoscale.AutoscalerSpec.from_dict(spec.to_dict())


def assert_same(got, want, rtol: float = 0.0, path: str = "") -> None:
    """Nested dicts of floats / arrays: equal keys, values within `rtol`
    (0: bit for bit)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], rtol, f"{path}/{k}")
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, path
        if rtol == 0.0 or path.rsplit("/", 1)[-1] in COUNTS:
            assert np.array_equal(g, w), path
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0,
                                       err_msg=path)


@pytest.fixture(scope="module")
def fleet_curve():
    """A default-mix fleet day's curves (64 users of the reference's
    draw at dt_s 120), as the reference's autoscale tests price them."""
    jpop = j_fleet.sample_population(j_fleet.DEFAULT_POPULATION, 64, 0)
    pop = fleet.Population(fleet.DEFAULT_POPULATION,
                           *(np.asarray(getattr(jpop, k)) for k in (
                               "archetype", "tz_hours", "ambient_offset_c",
                               "fade")))
    return fleet.fleet_day(pop, dt_s=120.0, device=CPU)


# ---------------------------------------------------------------------------
# curve_cost: bit for bit
# ---------------------------------------------------------------------------

CURVES = [
    (np.asarray([1.0, 3.0, 2.0, 2.0]), 6.0, False),
    (np.stack([np.full(24, 2.0), np.full(24, 1.0), np.zeros(24)], 1), 1.0,
     True),
    (np.ones(48), 0.5, False),
    (np.zeros(24), 1.0, False),
    (np.abs(np.sin(np.arange(96) / 7.0))[:, None]
     * np.asarray([[1.0, 0.3, 2.5, 0.0]]), 0.25, True),
]


@pytest.mark.parametrize("curve,bin_hours,per_stream", CURVES,
                         ids=range(len(CURVES)))
def test_curve_cost_bit_equal(curve, bin_hours, per_stream):
    got = offload.curve_cost(curve, bin_hours, per_stream=per_stream,
                             device=CPU)
    want = j_offload.curve_cost(curve, bin_hours, per_stream=per_stream)
    assert_same(got, want)


def test_curve_cost_bit_equal_on_a_fleet_curve(fleet_curve):
    bh = 24.0 / fleet_curve.curve.shape[0]
    for c in (fleet_curve.curve, fleet_curve.curve_total):
        assert_same(offload.curve_cost(c, bh, device=CPU),
                    j_offload.curve_cost(c, bh))


def test_curve_cost_validations():
    for bad, match in ((np.asarray([1.0, -1.0]), "negative"),
                       (np.zeros((0,)), "curve"),
                       (np.ones(48), "24 h")):
        for mod in (offload, j_offload):
            with pytest.raises(ValueError, match=match):
                mod.curve_cost(bad)
    with pytest.raises(ValueError, match="24 h"):
        offload.curve_cost(np.ones(24), bin_hours=0.5)
    with pytest.raises(ValueError, match="per_stream"):
        offload.curve_cost(np.ones(24), per_stream=True)


def test_curve_cost_dynamic_entry(fleet_curve):
    rep = fleet_curve
    bh = 24.0 / rep.curve.shape[0]
    kw = dict(autoscaler=AutoscalerSpec(),
              stream_curve=rep.stream_curve_total)
    got = offload.curve_cost(rep.curve_total, bh, device=CPU, **kw)
    want = j_offload.curve_cost(rep.curve_total, bh,
                                autoscaler=jspec(kw["autoscaler"]),
                                stream_curve=rep.stream_curve_total)
    assert_same(got, want, rtol=1e-6)
    assert got["dropped_stream_hours"] > 0.0
    assert got["dynamic"]["usd"] > got["autoscaled"]["usd"]
    assert rep.capacity_plan(autoscaler=AutoscalerSpec())[
        "dropped_stream_hours"] == got["dropped_stream_hours"]


# ---------------------------------------------------------------------------
# AutoscalerSpec
# ---------------------------------------------------------------------------

def test_spec_json_roundtrip_and_reference_equal():
    for spec in (AutoscalerSpec(), autoscale.INSTANT,
                 AutoscalerSpec("capped", 0.9, 1.5, 0.2, 2.0, 500.0, 6)):
        back = AutoscalerSpec.from_dict(
            json.loads(json.dumps(spec.to_dict())))
        assert back == spec
        assert jspec(spec).to_dict() == spec.to_dict()
    assert autoscale.INSTANT.to_dict() == j_autoscale.INSTANT.to_dict()


@pytest.mark.parametrize("kw,match", [
    ({"target_utilization": 0.0}, "target_utilization"),
    ({"target_utilization": 1.2}, "target_utilization"),
    ({"spinup_h": -0.1}, "spinup_h"),
    ({"down_band": 1.0}, "down_band"),
    ({"min_pods": -1.0}, "min_pods"),
    ({"min_pods": 5.0, "max_pods": 2.0}, "max_pods"),
    ({"substeps_per_bin": 0}, "substeps_per_bin"),
])
def test_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        AutoscalerSpec(**kw)


# ---------------------------------------------------------------------------
# simulate against the reference
# ---------------------------------------------------------------------------

def _ramp():
    curve = np.full(24, 10.0)
    curve[8:20] = 100.0
    return curve, np.full(24, 40.0)


@pytest.mark.parametrize("spec", [
    AutoscalerSpec(target_utilization=1.0, spinup_h=1.0, down_band=0.0),
    AutoscalerSpec(),
    autoscale.INSTANT,
    AutoscalerSpec("capped", 0.9, 1.5, 0.2, 12.0, 90.0, 6),
], ids=["ramp_1h", "default", "instant", "capped"])
def test_simulate_matches_reference_on_the_ramp(spec):
    curve, streams = _ramp()
    got = autoscale.simulate(spec, curve, stream_curve=streams, device=CPU)
    want = j_autoscale.simulate(jspec(spec), curve, stream_curve=streams)
    assert_same(got, want, rtol=1e-6)


def test_ramp_outruns_spinup_pinned():
    curve, streams = _ramp()
    spec = AutoscalerSpec(target_utilization=1.0, spinup_h=1.0,
                          down_band=0.0)
    sim = autoscale.simulate(spec, curve, stream_curve=streams, device=CPU)
    assert sim["effective_spinup_h"] == 1.0
    assert np.isclose(sim["dropped_pod_hours"], 90.0, rtol=1e-5)
    assert np.isclose(sim["dropped_stream_hours"], 36.0, rtol=1e-5)
    assert np.isclose(sim["served_pod_hours"], curve.sum() - 90.0,
                      rtol=1e-5)


@pytest.mark.parametrize("spinup", [2.0, 1.0, 0.5, 0.25, 0.0])
def test_fleet_curve_matches_reference(fleet_curve, spinup):
    """The default mix's morning ramp against spin-up latencies: dropped
    stream-hours as the reference computes them; zero at no latency,
    where the provisioned pod-hours are the curve's integral."""
    rep = fleet_curve
    bh = 24.0 / rep.curve.shape[0]
    spec = AutoscalerSpec(target_utilization=1.0, spinup_h=spinup,
                          down_band=0.0)
    got = autoscale.simulate(spec, rep.curve_total, bh,
                             stream_curve=rep.stream_curve_total,
                             device=CPU)
    want = j_autoscale.simulate(jspec(spec), rep.curve_total, bh,
                                stream_curve=rep.stream_curve_total)
    assert_same(got, want, rtol=1e-6)
    if spinup == 0.0:
        assert got["dropped_stream_hours"] == 0.0
        assert np.isclose(got["provisioned_pod_hours"],
                          rep.curve_total.sum() * bh, rtol=1e-5)
    else:
        assert got["dropped_stream_hours"] > 0.0


def test_instant_prices_the_curve_integral(fleet_curve):
    rep = fleet_curve
    bh = 24.0 / rep.curve.shape[0]
    plan = rep.capacity_plan(autoscaler=autoscale.INSTANT)
    assert plan["dropped_pod_hours"] == 0.0
    assert np.isclose(plan["dynamic"]["usd"], plan["autoscaled"]["usd"],
                      rtol=1e-5)
    assert np.isclose(plan["dynamic"]["pod_hours"],
                      rep.curve_total.sum() * bh, rtol=1e-5)


@pytest.mark.parametrize("band,amp", [(0.05, 0.0), (0.1, 0.5),
                                      (0.25, 0.95), (0.5, 0.7)])
def test_hysteresis_never_chatters(band, amp):
    t = np.arange(24, dtype=np.float64)
    wiggle = 0.5 - 0.5 * np.cos(t * 1.7)
    curve = 100.0 * (1.0 - band * amp * wiggle)
    spec = AutoscalerSpec(target_utilization=0.8, spinup_h=0.5,
                          down_band=band)
    sim = autoscale.simulate(spec, curve, device=CPU)
    assert_same(sim, j_autoscale.simulate(jspec(spec), curve), rtol=1e-6)
    np.testing.assert_allclose(sim["capacity_curve"],
                               curve[0] / spec.target_utilization,
                               rtol=1e-6)
    assert sim["launched_pods"] == 0.0
    assert sim["scale_down_events"] == 0
    assert sim["dropped_pod_hours"] == 0.0


def test_simulate_validates_curve():
    with pytest.raises(ValueError, match="negative"):
        autoscale.simulate(autoscale.INSTANT, [1.0] * 23 + [-1.0],
                           device=CPU)
    with pytest.raises(ValueError, match="24 h"):
        autoscale.simulate(autoscale.INSTANT, np.ones(48), device=CPU)
    with pytest.raises(ValueError, match="demand curve"):
        autoscale.simulate(autoscale.INSTANT, np.ones((24, 2)), device=CPU)
    with pytest.raises(ValueError, match="stream_curve"):
        autoscale.simulate(autoscale.INSTANT, np.ones(24),
                           stream_curve=np.ones(12), device=CPU)


def test_simulate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autoscale.simulate(autoscale.INSTANT, np.ones(24))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offload.curve_cost(np.ones(24), autoscaler=autoscale.INSTANT)
