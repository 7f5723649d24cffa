"""Port parity: the fleet layer (`core/fleet.py`) against the JAX
reference on the CPU, and the day scan's initial-SoC input in its plain
versions.

Populations come from the reference's own sampler (threefry cannot be
reproduced), fed to the port as numpy arrays; the port's sampler is
tested by its distribution, its ranges and its determinism in `key`.

What is held to what:
  * the port's `fleet_day` against the JAX `fleet_day`, each on its own
    archetype tables: survival, shutdown and time-to-empty equal, peak
    skin within rtol 1e-6, end SoC within 1e-6, curves and pod-hours
    within rtol 1e-6 (one day, and a 7-day undercharged week).  The two packages'
    row stages put the archetype tables a few ulps apart, and XLA on the
    CPU contracts multiply-adds, so the continuous traces differ in
    their last bits;
  * on the reference's own archetype tables, the port's `fleet_day`
    against the reference's per-user numpy oracle (`reference_fleet`,
    its `reference_integrate` read for the end SoC): every per-user
    output equal, the curves within rtol 1e-12 (float64 sums in another
    order);
  * the port's `fleet_day` against its own `reference_fleet`: per-user
    outputs equal, curves within rtol 1e-12.
The population with mixed survival is asserted to be mixed."""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import daysim as j_daysim
from repro.core import fleet as j_fleet
from repro_torch.core import daysim, fleet
from repro_torch.kernels import day_scan as ds
from torch_day_tables import random_tables

DT = 60.0
CPU = "cpu"
N_MIXED, KEY_MIXED = 24, 1       # the reference's draw: 7 of 24 survive
PER_USER_EXACT = ("time_to_empty_h", "shutdown", "day_hours")
LEVEL_FIELDS = ("mw_levels", "pods_levels", "mbps_levels",
                "pods_stream_levels", "mw_p_levels")


def port_pop(jpop, spec=fleet.DEFAULT_POPULATION) -> fleet.Population:
    """The reference's sampled population as the port's."""
    return fleet.Population(spec, np.asarray(jpop.archetype),
                            np.asarray(jpop.tz_hours),
                            np.asarray(jpop.ambient_offset_c),
                            np.asarray(jpop.fade))


def assert_matches_jax(got, want) -> None:
    assert np.array_equal(got.survives(), want.survives())
    for k in PER_USER_EXACT:
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    np.testing.assert_allclose(got.peak_skin_c, want.peak_skin_c,
                               rtol=1e-6, atol=0.0)
    # SoC in [0, 1] after 720 steps of ulp-apart tables: 1.5e-7 read
    np.testing.assert_allclose(got.end_soc, want.end_soc, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.pod_hours, want.pod_hours, rtol=1e-6,
                               atol=1e-9)
    for k in ("curve", "stream_curve"):
        w = getattr(want, k)
        np.testing.assert_allclose(getattr(got, k), w, rtol=1e-6,
                                   atol=1e-6 * max(1.0, float(w.max())),
                                   err_msg=k)


def chunked(size: int, *args, **kw):
    """`fleet.fleet_day` with chunks of `size` users."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fleet, "CHUNK_USERS", size)
        return fleet.fleet_day(*args, **kw)


@pytest.fixture(scope="module")
def jpop():
    return j_fleet.sample_population(j_fleet.DEFAULT_POPULATION, N_MIXED,
                                     KEY_MIXED)


@pytest.fixture(scope="module")
def pair(jpop):
    # chunks of 10 users: three launches, offsets split across chunks
    return (chunked(10, port_pop(jpop), dt_s=DT, device=CPU),
            j_fleet.fleet_day(jpop, dt_s=DT))


@pytest.fixture
def reference_tables(monkeypatch):
    """The port's archetype combos carrying the reference's level tables
    (the reference's row stage)."""
    real = fleet._archetype_combos

    def combos(spec, theta=None, results_dir=None, device="cuda"):
        cbs = real(spec, theta, results_dir, device)
        jspec = j_fleet.PopulationSpec.from_dict(spec.to_dict())
        for cb, jcb in zip(cbs, j_fleet._archetype_combos(jspec)):
            for f in LEVEL_FIELDS:
                setattr(cb, f, np.asarray(getattr(jcb, f)))
        return cbs

    monkeypatch.setattr(fleet, "_archetype_combos", combos)


# ---------------------------------------------------------------------------
# fleet_day against the reference
# ---------------------------------------------------------------------------

def test_population_has_mixed_survival(pair):
    rep, ref = pair
    assert 0 < rep.survives().sum() < len(rep)
    assert np.array_equal(rep.survives(), ref.survives())


def test_fleet_day_matches_jax(pair):
    rep, ref = pair
    assert rep.curve.shape == ref.curve.shape \
        == (fleet.DEFAULT_N_BINS, len(daysim.STREAMS))
    assert rep.streams == tuple(j_daysim.STREAMS)
    assert rep.n_shards == 1 and rep.device == CPU
    assert_matches_jax(rep, ref)


def test_fleet_day_equals_reference_oracle(jpop, reference_tables,
                                           monkeypatch):
    """On the reference's tables the port's fleet day equals the
    reference's per-user numpy oracle on every per-user output."""
    got = chunked(10, port_pop(jpop), dt_s=DT, device=CPU)
    end_soc, real = [], j_daysim.reference_integrate

    def recording(tb):          # the oracle's last SoC of each user
        ref = real(tb)
        end_soc.append(float(ref["soc"][-1]))
        return ref

    monkeypatch.setattr(j_daysim, "reference_integrate", recording)
    jref = j_fleet.reference_fleet(jpop, dt_s=DT)
    assert 0 < got.survives().sum() < len(got)
    for k in ("time_to_empty_h", "peak_skin_c", "shutdown", "pod_hours",
              "day_hours"):
        assert np.array_equal(getattr(got, k), getattr(jref, k)), k
    assert np.array_equal(got.end_soc, np.asarray(end_soc))
    assert np.array_equal(got.survives(), jref.survives())
    for k in ("curve", "stream_curve"):
        np.testing.assert_allclose(getattr(got, k), getattr(jref, k),
                                   rtol=1e-12, atol=0.0, err_msg=k)


def test_fleet_day_matches_own_reference_fleet(pair):
    rep, _ = pair
    ref = fleet.reference_fleet(rep.population, dt_s=DT, device=CPU)
    for k in ("time_to_empty_h", "peak_skin_c", "end_soc", "shutdown",
              "pod_hours", "day_hours"):
        assert np.array_equal(getattr(rep, k), getattr(ref, k)), k
    for k in ("curve", "stream_curve"):
        np.testing.assert_allclose(getattr(rep, k), getattr(ref, k),
                                   rtol=1e-12, atol=0.0, err_msg=k)


@pytest.mark.parametrize("night_mw", [50.0, 0.0])
def test_undercharged_week_matches_jax(jpop, night_mw):
    """Seven days with a trickle (or no) overnight charge: later days
    start below a full battery through the kernel's initial-SoC input."""
    got = chunked(16, port_pop(jpop), dt_s=DT, n_days=7,
                  overnight_charge_mw=night_mw, device=CPU)
    want = j_fleet.fleet_day(jpop, dt_s=DT, n_days=7,
                             overnight_charge_mw=night_mw)
    assert got.n_days == 7
    assert_matches_jax(got, want)
    one = fleet.fleet_day(port_pop(jpop), dt_s=DT, device=CPU)
    assert got.survival_rate() < one.survival_rate()
    assert np.all(got.time_to_empty_h <= one.time_to_empty_h * 7 + 1e-9)


def test_each_day_launches_from_its_own_start(pair, monkeypatch):
    """Day 0 launches from a full battery, each later day from the
    night's top-up of the day before; the tables a launch was given are
    not changed after it."""
    calls, scan = [], ds.day_scan

    def recording(tables, full=False):
        calls.append(tables)
        return scan(tables, full)

    monkeypatch.setattr(ds, "day_scan", recording)
    rep = fleet.fleet_day(pair[0].population.take(np.arange(8)), dt_s=DT,
                          n_days=3, overnight_charge_mw=50.0, device=CPU)
    assert len(calls) == 3
    assert not any(k in calls[0] for k in ds.SOC0_KEYS)
    assert bool((calls[1]["soc0"] < 1.0).any())
    assert calls[1] is not calls[2]
    assert calls[1]["soc0"] is not calls[2]["soc0"]
    assert rep.n_days == 3


def test_recharged_week_repeats_the_day(pair):
    rep, _ = pair
    week = fleet.fleet_day(rep.population, dt_s=DT, n_days=7, device=CPU)
    scale = max(1.0, float(rep.curve.max()))
    np.testing.assert_allclose(week.curve, rep.curve, rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(week.day_hours, rep.day_hours * 7)
    died = rep.time_to_empty_h < rep.day_hours - 1e-9
    assert np.array_equal(week.time_to_empty_h[died],
                          rep.time_to_empty_h[died])


def test_chunks_and_positions_do_not_change_users(pair):
    rep, _ = pair
    pop = rep.population
    small = chunked(3, pop, dt_s=DT, device=CPU)
    part = fleet.fleet_day(pop.take(np.arange(5, 17)), dt_s=DT, device=CPU)
    for k in ("time_to_empty_h", "peak_skin_c", "end_soc", "shutdown",
              "pod_hours"):
        assert np.array_equal(getattr(small, k), getattr(rep, k)), k
        assert np.array_equal(getattr(part, k), getattr(rep, k)[5:17]), k
    np.testing.assert_allclose(small.curve, rep.curve, rtol=1e-12, atol=0)


def test_curve_integral_and_fleet_scaling(pair):
    rep, _ = pair
    bin_hours = 24.0 / rep.curve.shape[0]
    assert np.isclose(rep.curve_total.sum() * bin_hours,
                      rep.pod_hours.sum(), rtol=1e-6)
    big = fleet.fleet_day(rep.population, dt_s=DT, fleet_size=24000.0,
                          device=CPU)
    np.testing.assert_allclose(big.curve, rep.curve * 1000.0, rtol=1e-12)
    assert big.fleet_size == 24000.0
    assert float(rep.curve.min()) >= 0.0 and float(rep.curve.sum()) > 0.0


def test_report_plumbing_matches_jax(pair):
    rep, ref = pair
    assert rep.tte_quantiles() == ref.tte_quantiles()
    assert rep.by_archetype() == ref.by_archetype()
    got, want = rep.capacity_plan(), ref.capacity_plan()
    assert set(got) == set(want)
    for k in ("survival_rate", "tte_quantiles_h", "shutdowns",
              "fleet_size"):
        assert got[k] == want[k], k
    for k in ("peak_pods", "trough_pods", "trough_peak_ratio"):
        assert np.isclose(got[k], want[k], rtol=1e-6), k
    assert np.isclose(got["autoscaled"]["usd"], want["autoscaled"]["usd"],
                      rtol=1e-6)


def test_timezone_binning_phase_shift():
    a = replace(fleet.DEFAULT_POPULATION.archetypes[0],
                ambient_offset_c=(0.0, 0.0), fade=(0.0, 0.0))

    def mk(tz):
        return fleet.PopulationSpec("one", (a,), tz_hours=(tz,))

    r0 = fleet.fleet_day(mk(0.0), 1, key=0, dt_s=120.0, device=CPU)
    r6 = fleet.fleet_day(mk(-6.0), 1, key=0, dt_s=120.0, device=CPU)
    np.testing.assert_allclose(np.roll(r0.curve_total, 6), r6.curve_total,
                               rtol=1e-6, atol=1e-9)
    assert np.array_equal(r0.time_to_empty_h, r6.time_to_empty_h)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def test_fleet_day_validates_arguments(pair):
    pop = pair[0].population
    with pytest.raises(ValueError, match="n_shards"):
        fleet.fleet_day(pop, dt_s=DT, n_shards=2, device=CPU)
    with pytest.raises(ValueError, match="n_days"):
        fleet.fleet_day(pop, dt_s=DT, n_days=0, device=CPU)
    with pytest.raises(ValueError, match="overnight_charge_mw"):
        fleet.fleet_day(pop, dt_s=DT, overnight_charge_mw=-1.0,
                        device=CPU)
    with pytest.raises(ValueError, match="n_users"):
        fleet.fleet_day(fleet.DEFAULT_POPULATION, device=CPU)
    with pytest.raises(TypeError, match="PopulationSpec"):
        fleet.fleet_day("world_mix", 4, device=CPU)
    one = fleet.fleet_day(pop.take([0, 1]), dt_s=DT, n_shards=1,
                          device=CPU)
    assert one.n_shards == 1
    bad = fleet.ArchetypeSpec("bad", 1.0, "rayban_cam",
                              daysim.DEFAULT_DESIGNS[2], "commuter_dock")
    with pytest.raises(ValueError, match="on-device"):
        fleet.fleet_day(fleet.PopulationSpec("p", (bad,)), 4, key=0,
                        dt_s=120.0, device=CPU)


def test_entry_points_default_to_the_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    pop = pair[0].population.take([0])
    for call in (lambda: fleet.fleet_day(pop, dt_s=DT),
                 lambda: fleet.prepare_fleet(pop.spec, dt_s=DT),
                 lambda: fleet.reference_fleet(pop, dt_s=DT)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_prep_reuse_and_mismatch(pair):
    rep = pair[0]
    pop = rep.population
    prep = fleet.prepare_fleet(pop.spec, dt_s=DT, device=CPU)
    again = chunked(10, pop, dt_s=DT, prep=prep, device=CPU)
    for k in ("time_to_empty_h", "peak_skin_c", "end_soc", "pod_hours",
              "curve", "stream_curve"):
        assert np.array_equal(getattr(again, k), getattr(rep, k)), k
    with pytest.raises(ValueError, match="disagree"):
        fleet.fleet_day(pop, dt_s=120.0, prep=prep, device=CPU)
    other = replace(pop, spec=pop.spec.with_overrides("variant"))
    with pytest.raises(ValueError, match="different PopulationSpec"):
        fleet.fleet_day(other, dt_s=DT, prep=prep, device=CPU)
    assert fleet.FLEET_STATS["traces"] == 0


def test_prep_tables_layout(pair):
    """The archetype tables in the kernel's time-major layout equal the
    reference's stacked (T, A, ...) tables at the same indices."""
    prep = fleet.prepare_fleet(fleet.DEFAULT_POPULATION, dt_s=DT,
                               device=CPU)
    jprep = j_fleet.prepare_fleet(j_fleet.DEFAULT_POPULATION, dt_s=DT)
    xs, jxs = prep.xs_dev, jprep.xs_dev
    t, n_lvl, n_arch = xs["step_mw"].shape
    assert (t, n_arch) == tuple(np.asarray(jxs["amb"]).shape)
    for k, jk in (("step_mw", "mw"), ("step_mw_p", "mw_p"),
                  ("step_pods", "pods")):
        np.testing.assert_allclose(
            xs[k].numpy(), np.asarray(jxs[jk]).transpose(0, 2, 1),
            rtol=1e-6, atol=1e-6, err_msg=k)
    for k, jk in (("ambient", "amb"), ("active", "active"),
                  ("valid", "valid"), ("charge", "charge"),
                  ("charge_p", "charge_p")):
        assert np.array_equal(xs[k].numpy(), np.asarray(jxs[jk])), k
    ps = xs["pods_stream"].reshape(t, n_lvl, n_arch, -1).numpy()
    np.testing.assert_allclose(
        ps, np.asarray(jxs["pods_stream"]).transpose(0, 3, 1, 2),
        rtol=1e-6, atol=0.0)
    assert np.array_equal(prep.bins, np.asarray(jxs["bins"]))
    assert np.array_equal(prep.uniq, jprep.uniq)
    assert np.array_equal(prep.day_steps_a, jprep.day_steps_a)
    assert np.array_equal(prep.amult, jprep.amult)
    for k, v in jprep.const_a.items():
        assert np.array_equal(prep.const_a[k], v), k


# ---------------------------------------------------------------------------
# specs: JSON round trips, overrides, validation
# ---------------------------------------------------------------------------

def test_population_spec_json_roundtrip_and_reference_equal():
    spec = fleet.DEFAULT_POPULATION
    back = fleet.PopulationSpec.from_dict(
        json.loads(json.dumps(spec.to_dict())))
    assert back == spec
    assert spec.to_dict() == j_fleet.DEFAULT_POPULATION.to_dict()
    a = fleet.ArchetypeSpec(
        "inline", 1.0, "aria2_display", daysim.DEFAULT_DESIGNS[0],
        daysim.get_schedule("commuter"),
        daysim.get_policy("battery_saver"))
    inline = fleet.PopulationSpec("p", (a,), tz_hours=(0.0, 5.5))
    assert fleet.PopulationSpec.from_dict(
        json.loads(json.dumps(inline.to_dict()))) == inline
    assert inline.to_dict() == j_fleet.PopulationSpec.from_dict(
        inline.to_dict()).to_dict()


@pytest.mark.parametrize("policy,design", [
    ("none", 2), ("battery_saver", 0), (None, 1), ("thermal_governor",
                                                   None)])
def test_with_overrides_matches_reference(policy, design):
    row = None if design is None else daysim.DEFAULT_DESIGNS[design]
    got = fleet.DEFAULT_POPULATION.with_overrides("v", policy=policy,
                                                  design=row)
    want = j_fleet.DEFAULT_POPULATION.with_overrides(
        "v", policy=policy,
        design=None if design is None else j_daysim.DEFAULT_DESIGNS[design])
    assert got.to_dict() == want.to_dict()


def test_spec_validation():
    a = fleet.DEFAULT_POPULATION.archetypes[0]
    with pytest.raises(ValueError, match="weight"):
        replace(a, weight=0.0)
    with pytest.raises(ValueError, match="fade"):
        replace(a, fade=(0.2, 1.0))
    with pytest.raises(ValueError, match="lo > hi"):
        replace(a, ambient_offset_c=(5.0, -5.0))
    with pytest.raises(ValueError, match="wake_hour"):
        replace(a, wake_hour=24.5)
    with pytest.raises(ValueError, match="archetype"):
        fleet.PopulationSpec("empty", ())
    with pytest.raises(ValueError, match="tz_weights"):
        fleet.PopulationSpec("bad", (a,), tz_hours=(0.0, 1.0),
                             tz_weights=(1.0,))


# ---------------------------------------------------------------------------
# the port's sampler: determinism, ranges, distribution
# ---------------------------------------------------------------------------

FIELDS = ("archetype", "tz_hours", "ambient_offset_c", "fade")


def test_sampling_deterministic_in_key():
    p1 = fleet.sample_population(fleet.DEFAULT_POPULATION, 64, key=42)
    p2 = fleet.sample_population(fleet.DEFAULT_POPULATION, 64, key=42)
    p3 = fleet.sample_population(fleet.DEFAULT_POPULATION, 64, key=43)
    for k in FIELDS:
        assert np.array_equal(getattr(p1, k), getattr(p2, k)), k
    assert all(not np.array_equal(getattr(p1, k), getattr(p3, k))
               for k in FIELDS)
    assert p1.archetype.dtype == np.int32
    # a prefix of a larger draw is not promised, but the same key is
    # the same fleet whatever else ran before
    torch.manual_seed(123)
    p4 = fleet.sample_population(fleet.DEFAULT_POPULATION, 64, key=42)
    assert np.array_equal(p4.fade, p1.fade)


def test_sampling_ranges_and_distribution():
    spec = fleet.DEFAULT_POPULATION
    n = 20000
    pop = fleet.sample_population(spec, n, key=1)
    assert len(pop) == n
    assert set(np.unique(pop.tz_hours)) <= set(spec.tz_hours)
    freq = np.bincount(pop.archetype, minlength=spec.n_archetypes) / n
    np.testing.assert_allclose(freq, spec.weights(), atol=0.015)
    tz = np.asarray([np.mean(pop.tz_hours == h) for h in spec.tz_hours])
    np.testing.assert_allclose(tz, spec.tz_probs(), atol=0.015)
    for i, a in enumerate(spec.archetypes):
        m = pop.archetype == i
        for vals, (lo, hi) in ((pop.fade[m], a.fade),
                               (pop.ambient_offset_c[m],
                                a.ambient_offset_c)):
            assert vals.min() >= lo and vals.max() <= hi
            if hi > lo:         # uniform on [lo, hi]
                u = (vals - lo) / (hi - lo)
                assert abs(u.mean() - 0.5) < 0.03
                assert abs(u.var() - 1.0 / 12.0) < 0.01
    assert sum(pop.counts().values()) == n
    sub = pop.take(np.asarray([1, 3]))
    assert sub.archetype[0] == pop.archetype[1]
    assert sub.fade[1] == pop.fade[3]


def test_sampling_rejects_bad_arguments():
    with pytest.raises(ValueError, match="n must be > 0"):
        fleet.sample_population(fleet.DEFAULT_POPULATION, 0, key=0)
    with pytest.raises(TypeError, match="int seed"):
        fleet.sample_population(fleet.DEFAULT_POPULATION, 4, key=1.5)


# ---------------------------------------------------------------------------
# the day scan's initial SoC (full-trace mode), plain versions
# ---------------------------------------------------------------------------

def _with_soc0(tables: dict, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    n = tables["step_mw"].shape[-1]
    out = dict(tables)
    out["soc0"] = 0.05 + 0.9 * torch.rand(n, generator=g)
    out["soc0_p"] = 0.05 + 0.9 * torch.rand(n, generator=g)
    out["soc0"][0] = 0.0            # a dead start
    return out


def test_soc0_first_step_by_hand():
    """Step 0 from soc0 / soc0_p, stepped by hand in float32 with the
    numpy oracle's node step: the SoC latch and alive read the initial
    SoC, and both nodes drain from it."""
    tables = _with_soc0(random_tables(9, 40, 3, seed=5, device=CPU), seed=6)
    got = ds.day_scan_plain(tables, full=True)
    c = {k: v.numpy() for k, v in tables["const"].items()}
    f = np.float32
    for i in range(9):
        ci = {k: f(v[i]) for k, v in c.items()}
        soc, soc_p = f(tables["soc0"][i]), f(tables["soc0_p"][i])
        amb = f(tables["ambient"][0, i])
        th = f(1.0) if amb > ci["temp_trip"] else f(0.0)
        soc_state = f(1.0) if min(soc, soc_p) < ci["soc_trip"] else f(0.0)
        lv = int(min(th + soc_state, ci["max_level"]))
        alive = ((f(1.0) if soc > 0 else f(0.0))
                 * (f(1.0) if soc_p > 0 else f(0.0))
                 * f(tables["valid"][0, i]))
        act = f(tables["active"][0, i]) * f(tables["act_mult"][lv, i])
        p_mw = (act * f(tables["step_mw"][0, lv, i])
                + (f(1.0) - act) * ci["standby_mw"]) * alive
        p_p = (act * f(tables["step_mw_p"][0, lv, i])
               + (f(1.0) - act) * ci["p_standby_mw"]) * alive \
            * ci["has_puck"]
        s1, _, _, _ = daysim._ref_node_step(
            soc, amb, amb, p_mw, f(tables["charge"][0, i]), amb, "", ci)
        s1p, _, _, _ = daysim._ref_node_step(
            soc_p, amb, amb, p_p, f(tables["charge_p"][0, i]), amb, "p_",
            ci)
        assert int(got["level"][i, 0]) == lv
        assert float(got["soc_state"][i, 0]) == soc_state
        assert float(got["alive"][i, 0]) == alive
        assert float(got["soc"][i, 0]) == s1
        assert float(got["soc_p"][i, 0]) == s1p
    assert float(got["alive"][0, 0]) == 0.0     # the dead start


def test_soc0_staged_equals_plain_and_ones_equal_absent():
    base = random_tables(33, 130, 3, seed=8, device=CPU)
    tables = _with_soc0(base, seed=9)
    want = ds.day_scan_plain(tables, full=True)
    got = ds.day_scan_staged_plain(tables, chunk=16, full=True)
    for k in ds.TRACE_OUTS:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(want["soc"], ds.day_scan_plain(base, True)["soc"])
    ones = dict(base, soc0=torch.ones(33), soc0_p=torch.ones(33))
    plain = ds.day_scan_plain(base, full=True)
    for k, v in ds.day_scan_plain(ones, full=True).items():
        assert torch.equal(v, plain[k]), k


def test_soc0_checks():
    tables = random_tables(4, 10, 2, seed=1, device=CPU)
    with pytest.raises(ValueError, match="full-trace mode only"):
        ds.day_scan(dict(tables, soc0=torch.ones(4)))
    with pytest.raises(ValueError, match="soc0_p"):
        ds.day_scan(dict(tables, soc0_p=torch.ones(5)), full=True)
    with pytest.raises(ValueError, match="soc0"):
        ds.day_scan(dict(tables, soc0=torch.ones(4, dtype=torch.float64)),
                    full=True)
