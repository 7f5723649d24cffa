"""Port parity: Monte Carlo fleets (`core/montecarlo.py`) and the fleet
front (`dse.fleet_pareto` / `FleetFront`) against the JAX reference on
the CPU.

The reference draws its populations with threefry, which cannot be
reproduced, so for the parity tests the port's sampler is replaced
(monkeypatch) by one that returns the reference's population of the same
draw: the reference's `draw_keys` subkey in the same position as the
port's seed.  The port's own seeds are tested for determinism and common
random numbers.  Survival draws and time-to-empty quantiles must be
equal, the curves and dollar figures within rtol 1e-6 (the fleet day's
continuous outputs: see tests/test_torch_fleet.py)."""
import json

import numpy as np
import pytest

from repro.core import dse as j_dse
from repro.core import fleet as j_fleet
from repro.core import montecarlo as j_montecarlo
from repro.core.autoscale import AutoscalerSpec as JAutoscalerSpec
from repro_torch.core import dse, fleet, montecarlo
from repro_torch.core.autoscale import AutoscalerSpec

DT = 120.0
CPU = "cpu"
N_USERS = 23
ROW_EXACT = ("variant", "survival_rate", "survival_lo", "survival_hi",
             "tte_p50_h", "shutdowns", "n_draws")


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port's sampler return the reference's populations: the
    port's draw seeds (and a plain int key) map to the reference's keys
    of the same draw."""
    jkeys: dict = {}

    def register(key, n_draws):
        for s, k in zip(montecarlo.draw_keys(key, n_draws),
                        j_montecarlo.draw_keys(key, n_draws)):
            jkeys[int(s)] = k

    def sample(spec, n, key):
        jpop = j_fleet.sample_population(
            j_fleet.DEFAULT_POPULATION, n, jkeys.get(int(key), int(key)))
        return fleet.Population(spec, *(np.asarray(getattr(jpop, f))
                                         for f in ("archetype", "tz_hours",
                                                   "ambient_offset_c",
                                                   "fade")))

    monkeypatch.setattr(fleet, "sample_population", sample)
    return register


def assert_dist_matches(got, want) -> None:
    assert got.spec_name == want.spec_name
    assert got.streams == tuple(want.streams)
    assert (got.n_users, got.n_draws, got.ci, got.bin_hours,
            got.fleet_size, got.tte_qs) == (
        want.n_users, want.n_draws, want.ci, want.bin_hours,
        want.fleet_size, tuple(want.tte_qs))
    assert np.array_equal(got.survival_draws, want.survival_draws)
    assert np.array_equal(got.tte_draws, want.tte_draws)
    for k in ("curve_draws", "stream_curve_draws", "usd_draws",
              "dynamic_usd_draws", "dropped_stream_h_draws"):
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * max(1.0, float(np.max(w))),
                                   err_msg=k)
    assert got.autoscaler == want.autoscaler


@pytest.fixture(scope="module")
def dist():
    return montecarlo.fleet_distribution(
        fleet.DEFAULT_POPULATION, N_USERS, n_draws=4, key=11, dt_s=DT,
        autoscaler=AutoscalerSpec(), device=CPU)


# ---------------------------------------------------------------------------
# fleet_distribution against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("autoscaled", [True, False])
def test_fleet_distribution_matches_reference(reference_draws, autoscaled):
    reference_draws(11, 3)
    kw = dict(n_draws=3, key=11, dt_s=DT, fleet_size=1e6)
    scaler = AutoscalerSpec() if autoscaled else None
    got = montecarlo.fleet_distribution(
        fleet.DEFAULT_POPULATION, N_USERS, autoscaler=scaler, device=CPU,
        **kw)
    want = j_montecarlo.fleet_distribution(
        j_fleet.DEFAULT_POPULATION, N_USERS,
        autoscaler=JAutoscalerSpec() if autoscaled else None, **kw)
    assert_dist_matches(got, want)
    assert got.summary().keys() == want.summary().keys()


def test_reuse_prep_bit_identical():
    kw = dict(n_draws=3, key=7, dt_s=DT, fleet_size=1e6, device=CPU)
    fast = montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION,
                                         N_USERS, **kw)
    slow = montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION,
                                         N_USERS, reuse_prep=False, **kw)
    for k in ("survival_draws", "tte_draws", "curve_draws",
              "stream_curve_draws", "usd_draws"):
        assert np.array_equal(getattr(fast, k), getattr(slow, k)), k
    assert fleet.FLEET_STATS["traces"] == 0


# ---------------------------------------------------------------------------
# keys: determinism and common random numbers
# ---------------------------------------------------------------------------

def test_draw_keys_deterministic_and_distinct():
    k1 = montecarlo.draw_keys(5, 4)
    assert np.array_equal(k1, montecarlo.draw_keys(5, 4))
    assert len(set(k1.tolist())) == 4
    assert not np.array_equal(k1, montecarlo.draw_keys(6, 4))
    with pytest.raises(ValueError, match="n_draws"):
        montecarlo.draw_keys(5, 0)


def test_common_random_numbers_across_variants():
    base = fleet.DEFAULT_POPULATION
    variant = base.with_overrides("v", policy="none")
    for k in montecarlo.draw_keys(3, 3):
        pa = fleet.sample_population(base, 16, k)
        pb = fleet.sample_population(variant, 16, k)
        for f in ("archetype", "tz_hours", "ambient_offset_c", "fade"):
            assert np.array_equal(getattr(pa, f), getattr(pb, f)), f


def test_distribution_deterministic_in_key():
    kw = dict(n_draws=2, dt_s=DT, device=CPU)
    d1 = montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION, N_USERS,
                                       key=9, **kw)
    d2 = montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION, N_USERS,
                                       key=9, **kw)
    d3 = montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION, N_USERS,
                                       key=10, **kw)
    assert np.array_equal(d1.curve_draws, d2.curve_draws)
    assert np.array_equal(d1.survival_draws, d2.survival_draws)
    assert not np.array_equal(d1.curve_draws, d3.curve_draws)


# ---------------------------------------------------------------------------
# FleetDistribution: shapes, bands, JSON
# ---------------------------------------------------------------------------

def test_distribution_shapes_and_bands(dist):
    assert dist.survival_draws.shape == (4,)
    assert dist.curve_draws.shape == (4, fleet.DEFAULT_N_BINS,
                                      len(dist.streams))
    sv = dist.survival_rate()
    assert sv["lo"] <= sv["mean"] <= sv["hi"]
    tq = dist.tte_quantiles()
    assert tq["p5"]["mean"] <= tq["p95"]["mean"]
    bands = dist.curve_bands()
    assert np.all(bands["lo"] <= bands["mean"] + 1e-12)
    assert np.all(bands["mean"] <= bands["hi"] + 1e-12)
    cost = dist.cost()
    assert cost["dynamic_usd"]["mean"] >= cost["autoscaled_usd"]["mean"]
    assert cost["dropped_stream_hours"]["mean"] >= 0.0
    assert np.ptp(dist.usd_draws) > 0.0


def test_distribution_json_roundtrip(dist):
    back = montecarlo.FleetDistribution.from_dict(
        json.loads(json.dumps(dist.to_dict())))
    assert back.summary() == dist.summary()
    assert np.array_equal(back.curve_draws, dist.curve_draws)
    assert np.array_equal(back.dynamic_usd_draws, dist.dynamic_usd_draws)
    # the reference reads the port's JSON and prints the same summary
    ref = j_montecarlo.FleetDistribution.from_dict(dist.to_dict())
    assert ref.summary() == dist.summary()


def test_distribution_validates_ci():
    with pytest.raises(ValueError, match="ci"):
        montecarlo.fleet_distribution(fleet.DEFAULT_POPULATION, 4,
                                      n_draws=1, ci=1.0, dt_s=DT,
                                      device=CPU)


# ---------------------------------------------------------------------------
# fleet_pareto against the reference
# ---------------------------------------------------------------------------

def assert_front_matches(got, want) -> None:
    assert np.array_equal(got.front_mask, want.front_mask)
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in ROW_EXACT:
                assert g[k] == v, (w["variant"], k)
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-6, atol=1e-9,
                                           err_msg=f"{w['variant']}/{k}")
    assert [r["variant"] for r in got.front_rows()] \
        == [r["variant"] for r in want.front_rows()]


@pytest.mark.parametrize("autoscaled", [False, True])
def test_fleet_pareto_default_variants_match_reference(reference_draws,
                                                       autoscaled):
    """The 9 default (policy x design) variants on one population."""
    kw = dict(n_users=16, key=0, dt_s=DT, fleet_size=1e6)
    got = dse.fleet_pareto(
        autoscaler=AutoscalerSpec() if autoscaled else None, device=CPU,
        **kw)
    want = j_dse.fleet_pareto(
        autoscaler=JAutoscalerSpec() if autoscaled else None, **kw)
    assert len(got.rows) == 9
    assert got.front_mask.any()
    assert_front_matches(got, want)


def test_fleet_pareto_monte_carlo_matches_reference(reference_draws):
    reference_draws(0, 3)
    names = (("saver", "battery_saver"), ("none", "none"))
    variants = [(n, fleet.DEFAULT_POPULATION.with_overrides(n, policy=p))
                for n, p in names]
    jvariants = [(n, j_fleet.DEFAULT_POPULATION.with_overrides(n,
                                                               policy=p))
                 for n, p in names]
    kw = dict(n_users=16, key=0, dt_s=DT, fleet_size=1e6, n_draws=3)
    got = dse.fleet_pareto(variants=variants, autoscaler=AutoscalerSpec(),
                           device=CPU, **kw)
    want = j_dse.fleet_pareto(variants=jvariants,
                              autoscaler=JAutoscalerSpec(), **kw)
    assert_front_matches(got, want)
    for r in got.rows:
        assert r["survival_lo"] <= r["survival_rate"] <= r["survival_hi"]
        assert r["usd_lo"] <= r["usd_per_day"] <= r["usd_hi"]
        assert r["dropped_stream_hours"] \
            <= r["dropped_stream_hours_hi"] + 1e-9
