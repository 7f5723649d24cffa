"""Fleet capacity planning on the PyTorch port: the backend is a diurnal
resource.

`fleet.fleet_day` samples a population from the declarative
`PopulationSpec` (archetype mixture x timezone distribution x climate
offsets x capacity fade), integrates every user's day through full-trace
day-scan launches, and bins each user's per-stream pod demand into UTC
hour-of-day buckets.  Headlines, all printed below: autoscaled beats
peak-provisioned; timezone spreading flattens the peak; survival is a
distribution, not a bit; and Monte Carlo bands plus a lagging
`AutoscalerSpec` show what spin-up latency and headroom cost per day.
The port of `examples/fleet_capacity.py`; it prints the same lines.  Its
populations follow the reference's distribution, not its threefry draws.

    PYTHONPATH=src python examples/torch_fleet_capacity.py --device cpu \\
        --users 2048 --mc-users 512 --draws 4
"""
import argparse
from dataclasses import replace

import numpy as np

from repro_torch.core import fleet, montecarlo
from repro_torch.core.autoscale import AutoscalerSpec


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--users", type=int, default=100_000)
    ap.add_argument("--fleet-size", type=float, default=1_000_000.0)
    ap.add_argument("--dt-s", type=float, default=60.0)
    ap.add_argument("--mc-users", type=int, default=8_192)
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args(argv)
    dev, n_users, size, dt_s = (args.device, args.users, args.fleet_size,
                                args.dt_s)

    pop = fleet.sample_population(fleet.DEFAULT_POPULATION, n_users, key=0)
    print(f"sampled {n_users:,} users from "
          f"'{fleet.DEFAULT_POPULATION.name}': {pop.counts()}")

    rep = fleet.fleet_day(pop, dt_s=dt_s, fleet_size=size, device=dev)
    print(f"integrated {n_users:,} user-days in one sharded scan "
          f"({rep.n_shards} shard(s)); curve scaled to "
          f"{size:,.0f} users\n")

    # -- the diurnal backend load curve -------------------------------------
    tot = rep.curve_total
    peak_i = int(np.argmax(tot))
    print(f"{'UTC bin':>7s} {'pods':>9s}  " + " ".join(f"{s:>8s}"
                                                       for s in rep.streams))
    for b in range(rep.curve.shape[0]):
        bar = "#" * int(round(40 * tot[b] / tot.max()))
        mark = " <- peak" if b == peak_i else ""
        print(f"{b:5d}h  {tot[b]:9.0f}  "
              + " ".join(f"{rep.curve[b, s]:8.0f}"
                         for s in range(len(rep.streams)))
              + f"  {bar}{mark}")

    # -- headline 1: autoscaling vs peak provisioning -----------------------
    plan = rep.capacity_plan()
    print(f"\npeak {plan['peak_pods']:,.0f} pods @ bin {peak_i}h, trough "
          f"{plan['trough_pods']:,.0f} (trough/peak "
          f"{plan['trough_peak_ratio']:.2f})")
    print(f"peak-provisioned: ${plan['peak_provisioned']['usd']:,.0f}/day  "
          f"{plan['peak_provisioned']['kgco2']:,.0f} kgCO2/day")
    print(f"autoscaled:       ${plan['autoscaled']['usd']:,.0f}/day  "
          f"{plan['autoscaled']['kgco2']:,.0f} kgCO2/day")
    print(f"=> autoscaling saves ${plan['savings_usd']:,.0f}/day "
          f"({plan['savings_pct']:.1f}%)")
    assert plan["autoscaled"]["usd"] < plan["peak_provisioned"]["usd"]

    # -- headline 2: timezone spreading flattens the peak -------------------
    single = replace(fleet.DEFAULT_POPULATION, name="single_tz",
                     tz_hours=(0.0,), tz_weights=None)
    rep1 = fleet.fleet_day(single, n_users, key=0, dt_s=dt_s,
                           fleet_size=size, device=dev)
    cut = 100.0 * (1.0 - tot.max() / rep1.curve_total.max())
    print(f"\nsame fleet, ONE timezone: peak "
          f"{rep1.curve_total.max():,.0f} pods; world spread: "
          f"{tot.max():,.0f} (-{cut:.1f}%)")
    assert tot.max() < rep1.curve_total.max()

    # -- headline 3: fleet survival is a distribution -----------------------
    print(f"\nsurvival rate {rep.survival_rate():.1%}  "
          f"(tte quantiles, h: {rep.tte_quantiles()})")
    print(f"{'archetype':18s} {'users':>7s} {'survival':>9s} {'shut':>5s} "
          f"{'tte p5':>7s} {'tte p50':>8s} {'fade':>6s}")
    by_arch = rep.by_archetype()
    for r in by_arch:
        print(f"{r['archetype']:18s} {r['users']:7d} "
              f"{r['survival_rate']:9.1%} {r['shutdowns']:5d} "
              f"{r['tte_p5_h']:7.2f} {r['tte_p50_h']:8.2f} "
              f"{r['mean_fade']:6.3f}")

    # -- headline 4: Monte Carlo bands + the price of a real autoscaler -----
    n_mc, n_draws = args.mc_users, args.draws
    dist = montecarlo.fleet_distribution(
        fleet.DEFAULT_POPULATION, n_mc, n_draws=n_draws, key=0,
        dt_s=dt_s, fleet_size=size, autoscaler=AutoscalerSpec(), device=dev)
    sv = dist.survival_rate()
    cost = dist.cost()
    print(f"\nMonte Carlo: {n_draws} draws x {n_mc:,} users "
          f"(one warm compile, zero retraces)")
    print(f"survival {sv['mean']:.1%}  90% CI "
          f"[{sv['lo']:.1%}, {sv['hi']:.1%}]")
    print(f"autoscaled (instant): ${cost['autoscaled_usd']['mean']:,.0f}"
          f"/day  90% CI [${cost['autoscaled_usd']['lo']:,.0f}, "
          f"${cost['autoscaled_usd']['hi']:,.0f}]")
    gap = cost["dynamic_usd"]["mean"] - cost["autoscaled_usd"]["mean"]
    print(f"dynamic (default autoscaler, {AutoscalerSpec().spinup_h:g} h "
          f"spin-up): ${cost['dynamic_usd']['mean']:,.0f}/day")
    print(f"=> controller lag + headroom cost ${gap:,.0f}/day and drop "
          f"{cost['dropped_stream_hours']['mean']:,.0f} stream-hours on "
          f"the morning ramp")
    assert cost["dynamic_usd"]["mean"] > cost["autoscaled_usd"]["mean"]
    assert cost["dropped_stream_hours"]["mean"] > 0.0

    # -- the scan is the oracle, just faster --------------------------------
    sub = pop.take(np.arange(4))
    ref = fleet.reference_fleet(sub, dt_s=dt_s, device=dev)
    got = fleet.fleet_day(sub, dt_s=dt_s, device=dev)
    assert np.array_equal(got.survives(), ref.survives())
    assert np.allclose(got.curve, ref.curve, rtol=1e-6, atol=1e-9)
    print("\nparity: sharded scan == per-user reference_integrate loop "
          "(survival bit-identical, curve to 1e-6) on a 4-user sample")
    return {"population": pop, "report": rep, "plan": plan,
            "single_tz": rep1, "by_archetype": by_arch,
            "distribution": dist, "survival": sv, "cost": cost,
            "parity": (got, ref)}


if __name__ == "__main__":
    main()
