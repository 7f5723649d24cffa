"""Day-in-the-life co-design on the PyTorch port: the Amdahl-over-time
headline.

Steady-state rankings lie about days.  `dse.day_pareto` integrates every
(SKU x design x schedule x throttle policy) combo through one day-scan
launch (nonlinear battery with voltage sag + I^2R, 2-node thermal RC,
hysteretic throttling) and fronts (time-to-empty, peak skin °C, backend
pod-hours).  Two dynamic effects no single mW figure can express, both
printed from the same report: the steady-state winner loses the day,
and throttling flips which design point wins the hot `field_day`.  The
port of `examples/all_day.py`; it prints the same lines.

    PYTHONPATH=src python examples/torch_all_day.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import daysim, dse


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    rep = dse.day_pareto(device=dev)        # one day-scan launch, all combos
    print(f"{len(rep)} day combos ({len(rep.front_indices())} on the "
          f"(tte, skin, pod-hours) front); skipped: "
          f"{[(s['platform'], s['design']) for s in rep.skipped]}")

    print(f"\n{'platform':14s} {'design':13s} {'schedule':9s} "
          f"{'policy':16s} {'steady mW':>9s} {'tte h':>6s} "
          f"{'skin °C':>8s} {'pod-h':>8s} {'$ /day':>10s}")
    for r in sorted(rep.rows(), key=lambda r: (r["schedule"],
                                               -r["time_to_empty_h"])):
        print(f"{r['platform']:14s} {r['design']:13s} {r['schedule']:9s} "
              f"{r['policy']:16s} {r['steady_mw']:9.1f} "
              f"{r['time_to_empty_h']:6.2f} {r['peak_skin_c']:8.2f} "
              f"{r['pod_hours']:8.0f} {r['usd']:10.0f}")

    # -- headline 1: steady-state winner vs day winner ----------------------
    i_steady = int(np.argmin(rep.steady_mw))
    sched0 = rep.combos[i_steady]["schedule"]
    same = [i for i, c in enumerate(rep.combos)
            if c["schedule"] == sched0 and c["policy"] == "none"]
    i_day = max(same, key=lambda i: rep.time_to_empty_h[i])
    a, b = rep.row(i_steady), rep.row(i_day)
    print(f"\nsteady-state winner: {a['platform']}/{a['design']} "
          f"@ {a['steady_mw']} mW -> {a['time_to_empty_h']} h on {sched0}")
    print(f"day winner:          {b['platform']}/{b['design']} "
          f"@ {b['steady_mw']} mW -> {b['time_to_empty_h']} h "
          f"(+{b['time_to_empty_h'] - a['time_to_empty_h']:.2f} h at "
          f"+{b['steady_mw'] - a['steady_mw']:.0f} mW steady)")

    # -- headline 2: throttling flips the field_day winner ------------------
    field = [i for i, c in enumerate(rep.combos)
             if (c["platform"], c["schedule"]) == ("aria2_display",
                                                   "field_day")]
    none_best = max((i for i in field if rep.combos[i]["policy"] == "none"),
                    key=lambda i: rep.time_to_empty_h[i])
    best = max(field, key=lambda i: rep.time_to_empty_h[i])
    n, w = rep.row(none_best), rep.row(best)
    print(f"\nfield_day, best unthrottled: {n['design']}/none -> "
          f"{n['time_to_empty_h']} h, peak {n['peak_skin_c']} °C")
    print(f"field_day, best overall:     {w['design']}/{w['policy']} -> "
          f"{w['time_to_empty_h']} h, peak {w['peak_skin_c']} °C, "
          f"{w['throttled_h']} h throttled")

    # -- what would all-day actually take? ----------------------------------
    print("\nall-day check (survives the schedule + skin <= 43 °C):")
    surv = rep.survives()
    print(f"  {int(surv.sum())}/{len(rep)} combos survive at shipped "
          f"battery capacities")
    tr = daysim.simulate("rayban_cam", daysim.DEFAULT_DESIGNS[0], "desk_day",
                         "battery_saver", device=dev)
    cap = daysim.battery_for("rayban_cam").capacity_mwh
    need = cap * tr.summary["day_hours"] / tr.summary["time_to_empty_h"]
    print(f"  rayban_cam desk_day/battery_saver: "
          f"{tr.summary['time_to_empty_h']:.1f} h "
          f"of {tr.summary['day_hours']:.0f} h -> needs ~{need:.0f} mWh "
          f"(vs {cap:.0f}) or an equivalent power cut")
    return {"report": rep, "steady_winner": i_steady, "day_winner": i_day,
            "field_none_best": none_best, "field_best": best,
            "survivors": int(surv.sum()), "simulate": tr.summary,
            "need_mwh": need}


if __name__ == "__main__":
    main()
