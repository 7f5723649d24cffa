"""Interactive what-if queries against the PyTorch port's fused
day-Pareto pipeline.

One DesignTwin warms the default grid's pipeline, then every value-level
question ("what if the thermal governor trips 2°C later?", "what if the
cell is 20% smaller?") reuses it and answers in milliseconds.  The port
of `examples/what_if.py`; it prints the same lines.  The port has no
compile cache, so its `traces` and `exec_hits` read 0 by design.

    PYTHONPATH=src python examples/torch_what_if.py --device cpu
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.core import daysim
from repro_torch.serving.twin import DesignTwin


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dt-s", type=float, default=60.0)
    args = ap.parse_args(argv)

    twin = DesignTwin(dt_s=args.dt_s, device=args.device)   # warms the grid
    rep = twin.query()                      # warm repeat of the base grid
    print(f"base grid: {len(rep)} combos, front size "
          f"{int(rep.front_mask.sum())}, warm query "
          f"{twin.stats.last_ms:.1f} ms")
    print(f"{'platform':24s} {'design':16s} {'tte_h':>6s} {'peak_c':>7s} "
          f"{'pod_h':>8s}")
    for i in rep.front_indices():
        cb = rep.combos[i]
        print(f"{cb['platform']:24s} {cb['design']:16s} "
              f"{rep.time_to_empty_h[i]:6.1f} {rep.peak_skin_c[i]:7.2f} "
              f"{rep.pod_hours[i]:8.1f}")
    out = {"base": rep, "governor": {}, "battery": {}}

    # value-level what-ifs: same grid shape, new numbers
    gov = daysim.get_policy("thermal_governor")
    for trip in (38.0, 40.0, 42.0):
        pol = dataclasses.replace(gov, name=f"gov@{trip:.0f}",
                                  temp_trip_c=trip, temp_clear_c=trip - 2.5)
        r = twin.what_if(policy=pol)
        out["governor"][trip] = r
        surv = int(r.survives().sum())
        print(f"trip at {trip:4.1f}°C: {surv:2d}/{len(r)} survive, "
              f"median throttled {np.median(r.throttled_h):5.2f} h, "
              f"{twin.stats.last_ms:6.1f} ms")

    # queued what-ifs, micro-batched per shape-signature group and fanned
    # back out in submission order
    cell = daysim.BATTERIES["default"]
    for frac in (0.8, 1.0, 1.2):
        twin.submit(policy=gov, battery=dataclasses.replace(
            cell, name=f"pack_x{frac:.1f}",
            capacity_mwh=cell.capacity_mwh * frac))
    for wi in twin.run():
        r = wi.report
        out["battery"][wi.overrides["battery"].name] = r
        print(f"{wi.overrides['battery'].name:9s}: "
              f"{int(r.survives().sum()):2d}/{len(r)} survive, "
              f"front {int(r.front_mask.sum())}, {wi.ms:6.1f} ms")

    st = twin.stats
    print(f"\n{st.queries} queries in {st.batches} batched executions: "
          f"{st.traces} traces, {st.exec_hits} warm executable hits, "
          f"mean {st.mean_ms:.0f} ms")
    out["stats"] = {k: getattr(st, k)
                    for k in ("queries", "batches", "traces", "exec_hits")}

    # every daysim cache tier in one snapshot
    tiers = daysim.cache_stats()
    for tier, s in tiers.items():
        extras = "".join(f", {k}={s[k]}" for k in ("evictions", "traces")
                         if k in s)
        print(f"cache[{tier}]: {s['hits']} hits / {s['misses']} misses, "
              f"{s['size']} live{extras}")
    out["cache"] = tiers
    return out


if __name__ == "__main__":
    main()
