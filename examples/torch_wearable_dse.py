"""Design-space exploration (SSV-B) on the PyTorch port's batched
scenario engine: evaluate the full placement x compression grid in ONE
batched device call, print the Pareto front of (system power, offloaded
context bandwidth), compare platform SKUs, and project technology
scaling.  The port of `examples/wearable_dse.py`; it prints the same
lines.

    PYTHONPATH=src python examples/torch_wearable_dse.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import aria2, dse, scaling, scenarios
from repro_torch.core.scenarios import ScenarioSet


def _host(x) -> np.ndarray:
    """A device tensor's values on the host as numpy."""
    return np.asarray(x.cpu())


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    pts, front = dse.pareto(compressions=(4, 10, 20, 40), device=dev)
    print(f"{len(pts)} design points; Pareto front (power vs context "
          f"bandwidth):")
    print(f"{'on-device':42s} {'comp':>5s} {'mW':>7s} {'Mbps':>7s}")
    for p in front:
        print(f"{p['on_device']:42s} {p['compression']:5d} "
              f"{p['total_mw']:7.1f} {p['offload_mbps']:7.2f}")

    print("\nplacement sweep (all 16 subsets, one batched call):")
    placements = dse.placement_sweep(device=dev)
    for r in placements:
        print(f"  {r['on_device']:42s} {r['total_mw']:7.1f} mW "
              f"({r['delta_pct']:+6.2f}%)  {r['offload_mbps']:6.1f} Mbps")

    print("\nfull grid through one jitted vmap call:")
    rep = dse.grid_sweep(device=dev)            # 16 x 8 x 6 = 768 points
    totals = _host(rep.total_mw)
    best = int(np.argmin(totals))
    print(f"  {len(totals)} points; min {totals.min():.0f} mW "
          f"({rep.sset.label(best)} @ {rep.sset.compression[best]:.0f}:1 / "
          f"{rep.sset.fps_scale[best]:.0f}x fps), max {totals.max():.0f} mW")

    print("\nplatform SKUs (same scenario slate, different PlatformSpec;")
    print("n/a = placement needs an accelerator the SKU dropped):")
    slate = [
        {"name": "offload", "on_device": ()},
        {"name": "on_device", "on_device": aria2.PRIMITIVES},
        {"name": "gated@0.35", "on_device": (), "upload_duty": 0.35},
        {"name": "bright@0.8", "on_device": (), "brightness": 0.8},
    ]
    skus = {}
    for plat in aria2.platforms():
        sup = set(plat.supported_primitives())
        ok = [r for r in slate if set(r["on_device"]) <= sup]
        t = _host(scenarios.total_mw(plat, ScenarioSet.build(ok),
                                     device=dev))
        skus[plat.name] = {r["name"]: float(v) for r, v in zip(ok, t)}
        by_name = {r["name"]: f"{v:7.1f}" for r, v in zip(ok, t)}
        cells = "  ".join(f"{r['name']}={by_name.get(r['name'], '    n/a')}"
                          for r in slate)
        print(f"  {plat.name:20s} ({len(plat):3d} comps)  {cells}")

    print("\ntechnology scaling (Fig 5):")
    nodes = scaling.project(aria2.build_system(aria2.FULL_ON_DEVICE,
                                               device=dev))
    for row in nodes:
        share = (row.get("analog_mw", 0) + row.get("rf_mw", 0)) \
            / row["total_mw"]
        print(f"  {row['node']:12s} {row['total_mw']:7.1f} mW   "
              f"analog+rf share {100*share:4.1f}%")
    return {"n_points": len(pts),
            "front": [(p["on_device"], p["compression"], p["total_mw"],
                       p["offload_mbps"]) for p in front],
            "placements": [(r["on_device"], r["total_mw"], r["offload_mbps"])
                           for r in placements],
            "grid_total_mw": totals, "grid_best": best, "skus": skus,
            "scaling": [(r["node"], r["total_mw"]) for r in nodes]}


if __name__ == "__main__":
    main()
