"""Quickstart on the PyTorch port: the paper's full-system power model.

Builds the calibrated Aria2 model, reproduces the paper's headline numbers
(Fig 3/4, Table III), and runs a placement DSE, then shows the
beyond-paper differentiable sensitivity analysis.  The port of
`examples/quickstart.py`; it prints the same lines in the same order.

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py        # on the card
"""
import argparse

from repro_torch.core import aria2, dse
from repro_torch.core.aria2 import (FULL_OFFLOAD, FULL_ON_DEVICE, PRIMITIVES,
                                    Scenario)


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # 1. scenario totals (the compute <-> communication trade-off, SSV)
    p0 = float(aria2.total_mw(FULL_OFFLOAD, device=dev))
    p1 = float(aria2.total_mw(FULL_ON_DEVICE, device=dev))
    print(f"full offload     : {p0:7.1f} mW")
    print(f"full on-device   : {p1:7.1f} mW   ({100*(p1-p0)/p0:+.1f}% vs "
          f"paper -16%)")
    print(f"always-on target : {200.0:7.1f} mW   (3 Wh / 15 h, SSIII-B)\n")

    # 2. per-primitive placement deltas (Fig 4)
    deltas = {}
    for prim in PRIMITIVES:
        p = float(aria2.total_mw(Scenario("s", (prim,)), device=dev))
        deltas[prim] = 100 * (p - p0) / p0
        print(f"  {prim:15s} on-device: {deltas[prim]:+6.2f}%")

    # 3. component power distribution (Table III / Amdahl's law for power)
    rep = aria2.build_system(FULL_ON_DEVICE, device=dev).evaluate()
    rev = {p: part for part, parts in aria2.PART_AGGREGATION.items()
           for p in parts}
    agg = {}
    for n, p in rep.per_component():
        agg[rev.get(n, n)] = agg.get(rev.get(n, n), 0.0) + p
    rows = sorted(agg.values(), reverse=True)
    top2 = sum(rows[:2]) / sum(rows)
    print(f"\ntop-2 components = {100*top2:.1f}% of power "
          f"=> max {1/(1-top2):.2f}x system gain from optimizing them alone")

    # 4. compression sweep (Fig 6): first/last points
    sweep = dse.compression_sweep(compressions=(1, 8, 64), fps_scales=(1,),
                                  device=dev)
    for r in sweep:
        print(f"  compression {r['compression']:3d}:1 -> {r['total_mw']:6.0f}"
              f" mW ({r['offload_mbps']:6.1f} Mbps)")

    # 5. beyond-paper: which physical coefficient buys the most power?
    print("\ngradient sensitivity (d total / d theta, elasticity):")
    sens = dse.sensitivity(device=dev)[:4]
    for row in sens:
        print(f"  {row['theta']:22s} {row['elasticity']:+.3f}")
    return {"full_offload_mw": p0, "full_on_device_mw": p1,
            "delta_pct": deltas, "top2_share": top2,
            "sweep": [(r["compression"], r["total_mw"], r["offload_mbps"])
                      for r in sweep],
            "sensitivity": [(r["theta"], r["elasticity"]) for r in sens]}


if __name__ == "__main__":
    main()
