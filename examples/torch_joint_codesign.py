"""Joint device+backend co-design on the PyTorch port (the paper's Amdahl
lesson end to end).

Sweeps placement x compression x fps x WiFi MCS (2304 design points)
through ONE batched device call, maps every point's offloaded streams to
backend pod counts sized from the dry-run roofline artifacts, and prints
the 3-objective Pareto front (device mW, uplink Mbps, backend pods) plus
budget-constrained optima: the cheapest wearable is NOT the cheapest
system once the datacenter bill is on the table.  The port of
`examples/joint_codesign.py`; it prints the same lines.

    PYTHONPATH=src python examples/torch_joint_codesign.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import dse


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--front-rows", type=int, default=12)
    args = ap.parse_args(argv)

    rep = dse.joint_pareto(device=args.device)   # one batched call + pods
    print(f"{len(rep)} joint design points "
          f"(backend capacities: {rep.sources})")

    front = rep.front_rows()
    print(f"\n3-objective Pareto front ({len(front)} non-dominated points, "
          f"first {args.front_rows} by device power):")
    print(f"{'on-device':28s} {'comp':>5s} {'fps':>4s} {'mcs':>14s} "
          f"{'mW':>7s} {'Mbps':>7s} {'pods':>8s}")
    for r in front[:args.front_rows]:
        print(f"{r['on_device']:28s} {r['compression']:5.0f} "
              f"{r['fps_scale']:4.0f} {r['mcs']:>14s} {r['device_mw']:7.1f} "
              f"{r['uplink_mbps']:7.2f} {r['backend_pods']:8.1f}")

    co = dse.co_optimize(rep)
    opt = co["device_optimum"]
    print(f"\ndevice-only optimum: {opt['on_device']} @ "
          f"{opt['compression']:.0f}:1/{opt['fps_scale']:.0f}x/{opt['mcs']} "
          f"-> {opt['device_mw']:.1f} mW, {opt['backend_pods']:.1f} pods")

    print("\nmin device power under a backend pod budget:")
    budgets = np.linspace(float(rep.backend_pods.min()),
                          opt["backend_pods"] * 1.5, 6)
    under_pods = []
    for b in budgets:
        r = dse.co_optimize(rep, pod_budget=float(b))[
            "min_power_under_pod_budget"]
        under_pods.append(None if r is None else r["index"])
        if r is None:
            print(f"  <= {b:8.1f} pods: infeasible")
            continue
        flag = "  <- differs from device optimum" \
            if r["index"] != opt["index"] else ""
        print(f"  <= {b:8.1f} pods: {r['on_device']:20s} "
              f"{r['device_mw']:7.1f} mW  {r['backend_pods']:8.1f} "
              f"pods{flag}")

    print("\nmin backend pods under a device power budget:")
    under_power = []
    for p in (float(opt["device_mw"]) + 1.0, 800.0, 1000.0, 1300.0):
        r = dse.co_optimize(rep, power_budget_mw=p)[
            "min_pods_under_power_budget"]
        under_power.append(None if r is None else r["index"])
        if r is None:
            print(f"  <= {p:7.1f} mW: infeasible")
            continue
        print(f"  <= {p:7.1f} mW: {r['on_device']:20s} "
              f"{r['device_mw']:7.1f} mW  {r['backend_pods']:8.1f} pods")
    return {"n_points": len(rep), "front_size": len(front),
            "front_mask": np.asarray(rep.front_mask),
            "device_mw": np.asarray(rep.device_mw),
            "backend_pods": np.asarray(rep.backend_pods),
            "device_optimum": opt["index"], "pod_budgets": budgets,
            "under_pod_budget": under_pods,
            "under_power_budget": under_power}


if __name__ == "__main__":
    main()
