"""End-to-end system view on the PyTorch port: one wearable scenario ->
device power + uplink -> backend fleet sizing from the dry-run roofline.

This is the paper's full loop (Fig 1): sense -> compute/compress on-device
-> offload -> backend contextual AI, with both sides quantified by the
same framework.  Fleet capacity comes from dry-run artifacts when present
and falls back to deterministic nominal pod capacities otherwise (rows
are tagged note="missing_artifact"; pods are never silently infinite).
The port of `examples/end_to_end_system.py`; it prints the same lines.

    PYTHONPATH=src python examples/torch_end_to_end_system.py --device cpu
"""
import argparse

from repro_torch.core import aria2, offload
from repro_torch.core.aria2 import FULL_OFFLOAD, FULL_ON_DEVICE
from repro_torch.core.scenarios import ScenarioSet


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-users", type=float, default=1e6)
    ap.add_argument("--duty", type=float, default=0.35)
    args = ap.parse_args(argv)
    dev, n_users, duty = args.device, args.n_users, args.duty

    out = {"scenarios": {}}
    for sc in (FULL_OFFLOAD, FULL_ON_DEVICE):
        s = offload.offload_summary(sc, device=dev)
        print(f"\n=== {s['scenario']} ===")
        print(f"device: {s['device_mw']:.0f} mW, uplink "
              f"{s['uplink_mbps']:.1f} Mbps")
        fleet = offload.size_fleet(sc, n_users=n_users, duty=duty)
        total_pods = 0.0
        for r in fleet:
            if r.get("note") == "computed on-device":
                print(f"  {r['stream']:8s} -> {r['arch']:22s} {r['note']}")
                continue
            tag = " [fallback capacity]" if r.get("note") else ""
            print(f"  {r['stream']:8s} -> {r['arch']:22s} "
                  f"{r['tokens_per_s']/1e6:8.1f}M tok/s  needs "
                  f"{r['pods']:8.1f} pods (256 chips each){tag}")
            total_pods += r["pods"]
        print(f"  ~{total_pods:.0f} pods for 1M always-on users @35% duty")
        out["scenarios"][s["scenario"]] = {
            "device_mw": float(s["device_mw"]),
            "uplink_mbps": float(s["uplink_mbps"]),
            "pods": [(r["stream"], r["arch"], r.get("pods"))
                     for r in fleet], "total_pods": total_pods}

    print("\ndevice<->datacenter joint sweep (one batched device call):")
    sset = ScenarioSet.grid(placements=((), ("asr",), ("vio", "hand_tracking"),
                                        aria2.PRIMITIVES),
                            compressions=(10.0,), fps_scales=(1.0,))
    grid = offload.fleet_grid(sset, n_users=n_users, duty=duty, device=dev)
    for r in grid:
        print(f"  {r['scenario']:34s} {r['device_mw']:7.1f} mW device, "
              f"{r['uplink_mbps']:6.1f} Mbps up, {r['backend_pods']:8.1f} "
              f"pods")
    out["grid"] = [(r["scenario"], r["device_mw"], r["uplink_mbps"],
                    r["backend_pods"]) for r in grid]

    print("\nNote: pod capacity comes from the dry-run roofline bound of "
          "each backend cell\n(results/dryrun/*.json); §Perf-tuned "
          "shardings raise it up to 16x (EXPERIMENTS.md).")
    return out


if __name__ == "__main__":
    main()
