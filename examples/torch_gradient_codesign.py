"""Gradient-based co-design on the PyTorch port's DesignSpace pytree.

The grid engines answer "which of these 768 points is best"; the
differentiable core answers "which *direction* is best, from anywhere",
and the two agree where they overlap.  This example:

  1. builds a per-scenario sensitivity map over the full DSE grid in ONE
     reverse pass (d mW / d every knob, at every grid point),
  2. gradient-optimizes throttle-governor thresholds THROUGH the
     battery/thermal day (straight-through trip comparisons) and beats
     the best registered policy on time-to-empty at equal peak skin,
  3. prints the calibration theta posterior from the multi-restart
     ensemble.

The port of `examples/gradient_codesign.py`; it prints the same lines.

    PYTHONPATH=src python examples/torch_gradient_codesign.py --device cpu
"""
import argparse

from repro_torch.core import calibrate, daysim, dse


def main(argv=None) -> dict:
    """Run the example; returns its printed figures by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--restarts", type=int, default=4,
                    help="optimize_policy's restarts")
    ap.add_argument("--steps", type=int, default=60,
                    help="optimize_policy's Adam steps")
    ap.add_argument("--dt-s", type=float, default=60.0)
    ap.add_argument("--ensemble-restarts", type=int, default=6)
    ap.add_argument("--ensemble-steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = args.device

    print("=== 1. per-scenario sensitivity map (one vjp, whole grid) ===")
    sm = dse.sensitivity_map("aria2", device=dev)
    print(f"{len(sm['total_mw'])} design points; top placement leverage:")
    rows = dse.sensitivity_rows(sm, top=3)
    for row in rows:
        grads = ", ".join(f"{k}: {v:+.0f}"
                          for k, v in row["d_mw_d_placement"].items())
        print(f"  {row['scenario']:<28} c={row['compression']:<5g}"
              f" {row['total_mw']:7.1f} mW   d mW/d placement: {grads}")

    print("\n=== 2. gradient-tuned ThrottlePolicy through the day-scan ===")
    opt = dse.optimize_policy("aria2_display", daysim.DEFAULT_DESIGNS[0],
                              "field_day", "battery_saver",
                              n_restarts=args.restarts, steps=args.steps,
                              dt_s=args.dt_s, device=dev)
    b = opt["baseline"]
    print(f"grid policy   {b['policy']:<18} tte {b['tte_h']:.2f} h  "
          f"peak {b['peak_skin_c']:.2f} C")
    print(f"gradient-opt  trips(T={opt['policy'].temp_trip_c:.1f}C, "
          f"SoC={opt['policy'].soc_trip:.2f})    "
          f"tte {opt['tte_h']:.2f} h  peak {opt['peak_skin_c']:.2f} C  "
          f"(gain {opt['gain_h']:+.2f} h at equal-or-lower peak)")

    print("\n=== 3. calibration theta posterior (vmapped restarts) ===")
    ens = calibrate.fit_ensemble(n_restarts=args.ensemble_restarts,
                                 steps=args.ensemble_steps, device=dev)
    for k, p in ens["posterior"].items():
        print(f"  {k:<22} {p['best']:8.3f}  (ensemble {p['mean']:8.3f} "
              f"+/- {p['std']:.3f})")
    return {"sensitivity_map": sm, "sensitivity_rows": rows,
            "optimize_policy": opt, "ensemble": ens}


if __name__ == "__main__":
    main()
