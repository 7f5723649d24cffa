"""Write the golden day-Pareto answers the port is held to on the card.

Runs the JAX reference twin (`repro.serving.twin.DesignTwin`, fused
pipeline, XLA scan) on the CPU over the default grid at dt_s = 10 s —
the grid `chip_smoke.py` serves — plus three what-ifs, and writes
`src/repro_torch/data/golden_day_pareto.json`: for each query its
overrides (as plain data), combo labels, `front_mask`, `survives()`,
`shutdown` and the three objectives.  `chip_smoke.py` and
`tests/test_torch_day_pareto.py` read the file as data.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden.py
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "data" / "golden_day_pareto.json")
DT_S = 10.0

# what-ifs as plain data: a policy's thresholds, another battery for
# every platform, a single platform
WHAT_IFS = {
    "base": {},
    "policy_thresholds": {"policy": {
        "base": "thermal_governor", "name": "hot_governor",
        "temp_trip_c": 41.0, "temp_clear_c": 38.0}},
    "battery": {"battery": {
        "name": "xl_pack_6wh", "capacity_mwh": 6000.0,
        "r_internal_ohm": 0.2, "v_full": 4.35, "sag_v": 0.75,
        "knee_v": 0.3, "knee_sharpness": 12.0}},
    "platform": {"platform": "aria2_puck_split"},
}


def overrides(spec: dict, daysim) -> dict:
    """`what_if` kwargs from a WHAT_IFS entry, built with `daysim` (the
    reference's or the port's: both expose the same spec classes)."""
    out = dict(spec)
    if "policy" in out:
        p = dict(out["policy"])
        base = daysim.get_policy(p.pop("base"))
        out["policy"] = dataclasses.replace(base, **p)
    if "battery" in out:
        out["battery"] = daysim.BatterySpec.from_dict(out["battery"])
    return out


def report_dict(rep) -> dict:
    return {"combos": rep.combos,
            "front_mask": [bool(x) for x in rep.front_mask],
            "survives": [bool(x) for x in rep.survives()],
            "shutdown": [bool(x) for x in rep.shutdown],
            "time_to_empty_h": [float(x) for x in rep.time_to_empty_h],
            "peak_skin_c": [float(x) for x in rep.peak_skin_c],
            "pod_hours": [float(x) for x in rep.pod_hours]}


def main() -> None:
    from repro.core import daysim
    from repro.serving.twin import DesignTwin
    twin = DesignTwin(dt_s=DT_S, warm=False)
    queries = {}
    for name, spec in WHAT_IFS.items():
        rep = twin.what_if(**overrides(spec, daysim))
        queries[name] = {"overrides": spec, **report_dict(rep)}
        print(f"{name}: {len(rep)} combos, front {int(rep.front_mask.sum())}"
              f", survive {int(rep.survives().sum())}")
    GOLDEN.write_text(json.dumps(
        {"dt_s": DT_S,
         "source": "repro.serving.twin.DesignTwin (JAX, XLA scan, CPU) "
                   "written by tests/torch_golden.py",
         "queries": queries}, indent=1) + "\n")
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    main()
