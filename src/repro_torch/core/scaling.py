"""Technology-scaling projection (Fig 5, §VI-A).

Each component is decomposed by process class (digital / analog / mixed /
rf) and its digital fraction.  Digital dynamic+leakage power scales with
the node roadmap; analog front-ends, PMICs and RF scale far slower — so
the analog share of system power grows over time and "components that
scale less become increasingly acute bottlenecks".

Scaling factors are public-roadmap-scale numbers (iso-performance power
per node step ~0.7-0.85x for digital; ~0.95x analog; ~0.97x RF), release
cadence ~2 years (§VI-A).  Host numpy over a `power.SystemModel`
snapshot (`aria2.build_system`).
"""
from __future__ import annotations

import numpy as np

from .power import SystemModel

# per-node-step power multipliers (iso-performance)
STEP_FACTOR = {"digital": 0.78, "mixed": 0.88, "analog": 0.95, "rf": 0.96}
NODE_NAMES = ["N (today)", "N+1 (+2y)", "N+2 (+4y)", "N+3 (+6y)",
              "N+4 (+8y)"]
PD_STEP_FACTOR = 0.99   # §VI-C: efficiency ~constant under current trends


def project(model: SystemModel, n_steps: int = 4):
    """Returns rows per node: total mW + per-process-class breakdown."""
    rep = model.evaluate()
    loads = rep.loads_mw.copy()
    procs = [c.process for c in model.components]
    digf = np.array([c.digital_fraction for c in model.components])
    pd = rep.pd_loss_mw
    rows = []
    for step in range(n_steps + 1):
        by_proc: dict[str, float] = {}
        for c, l in zip(model.components, loads):
            by_proc[c.process] = by_proc.get(c.process, 0.0) + float(l)
        rows.append({
            "node": NODE_NAMES[step] if step < len(NODE_NAMES)
            else f"N+{step}",
            "total_mw": float(loads.sum() + pd),
            "pd_mw": float(pd),
            **{f"{k}_mw": round(v, 1) for k, v in sorted(by_proc.items())},
        })
        # advance one node: digital part of each component scales fast,
        # the analog remainder scales at its class rate
        dig_part = loads * digf
        ana_part = loads - dig_part
        class_f = np.array([STEP_FACTOR[p] for p in procs])
        loads = dig_part * STEP_FACTOR["digital"] + ana_part * class_f
        pd = pd * PD_STEP_FACTOR * (loads.sum() /
                                    max(rows[-1]["total_mw"] - pd, 1e-9))
    return rows
