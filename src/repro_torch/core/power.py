"""State-based component power models + differentiable aggregation (PnPSim).

Each device/component has a state-based model (idle/active x duty cycle),
optional throughput term (mW per Mbps moved), and a power-delivery rail with
an efficiency factor — §III-A: "every component effectively incurs additional
power and energy overhead due to power delivery".

The aggregation layer works on packed float32 component arrays and
returns per-component and total power for one `SystemModel` snapshot
(the batched DSE sweeps go through `scenarios.py` instead).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

CATEGORIES = ("sensor", "compute", "memory", "wireless", "power",
              "output", "misc")
PROCESSES = ("digital", "analog", "mixed", "rf")


@dataclass(frozen=True)
class Component:
    name: str
    category: str                  # one of CATEGORIES
    process: str                   # one of PROCESSES (tech-scaling class)
    idle_mw: float = 0.0
    active_mw: float = 0.0         # power at duty=1 (on top of idle)
    duty: float = 0.0              # duty cycle (from taskgraph sim or const)
    mw_per_mbps: float = 0.0       # throughput-proportional term
    mbps: float = 0.0              # attributed data rate
    rail: str = "sys"              # power-delivery rail
    digital_fraction: float = 1.0  # for tech-scaling decomposition

    @property
    def load_mw(self) -> float:
        return self.idle_mw + self.active_mw * self.duty + \
            self.mw_per_mbps * self.mbps


@dataclass
class Rail:
    name: str
    efficiency: float = 0.80


@dataclass
class SystemModel:
    components: list[Component]
    rails: dict[str, Rail]

    def with_duties(self, duties: dict[str, float]) -> "SystemModel":
        comps = [replace(c, duty=duties.get(c.name, c.duty))
                 for c in self.components]
        return SystemModel(comps, self.rails)

    # -- numpy packed views -------------------------------------------
    def pack(self):
        c = self.components
        rail_names = list(self.rails)
        rail_idx = np.array([rail_names.index(x.rail) for x in c])
        f32 = np.float32
        return {
            "idle": np.array([x.idle_mw for x in c], f32),
            "active": np.array([x.active_mw for x in c], f32),
            "duty": np.array([x.duty for x in c], f32),
            "mw_per_mbps": np.array([x.mw_per_mbps for x in c], f32),
            "mbps": np.array([x.mbps for x in c], f32),
            "rail_idx": np.array(rail_idx, np.int32),
            "rail_eff": np.array([self.rails[r].efficiency
                                  for r in rail_names], f32),
        }

    def component_loads(self) -> np.ndarray:
        return np.array([c.load_mw for c in self.components])

    def evaluate(self) -> "PowerReport":
        packed = self.pack()
        loads, pd_loss, total = aggregate(packed)
        return PowerReport(self, np.asarray(loads), float(pd_loss),
                           float(total))


def aggregate(packed: dict):
    """Bottom-up aggregation over packed float32 arrays.

    Returns (per-component delivered load mW, power-delivery loss mW,
    total system mW = sum(loads) + pd_loss).
    """
    loads = packed["idle"] + packed["active"] * packed["duty"] + \
        packed["mw_per_mbps"] * packed["mbps"]
    eff = packed["rail_eff"][packed["rail_idx"]]
    losses = loads * (np.float32(1.0) / eff - np.float32(1.0))
    return loads, np.sum(losses), np.sum(loads) + np.sum(losses)


@dataclass
class PowerReport:
    model: SystemModel
    loads_mw: np.ndarray
    pd_loss_mw: float
    total_mw: float

    def by_category(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for c, load in zip(self.model.components, self.loads_mw):
            out[c.category] = out.get(c.category, 0.0) + float(load)
        out["power"] = out.get("power", 0.0) + self.pd_loss_mw
        return out

    def per_component(self, include_pd: bool = True) -> list[tuple[str, float]]:
        """Component powers with PD losses folded into per-rail PMIC comps."""
        rows = [(c.name, float(l))
                for c, l in zip(self.model.components, self.loads_mw)]
        if include_pd:
            rail_loss: dict[str, float] = {}
            for c, l in zip(self.model.components, self.loads_mw):
                eff = self.model.rails[c.rail].efficiency
                rail_loss[c.rail] = rail_loss.get(c.rail, 0.0) + \
                    float(l) * (1 / eff - 1)
            for rail, loss in sorted(rail_loss.items()):
                rows.append((f"pmic_{rail}", loss))
        return sorted(rows, key=lambda kv: -kv[1])

    def cumulative_table(self, thresholds=(0.001, 0.005, 0.01, 0.05, 0.10,
                                           0.25)) -> list[dict]:
        rows = self.per_component()
        total = sum(p for _, p in rows)
        out = []
        for th in thresholds:
            sel = [p for _, p in rows if p <= th * total]
            out.append({"threshold": th, "count": len(sel),
                        "share": sum(sel) / total})
        return out
