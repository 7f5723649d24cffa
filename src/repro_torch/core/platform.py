"""Declarative platform description: `ComponentSpec` / `PlatformSpec`.

A *platform* is the full component inventory of a wearable device — sensors,
compute IPs, memories, radios, PMIC rails, plus the long tail of auxiliary
parts — expressed as **data**, not code.  Each component carries a
`LoadRule`: a named formula (`kind`) plus scalar parameters that map a
scenario's knob vector and the physical coefficient set theta to a mW load.
Because the rules are named rather than closures, a platform serializes to
plain JSON and round-trips losslessly (`to_dict` / `from_dict`), and SKU
variants (different display, no ML IPs, ...) are edits to the component
table (`variant`) rather than forks of the model module.

The batched evaluation engine lives in `scenarios.py`: it evaluates a
platform over a whole `ScenarioSet` as one batch of torch tensor ops.
`aria2.py` defines the paper's 145-component Aria2 inventory as the
baseline `PlatformSpec` plus four variants, and registers all five here.

Registry:
    register(spec)      — add / replace a platform by name
    get(name)           — look a platform up
    names()             — registered platform names
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace as _dc_replace
from typing import Iterable

# canonical egocentric primitives (paper Table I) and the knob order used by
# every placement mask in the batch API
PRIMITIVES = ("vio", "eye_tracking", "asr", "hand_tracking")

# load-rule kinds understood by the evaluation engine (scenarios.LOAD_KINDS
# implements them); kept here so specs validate without importing torch
LOAD_KIND_NAMES = (
    "const",        # {mw}: fixed load
    "sensor_fps",   # {mw}: mw * (0.35 + 0.65 / fps_scale) static-floor model
    "isp",          # {active_mw, floor_mw}: duty-cycled image pipe
    "codec",        # {floor_mw}: theta codec energy x raw pixel rate
    "dsp_audio",    # {base_mw, idle_mw}: ASR on DSP, OPUS otherwise
    "npu",          # {off_mw}: hand/eye nets on the ML accelerator
    "hwa_vio",      # {off_mw}: 6DoF localization hardware IP
    "dram",         # {base_mw}: base + theta dram energy x visual traffic
    "wifi",         # {}: link maintenance + energy/bit x gated uplink
    "display",      # {base_mw, max_mw}: base + brightness x max
)


# load kind -> primitives whose on-device placement needs that IP; a
# platform variant that drops the IP can no longer run them on-device
KIND_SUPPORTS = {
    "npu": ("hand_tracking", "eye_tracking"),
    "hwa_vio": ("vio",),
    "dsp_audio": ("asr",),
}


def _kv(d: dict) -> tuple:
    """Dict -> sorted, hashable (key, value) tuple for frozen dataclasses."""
    return tuple(sorted(d.items()))


@dataclass(frozen=True)
class LoadRule:
    """Named load formula + scalar parameters (serializable, hashable)."""
    kind: str
    params: tuple = ()          # sorted (name, float) pairs

    def __post_init__(self):
        if self.kind not in LOAD_KIND_NAMES:
            raise ValueError(f"unknown load kind {self.kind!r}; "
                             f"one of {LOAD_KIND_NAMES}")
        if isinstance(self.params, dict):
            object.__setattr__(self, "params", _kv(self.params))

    def p(self) -> dict:
        return dict(self.params)


@dataclass(frozen=True)
class ComponentSpec:
    """One inventory entry: identity, power-delivery context, load rule."""
    name: str
    category: str               # power.CATEGORIES
    process: str                # power.PROCESSES (tech-scaling class)
    rail: str                   # power-delivery rail name
    digital_fraction: float
    load: LoadRule
    group: str = "mech"         # "mech" (scenario-coupled) | "tail"


@dataclass(frozen=True)
class PlatformSpec:
    """A complete device platform as declarative data.

    All numeric context the batched engine needs is carried here:
      rails     — (name, efficiency) pairs; theta's eff_scale multiplies them
      theta     — default physical coefficients (calibration overrides merge
                  on top at evaluation time)
      raw_mbps  — sensor raw data rates feeding the uplink/codec formulas
      ip_rates  — sustained GFLOP/s per accelerator per enabled primitive
      duty_tables — placement-indexed duty tables from the event-driven
                  taskgraph sim: ((resource, (duty per placement-mask
                  index, ...)), ...) with 2^len(primitives) entries per
                  resource.  "isp" drives the ISP duty-cycle load rule;
                  "npu"/"dsp"/"dram_bus" feed the queue_mw_per_duty
                  contention terms so batched scenarios see queueing.
    """
    name: str
    components: tuple
    rails: tuple                # ((rail, efficiency), ...)
    theta: tuple                # ((coefficient, value), ...)
    raw_mbps: tuple             # ((stream, Mbps), ...)
    ip_rates: tuple             # ((rate key, GFLOP/s), ...)
    duty_tables: tuple          # ((resource, (duty per placement idx,)),)
    primitives: tuple = PRIMITIVES
    companion: tuple = ()       # ((param, value), ...): pocket-host node
                                # data for split SKUs (daysim.puck_for)

    # -- convenience views --------------------------------------------------
    def component_names(self) -> tuple:
        return tuple(c.name for c in self.components)

    def supported_primitives(self) -> tuple:
        """Primitives this platform can place on-device: inferred from
        which accelerator load rules survive in the component table."""
        kinds = {c.load.kind for c in self.components}
        sup = {p for kind, prims in KIND_SUPPORTS.items() if kind in kinds
               for p in prims}
        return tuple(p for p in self.primitives if p in sup)

    def mech_components(self) -> tuple:
        return tuple(c for c in self.components if c.group == "mech")

    def duty_table(self, resource: str, default: float = 0.0) -> tuple:
        """Placement-indexed duty table for one sim resource; platforms
        without a table for `resource` get a constant-`default` table."""
        for name, tab in self.duty_tables:
            if name == resource:
                return tab
        return (default,) * (1 << len(self.primitives))

    @property
    def isp_duty(self) -> tuple:
        """Back-compat view of the ISP table (pre-duty_tables API)."""
        return self.duty_table("isp", 1.0)

    def companion_dict(self) -> dict:
        """Pocket-host (puck) node parameters, {} for single-node SKUs."""
        return dict(self.companion)

    def theta_dict(self) -> dict:
        return dict(self.theta)

    def rail_dict(self) -> dict:
        return dict(self.rails)

    def __len__(self) -> int:
        return len(self.components)

    # -- variants -----------------------------------------------------------
    def variant(self, name: str, drop: Iterable[str] = (),
                add: Iterable[ComponentSpec] = (),
                replace: Iterable[ComponentSpec] = (),
                theta: dict | None = None,
                raw_mbps: dict | None = None,
                ip_rates: dict | None = None,
                companion: dict | None = None) -> "PlatformSpec":
        """Derive a SKU: drop/add/replace components; override theta,
        sensor raw rates, or accelerator rates (e.g. a camera-only SKU
        zeroes the GS/ET streams it no longer captures)."""
        drop = set(drop)
        repl = {c.name: c for c in replace}
        unknown = (drop | set(repl)) - set(self.component_names())
        if unknown:
            raise KeyError(f"variant refers to unknown components {unknown}")
        comps = [repl.get(c.name, c) for c in self.components
                 if c.name not in drop]
        comps.extend(add)
        th = dict(self.theta)
        th.update(theta or {})
        raw = dict(self.raw_mbps)
        unknown = set(raw_mbps or {}) - set(raw)
        if unknown:
            raise KeyError(f"variant refers to unknown raw streams "
                           f"{unknown}")
        raw.update(raw_mbps or {})
        rates = dict(self.ip_rates)
        unknown = set(ip_rates or {}) - set(rates)
        if unknown:
            raise KeyError(f"variant refers to unknown ip rates {unknown}")
        rates.update(ip_rates or {})
        # companion: None inherits, a non-empty dict merges overrides,
        # an explicit {} CLEARS it (derive a single-node SKU from a
        # split one)
        if companion is not None and not companion:
            comp = {}
        else:
            comp = dict(self.companion)
            comp.update(companion or {})
        return _dc_replace(self, name=name, components=tuple(comps),
                           theta=_kv(th), raw_mbps=_kv(raw),
                           ip_rates=_kv(rates), companion=_kv(comp))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "primitives": list(self.primitives),
            "rails": dict(self.rails),
            "theta": dict(self.theta),
            "raw_mbps": dict(self.raw_mbps),
            "ip_rates": dict(self.ip_rates),
            "duty_tables": {name: list(tab) for name, tab in
                            self.duty_tables},
            "companion": dict(self.companion),
            "components": [
                {"name": c.name, "category": c.category,
                 "process": c.process, "rail": c.rail,
                 "digital_fraction": c.digital_fraction, "group": c.group,
                 "load": {"kind": c.load.kind, "params": c.load.p()}}
                for c in self.components],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlatformSpec":
        comps = tuple(
            ComponentSpec(c["name"], c["category"], c["process"], c["rail"],
                          float(c["digital_fraction"]),
                          LoadRule(c["load"]["kind"],
                                   _kv(c["load"]["params"])),
                          c.get("group", "mech"))
            for c in d["components"])
        if "duty_tables" in d:
            tables = tuple(sorted(
                (name, tuple(float(x) for x in tab))
                for name, tab in d["duty_tables"].items()))
        else:                       # pre-duty_tables serialized platforms
            tables = (("isp", tuple(float(x) for x in d["isp_duty"])),)
        return cls(name=d["name"], components=comps,
                   rails=_kv(d["rails"]), theta=_kv(d["theta"]),
                   raw_mbps=_kv(d["raw_mbps"]), ip_rates=_kv(d["ip_rates"]),
                   duty_tables=tables,
                   primitives=tuple(d["primitives"]),
                   companion=_kv(d.get("companion", {})))


# ---------------------------------------------------------------------------
# platform diffs (SKU ablation reports from the registry)
# ---------------------------------------------------------------------------

def _changed_fields(a: ComponentSpec, b: ComponentSpec) -> dict:
    out = {}
    for f in ("category", "process", "rail", "digital_fraction", "group"):
        va, vb = getattr(a, f), getattr(b, f)
        if va != vb:
            out[f] = (va, vb)
    if a.load != b.load:
        out["load"] = ({"kind": a.load.kind, **a.load.p()},
                       {"kind": b.load.kind, **b.load.p()})
    return out


def diff(a: PlatformSpec, b: PlatformSpec) -> dict:
    """Structural diff between two SKUs, pure data (no torch import).

    Returns component names `added`/`dropped` (relative to `a`), a
    `changed` map (name -> {field: (a_value, b_value)}), and the same
    (a, b) pair maps for theta / raw_mbps / ip_rates / rails entries
    that differ — the substrate for registry-driven ablation reports."""
    ca = {c.name: c for c in a.components}
    cb = {c.name: c for c in b.components}
    changed = {n: _changed_fields(ca[n], cb[n])
               for n in ca.keys() & cb.keys() if ca[n] != cb[n]}

    def _kvdiff(ka, kb):
        da, db = dict(ka), dict(kb)
        return {k: (da.get(k), db.get(k))
                for k in da.keys() | db.keys()
                if da.get(k) != db.get(k)}

    return {
        "a": a.name, "b": b.name,
        "added": sorted(cb.keys() - ca.keys()),
        "dropped": sorted(ca.keys() - cb.keys()),
        "changed": changed,
        "theta": _kvdiff(a.theta, b.theta),
        "raw_mbps": _kvdiff(a.raw_mbps, b.raw_mbps),
        "ip_rates": _kvdiff(a.ip_rates, b.ip_rates),
        "rails": _kvdiff(a.rails, b.rails),
        "companion": _kvdiff(a.companion, b.companion),
    }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, PlatformSpec] = {}


def register(spec: PlatformSpec) -> PlatformSpec:
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_builtins():
    from . import aria2
    aria2.platforms()       # builders register on first call (lru-cached)


def get(name: str) -> PlatformSpec:
    if name not in _REGISTRY:
        _ensure_builtins()
        if name not in _REGISTRY:
            raise KeyError(f"unknown platform {name!r}; "
                           f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)
