"""Day-in-the-life energy simulator on torch tensors.

A `DaySchedule` composes scenario rows into a timed day (each segment
binds knob overrides, a capture duty and an ambient temperature), and
the day scan integrates a nonlinear battery state-of-charge model (a
Li-ion voltage curve with a low-SoC knee, I^2R internal loss) and a
2-node thermal RC model for every (platform, design, schedule, policy)
combo.  `ThrottlePolicy` closes the loop from state back into power:
when skin temperature or SoC crosses a trip threshold (with hysteresis)
the policy downshifts fps / brightness / upload duty / capture duty and
can force full offload.

The serving path is the fused pipeline of `day_grid` and
`day_grid_batch`:

  1. one row stage per platform (`scenarios.batched_fn` +
     `offload.pods_streams_device`) turns the combos' (level, segment)
     knob rows into glasses mW, puck mW and backend pods;
  2. an index gather builds the (T, L, N) per-step level tables;
  3. `kernels.day_scan.day_scan` integrates the day (the CUDA kernel on
     the card, its plain torch version on the CPU);
  4. `_summarize_torch` reduces the (N, T) traces to objectives;
  5. `dse.non_dominated_torch` marks each query's Pareto front.

A batch of K queries of one bucketed shape signature is one pass of
that pipeline: the queries' tables lie side by side along the combo
axis, and the day scan launches once at N = K x N_b.  A single query is
the batch of one.  Every step computes a lane the same way whatever the
batch width (the step sums run in one fixed pairwise order,
`_step_sums`), so a query answered inside a batch equals its serial
answer bit for bit.  `day_grid_groups` takes queries of any signatures
and runs one batch per signature.

Everything between the host assembly and the summary stays on the
device.  Two host caches back repeated queries: `_ASSEMBLIES`
(value-keyed, bounded FIFO) holds the host half of a query — combos,
padded scenario rows, constants, gather indices — and `_PIPELINES`
(bounded FIFO, value + device keyed) holds that assembly's tensors
resident on the device.  PyTorch runs eagerly, so there is no compiled
executable to cache: `EXEC_STATS` is kept for callers of the
reference's counters and always reads 0.

`engine="legacy"` is the reference's oracle for the fused engine: level
tables filled through the row cache (`_ROW_CACHE`, one row-stage pass
per platform for rows not seen before), numpy step tables pushed once,
the same day-scan kernel, and the float64 host summary `_summarize`.
`simulate_users` and `compiled_tables` run on those tables, and so does
`simulate` (one combo's `DayTrace`: every per-step trace, through the
kernel's full-trace mode); `scan_integrate` runs one combo's tables
through that mode.

`reference_integrate` is the reference package's pure-numpy per-step
oracle, copied as-is.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as _device
from ..kernels import day_scan as _ds
from . import offload, scenarios
from .design import (LOGIT_HI, placement_probs, soft_indicator, ste_gt,
                     ste_lt, take_linear)
from .platform import PlatformSpec
from .scenarios import DEFAULT_MCS, ScenarioSet

DEFAULT_DT_S = 10.0             # integrator step (s)
DEFAULT_STANDBY_MW = 45.0       # deep-idle draw between capture bursts
DEFAULT_SHUTDOWN_C = 46.0       # skin temp that hard-bricks the device
STE_BETA_C = 2.0                # thermal trip surrogate sharpness (1/K)
STE_BETA_SOC = 60.0             # SoC trip surrogate sharpness (1/SoC)


# ---------------------------------------------------------------------------
# battery: capacity + voltage curve + internal-resistance loss
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BatterySpec:
    """Nonlinear cell model.

    V(soc) = v_full - sag * (1 - soc) - knee_v * exp(-knee_sharpness*soc)
    — a flat Li-ion plateau with a steep knee near empty.  Discharge
    current is I = P / V(soc), so the I^2 R internal loss grows as the
    cell sags: the same mW load drains *more* SoC per second late in the
    day, which is exactly what a steady-state power number cannot see.

    `fade` is the battery-age capacity fade fraction: an aged cell holds
    `capacity_mwh * (1 - fade)`.  It is optional and JSON back-compat
    (an absent key means no fade), so committed golden files and old
    registry dumps keep loading unchanged.
    """
    name: str
    capacity_mwh: float
    r_internal_ohm: float = 0.25
    v_full: float = 4.35
    sag_v: float = 0.75
    knee_v: float = 0.30
    knee_sharpness: float = 12.0
    fade: float = 0.0

    def __post_init__(self):
        if self.capacity_mwh <= 0:
            raise ValueError("capacity_mwh must be positive")
        if self.v_full - self.sag_v - self.knee_v <= 0:
            raise ValueError("voltage curve dips below zero at soc=0")
        if not 0.0 <= self.fade < 1.0:
            raise ValueError(f"fade={self.fade} outside [0, 1)")

    @property
    def effective_capacity_mwh(self) -> float:
        """Age-derated capacity actually available to the integrator."""
        return self.capacity_mwh * (1.0 - self.fade)

    def aged(self, fade: float) -> "BatterySpec":
        """The same cell at a given capacity-fade fraction."""
        from dataclasses import replace
        return replace(self, fade=float(fade))

    def voltage(self, soc):
        """Open-circuit-ish terminal voltage at state of charge `soc`."""
        return (self.v_full - self.sag_v * (1.0 - soc)
                - self.knee_v * np.exp(-self.knee_sharpness * soc))

    def to_dict(self) -> dict:
        out = {"name": self.name, "capacity_mwh": self.capacity_mwh,
               "r_internal_ohm": self.r_internal_ohm,
               "v_full": self.v_full, "sag_v": self.sag_v,
               "knee_v": self.knee_v,
               "knee_sharpness": self.knee_sharpness}
        if self.fade:
            out["fade"] = self.fade
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "BatterySpec":
        return cls(d["name"], float(d["capacity_mwh"]),
                   float(d["r_internal_ohm"]), float(d["v_full"]),
                   float(d["sag_v"]), float(d["knee_v"]),
                   float(d["knee_sharpness"]),
                   float(d.get("fade", 0.0)))


@dataclass(frozen=True)
class ThermalSpec:
    """2-node RC: device (SoC) node -> skin node -> ambient.

    Steady state for P watts: T_soc = amb + P*(r_soc_skin + r_skin_amb),
    T_skin = amb + P*r_skin_amb; time constants of minutes (SoC node) and
    ~quarter hour (skin), so hour-long segments reach equilibrium and
    short bursts do not."""
    name: str
    c_soc_j_per_k: float = 18.0
    c_skin_j_per_k: float = 80.0
    r_soc_skin_k_per_w: float = 7.0
    r_skin_amb_k_per_w: float = 11.0

    def to_dict(self) -> dict:
        return {"name": self.name, "c_soc_j_per_k": self.c_soc_j_per_k,
                "c_skin_j_per_k": self.c_skin_j_per_k,
                "r_soc_skin_k_per_w": self.r_soc_skin_k_per_w,
                "r_skin_amb_k_per_w": self.r_skin_amb_k_per_w}

    @classmethod
    def from_dict(cls, d: dict) -> "ThermalSpec":
        return cls(d["name"], float(d["c_soc_j_per_k"]),
                   float(d["c_skin_j_per_k"]),
                   float(d["r_soc_skin_k_per_w"]),
                   float(d["r_skin_amb_k_per_w"]))


# default packs per platform SKU (platform-name keyed, data not code):
# frame cell + temple pack class capacities
BATTERIES = {
    "default": BatterySpec("temple_pack_2p2wh", 2200.0),
    "aria2_display": BatterySpec("temple_pack_2p6wh", 2600.0),
    "rayban_cam": BatterySpec("rayban_1p25wh", 1250.0,
                              r_internal_ohm=0.38),
    "aria2_puck_split": BatterySpec("glasses_1p4wh", 1400.0,
                                    r_internal_ohm=0.30),
}

DEFAULT_THERMAL = ThermalSpec("glasses_2node")


def battery_for(platform_name: str) -> BatterySpec:
    return BATTERIES.get(platform_name, BATTERIES["default"])


@dataclass(frozen=True)
class PuckSpec:
    """Pocket-host node of a split SKU: its own battery and thermal RC,
    coupled to the glasses by the short-range link.

    The puck's load is `base_mw + wan_link_mw + wan_mw_per_mbps x
    (glasses offloaded Mbps)` while capturing — it relays everything
    the glasses stream over its own WAN radio — and `standby_mw`
    otherwise.  Built from `PlatformSpec.companion` registry data
    (`puck_for`), so split SKUs stay declarative."""
    name: str
    base_mw: float
    wan_link_mw: float
    wan_mw_per_mbps: float
    standby_mw: float
    battery: BatterySpec
    thermal: ThermalSpec

    def level_mw(self, mbps):
        """Active puck power for a (level, segment) uplink-rate table."""
        return self.base_mw + self.wan_link_mw + self.wan_mw_per_mbps * mbps


def puck_for(plat: PlatformSpec) -> PuckSpec | None:
    """PuckSpec from the platform's companion data (None = single-node)."""
    c = plat.companion_dict()
    if not c:
        return None
    name = f"{plat.name}_puck"
    return PuckSpec(
        name=name,
        base_mw=float(c["base_mw"]),
        wan_link_mw=float(c.get("wan_link_mw", 0.0)),
        wan_mw_per_mbps=float(c.get("wan_mw_per_mbps", 0.0)),
        standby_mw=float(c.get("standby_mw", 0.0)),
        battery=BatterySpec(
            f"{name}_cell", float(c["battery_mwh"]),
            r_internal_ohm=float(c.get("r_internal_ohm", 0.15))),
        thermal=ThermalSpec(
            f"{name}_thermal",
            c_soc_j_per_k=float(c.get("c_soc_j_per_k", 40.0)),
            c_skin_j_per_k=float(c.get("c_skin_j_per_k", 200.0)),
            r_soc_skin_k_per_w=float(c.get("r_soc_skin_k_per_w", 4.5)),
            r_skin_amb_k_per_w=float(c.get("r_skin_amb_k_per_w", 8.0))))


# ---------------------------------------------------------------------------
# schedules: timed segments binding scenario knob overrides
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DaySegment:
    """One contiguous slice of the day.

    `active` is the capture duty inside the segment (fraction of time the
    sensing pipeline runs vs deep standby); `upload_duty` is the
    VAD/saliency uplink gating *while* capturing; `brightness` drives
    display SKUs (inert elsewhere); `charge_mw` is dock/pocket top-up
    power flowing INTO the cell during the segment (a desk dock, a
    pocket battery case) — SoC can rise, capped at 1.  Charge flows
    regardless of load state, so any nonzero charge revives a dead
    device the next step (a trickle below the standby draw yields the
    real-world boot-loop: alternating dead/alive steps)."""
    name: str
    hours: float
    ambient_c: float = 24.0
    active: float = 1.0
    upload_duty: float = 1.0
    brightness: float = 0.0
    charge_mw: float = 0.0

    def __post_init__(self):
        if self.hours <= 0:
            raise ValueError(f"segment {self.name!r}: hours must be > 0")
        if self.charge_mw < 0:
            raise ValueError(f"segment {self.name!r}: charge_mw must "
                             f"be >= 0")
        for k in ("active", "upload_duty", "brightness"):
            v = getattr(self, k)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"segment {self.name!r}: {k}={v} "
                                 f"outside [0, 1]")

    def to_dict(self) -> dict:
        return {"name": self.name, "hours": self.hours,
                "ambient_c": self.ambient_c, "active": self.active,
                "upload_duty": self.upload_duty,
                "brightness": self.brightness,
                "charge_mw": self.charge_mw}

    @classmethod
    def from_dict(cls, d: dict) -> "DaySegment":
        return cls(d["name"], float(d["hours"]), float(d["ambient_c"]),
                   float(d["active"]), float(d["upload_duty"]),
                   float(d["brightness"]),
                   float(d.get("charge_mw", 0.0)))


@dataclass(frozen=True)
class DaySchedule:
    name: str
    segments: tuple

    def __post_init__(self):
        if not self.segments:
            raise ValueError("schedule needs at least one segment")

    @property
    def hours(self) -> float:
        return sum(s.hours for s in self.segments)

    def n_steps(self, dt_s: float) -> int:
        return sum(max(1, round(s.hours * 3600.0 / dt_s))
                   for s in self.segments)

    def with_ambient_offset(self, offset_c: float) -> "DaySchedule":
        """The same day shifted by a climate offset (every segment's
        ambient moved by `offset_c` — hot-climate or wintertime users)."""
        from dataclasses import replace
        return DaySchedule(
            f"{self.name}{offset_c:+.1f}C",
            tuple(replace(s, ambient_c=s.ambient_c + offset_c)
                  for s in self.segments))

    def to_dict(self) -> dict:
        return {"name": self.name,
                "segments": [s.to_dict() for s in self.segments]}

    @classmethod
    def from_dict(cls, d: dict) -> "DaySchedule":
        return cls(d["name"], tuple(DaySegment.from_dict(s)
                                    for s in d["segments"]))


# ---------------------------------------------------------------------------
# throttle policies: state -> knob downshift, with hysteresis
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ThrottleAction:
    """Knob downshift applied at one throttle level.

    fps_mult >= 1 multiplies the design's fps_scale (fewer frames);
    *_mult in [0, 1] scale the segment's duty/brightness/capture knobs;
    offload=True forces placement to full offload (move the heat to the
    datacenter)."""
    fps_mult: float = 1.0
    duty_mult: float = 1.0
    brightness_mult: float = 1.0
    active_mult: float = 1.0
    offload: bool = False

    def __post_init__(self):
        if self.fps_mult < 1.0:
            raise ValueError("fps_mult must be >= 1 (a downshift)")
        for k in ("duty_mult", "brightness_mult", "active_mult"):
            v = getattr(self, k)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{k}={v} outside [0, 1]")

    def to_dict(self) -> dict:
        return {"fps_mult": self.fps_mult, "duty_mult": self.duty_mult,
                "brightness_mult": self.brightness_mult,
                "active_mult": self.active_mult, "offload": self.offload}

    @classmethod
    def from_dict(cls, d: dict) -> "ThrottleAction":
        return cls(float(d["fps_mult"]), float(d["duty_mult"]),
                   float(d["brightness_mult"]), float(d["active_mult"]),
                   bool(d["offload"]))


@dataclass(frozen=True)
class ThrottlePolicy:
    """Two-trigger throttle governor with hysteresis bands.

    The thermal trigger trips when skin temperature exceeds
    `temp_trip_c` and clears only below `temp_clear_c`; the SoC trigger
    trips below `soc_trip` and clears above `soc_clear`.  The throttle
    level is the number of tripped triggers, clamped to the available
    `actions` (level 0 = no action).  The strict hysteresis bands are
    what keeps the closed loop from oscillating when the state sits
    exactly at a threshold (property-tested on the reference package).
    """
    name: str
    temp_trip_c: float = 40.0
    temp_clear_c: float = 37.5
    soc_trip: float = 0.15
    soc_clear: float = 0.25
    actions: tuple = ()          # level 1..len(actions)

    def __post_init__(self):
        if self.actions:
            if not self.temp_clear_c < self.temp_trip_c:
                raise ValueError("need temp_clear_c < temp_trip_c "
                                 "(hysteresis band)")
            if not self.soc_trip < self.soc_clear:
                raise ValueError("need soc_trip < soc_clear "
                                 "(hysteresis band)")

    @property
    def n_levels(self) -> int:
        return len(self.actions) + 1

    def action(self, level: int) -> ThrottleAction:
        if level <= 0:
            return ThrottleAction()
        return self.actions[min(level, len(self.actions)) - 1]

    def to_dict(self) -> dict:
        return {"name": self.name, "temp_trip_c": self.temp_trip_c,
                "temp_clear_c": self.temp_clear_c,
                "soc_trip": self.soc_trip, "soc_clear": self.soc_clear,
                "actions": [a.to_dict() for a in self.actions]}

    @classmethod
    def from_dict(cls, d: dict) -> "ThrottlePolicy":
        return cls(d["name"], float(d["temp_trip_c"]),
                   float(d["temp_clear_c"]), float(d["soc_trip"]),
                   float(d["soc_clear"]),
                   tuple(ThrottleAction.from_dict(a)
                         for a in d["actions"]))


# ---------------------------------------------------------------------------
# registries (declarative, next to the platform one)
# ---------------------------------------------------------------------------

_SCHEDULES: dict[str, DaySchedule] = {}
_POLICIES: dict[str, ThrottlePolicy] = {}


def register_schedule(s: DaySchedule) -> DaySchedule:
    _SCHEDULES[s.name] = s
    return s


def get_schedule(name: str) -> DaySchedule:
    if name not in _SCHEDULES:
        raise KeyError(f"unknown schedule {name!r}; "
                       f"registered: {sorted(_SCHEDULES)}")
    return _SCHEDULES[name]


def schedule_names() -> list[str]:
    return sorted(_SCHEDULES)


def register_policy(p: ThrottlePolicy) -> ThrottlePolicy:
    _POLICIES[p.name] = p
    return p


def get_policy(name: str) -> ThrottlePolicy:
    if name not in _POLICIES:
        raise KeyError(f"unknown policy {name!r}; "
                       f"registered: {sorted(_POLICIES)}")
    return _POLICIES[name]


def policy_names() -> list[str]:
    return sorted(_POLICIES)


# -- built-in days (representative traces, §II "all-day" framing) -----------

register_schedule(DaySchedule("commuter", (
    DaySegment("commute_am", 1.0, ambient_c=28.0, active=0.9,
               upload_duty=0.5, brightness=0.30),
    DaySegment("office_am", 3.5, ambient_c=24.0, active=0.55,
               upload_duty=0.30, brightness=0.15),
    DaySegment("lunch_conversation", 1.0, ambient_c=26.0, active=1.0,
               upload_duty=0.85, brightness=0.20),
    DaySegment("office_pm", 3.0, ambient_c=24.0, active=0.55,
               upload_duty=0.30, brightness=0.15),
    DaySegment("commute_pm", 1.0, ambient_c=30.0, active=0.9,
               upload_duty=0.5, brightness=0.30),
    DaySegment("evening", 2.5, ambient_c=23.0, active=0.4,
               upload_duty=0.30, brightness=0.40),
)))

register_schedule(DaySchedule("field_day", (
    DaySegment("morning_site", 3.0, ambient_c=33.0, active=1.0,
               upload_duty=0.8, brightness=0.55),
    DaySegment("midday_sun", 2.0, ambient_c=36.5, active=1.0,
               upload_duty=0.9, brightness=0.65),
    DaySegment("afternoon_site", 3.0, ambient_c=34.0, active=0.9,
               upload_duty=0.7, brightness=0.55),
    DaySegment("debrief", 1.0, ambient_c=26.0, active=0.7,
               upload_duty=0.5, brightness=0.25),
)))

register_schedule(DaySchedule("desk_day", (
    DaySegment("focus_am", 4.0, ambient_c=23.0, active=0.35,
               upload_duty=0.25, brightness=0.10),
    DaySegment("meetings", 2.0, ambient_c=24.5, active=0.8,
               upload_duty=0.6, brightness=0.20),
    DaySegment("focus_pm", 2.0, ambient_c=23.0, active=0.35,
               upload_duty=0.25, brightness=0.10),
)))

# commuter day with dock top-ups: the glasses sit on a desk dock during
# office blocks (charge_mw flows INTO the cell while still capturing)
register_schedule(DaySchedule("commuter_dock", (
    DaySegment("commute_am", 1.0, ambient_c=28.0, active=0.9,
               upload_duty=0.5, brightness=0.30),
    DaySegment("office_am_dock", 3.5, ambient_c=24.0, active=0.55,
               upload_duty=0.30, brightness=0.15, charge_mw=1600.0),
    DaySegment("lunch_conversation", 1.0, ambient_c=26.0, active=1.0,
               upload_duty=0.85, brightness=0.20),
    DaySegment("office_pm_dock", 3.0, ambient_c=24.0, active=0.55,
               upload_duty=0.30, brightness=0.15, charge_mw=1600.0),
    DaySegment("commute_pm", 1.0, ambient_c=30.0, active=0.9,
               upload_duty=0.5, brightness=0.30),
    DaySegment("evening", 2.5, ambient_c=23.0, active=0.4,
               upload_duty=0.30, brightness=0.40),
)))

# -- built-in policies -------------------------------------------------------

register_policy(ThrottlePolicy("none", actions=()))

register_policy(ThrottlePolicy(
    "thermal_governor", temp_trip_c=39.5, temp_clear_c=37.0,
    soc_trip=0.12, soc_clear=0.20,
    actions=(ThrottleAction(fps_mult=2.0, duty_mult=0.7,
                            brightness_mult=0.5),
             ThrottleAction(fps_mult=4.0, duty_mult=0.4,
                            brightness_mult=0.15, active_mult=0.6,
                            offload=True))))

register_policy(ThrottlePolicy(
    "battery_saver", temp_trip_c=41.0, temp_clear_c=38.5,
    soc_trip=0.35, soc_clear=0.45,
    actions=(ThrottleAction(fps_mult=2.0, duty_mult=0.5,
                            brightness_mult=0.4),
             ThrottleAction(fps_mult=8.0, duty_mult=0.25,
                            brightness_mult=0.1, active_mult=0.5,
                            offload=True))))


# ---------------------------------------------------------------------------
# designs: the per-day knob choices a SKU ships with
# ---------------------------------------------------------------------------

DEFAULT_DESIGNS = (
    {"name": "offload_lean", "on_device": (), "compression": 32.0,
     "fps_scale": 2.0, "mcs_tier": DEFAULT_MCS},
    {"name": "balanced_asr", "on_device": ("asr",), "compression": 16.0,
     "fps_scale": 1.0, "mcs_tier": DEFAULT_MCS},
    {"name": "edge_heavy",
     "on_device": ("vio", "eye_tracking", "asr", "hand_tracking"),
     "compression": 8.0, "fps_scale": 1.0, "mcs_tier": 0},
)


def _design_row(design: dict, seg: DaySegment,
                act: ThrottleAction) -> dict:
    """Effective ScenarioSet row for (design, segment, throttle level)."""
    return {
        "on_device": () if act.offload else tuple(design["on_device"]),
        "compression": float(design.get("compression", 10.0)),
        "fps_scale": float(design.get("fps_scale", 1.0)) * act.fps_mult,
        # repro: ignore[R002]: host design dict value (a Python int)
        "mcs_tier": int(design.get("mcs_tier", DEFAULT_MCS)),
        "upload_duty": min(1.0, seg.upload_duty * act.duty_mult),
        "brightness": min(1.0, seg.brightness * act.brightness_mult),
    }


# ---------------------------------------------------------------------------
# the numpy per-step oracle (the reference package's, as-is)
# ---------------------------------------------------------------------------

def _ref_node_step(soc, t_soc, t_skin, p_mw, charge_mw, amb, pre, c):
    """float32 scalar mirror of `_node_step` (same op order)."""
    f = np.float32
    v = (c[pre + "v_full"] - c[pre + "sag_v"] * (f(1.0) - soc)
         - c[pre + "knee_v"] * np.exp(-c[pre + "knee_sharp"] * soc))
    i_a = p_mw * f(1e-3) / v
    loss_mw = i_a * i_a * c[pre + "r_ohm"] * f(1e3)
    drain_mw = p_mw + loss_mw
    soc_n = min(max(soc - drain_mw * c[pre + "dsoc_coeff"]
                    + charge_mw * c[pre + "dsoc_coeff"], f(0.0)), f(1.0))
    heat_w = drain_mw * f(1e-3)
    flow = (t_soc - t_skin) * c[pre + "g_soc_skin"]
    t_soc_n = t_soc + (heat_w - flow) * c[pre + "dt_c_soc"]
    t_skin_n = t_skin + (flow - (t_skin - amb)
                         * c[pre + "g_skin_amb"]) * c[pre + "dt_c_skin"]
    return soc_n, t_soc_n, t_skin_n, drain_mw


def reference_integrate(tb: dict) -> dict:
    """Pure-Python per-step oracle: identical math to the scan, float32
    scalar ops in the same order (hard comparisons — the scan's STE
    forwards are exactly these).  O(steps) Python — the daysim bench
    baseline and the parity test's reference."""
    f = np.float32
    c = {k: f(v) for k, v in tb["const"].items()}
    mw, pods_t = np.asarray(tb["step_mw"]), np.asarray(tb["step_pods"])
    mw_p = np.asarray(tb["step_mw_p"])
    amult = np.asarray(tb["act_mult"])
    amb_t = np.asarray(tb["ambient"])
    active_t, valid_t = np.asarray(tb["active"]), np.asarray(tb["valid"])
    charge_t = np.asarray(tb["charge"])
    charge_p_t = np.asarray(tb["charge_p"])
    soc = soc_p = f(1.0)
    th_state, soc_state, shut = f(0.0), f(0.0), f(0.0)
    t_soc = t_skin = t_soc_p = t_skin_p = f(amb_t[0])
    out = {k: [] for k in ("soc", "soc_p", "t_soc", "t_skin", "t_soc_p",
                           "t_skin_p", "level", "th_state", "soc_state",
                           "shut", "p_mw", "p_p_mw", "drain_mw",
                           "drain_p_mw", "pods", "act", "alive")}
    for t in range(mw.shape[0]):
        if t_skin > c["temp_trip"]:
            th_state = f(1.0)
        elif t_skin < c["temp_clear"]:
            th_state = f(0.0)
        soc_eff = min(soc, soc_p)
        if soc_eff < c["soc_trip"]:
            soc_state = f(1.0)
        elif soc_eff > c["soc_clear"]:
            soc_state = f(0.0)
        level = int(min(th_state + soc_state, c["max_level"]))
        if t_skin > c["shutdown_c"]:
            shut = f(1.0)
        if t_skin_p > c["shutdown_c"] and c["has_puck"] > 0.0:
            shut = f(1.0)
        alive = ((f(1.0) if soc > 0.0 else f(0.0))
                 * (f(1.0) if soc_p > 0.0 else f(0.0))
                 * (f(1.0) - shut) * f(valid_t[t]))
        act = f(active_t[t]) * f(amult[level])
        p_mw = (act * f(mw[t, level])
                + (f(1.0) - act) * c["standby_mw"]) * alive
        p_p_mw = (act * f(mw_p[t, level])
                  + (f(1.0) - act) * c["p_standby_mw"]) * alive \
            * c["has_puck"]
        soc, t_soc, t_skin, drain_mw = _ref_node_step(
            soc, t_soc, t_skin, p_mw, f(charge_t[t]), f(amb_t[t]), "", c)
        soc_p, t_soc_p, t_skin_p, drain_p_mw = _ref_node_step(
            soc_p, t_soc_p, t_skin_p, p_p_mw, f(charge_p_t[t]),
            f(amb_t[t]), "p_", c)
        row = {"soc": soc, "soc_p": soc_p, "t_soc": t_soc,
               "t_skin": t_skin, "t_soc_p": t_soc_p,
               "t_skin_p": t_skin_p, "level": level,
               "th_state": th_state, "soc_state": soc_state,
               "shut": shut, "p_mw": p_mw, "p_p_mw": p_p_mw,
               "drain_mw": drain_mw, "drain_p_mw": drain_p_mw,
               "pods": act * f(pods_t[t, level]) * alive,
               "act": act, "alive": alive}
        for k, vv in row.items():
            out[k].append(vv)
    return {k: np.asarray(v, np.int32 if k == "level" else np.float32)
            for k, v in out.items()}



# ---------------------------------------------------------------------------
# combos
# ---------------------------------------------------------------------------

def _resolve(thing, registry_get, cls):
    if isinstance(thing, str):
        return registry_get(thing)
    if not isinstance(thing, cls):
        raise TypeError(f"expected {cls.__name__} or name, "
                        f"got {type(thing).__name__}")
    return thing


def _plat(p):
    if isinstance(p, PlatformSpec):
        return p
    from . import aria2
    from . import platform as registry
    aria2.platforms()
    return registry.get(p)


# backend stream order of the per-stream pod tables
STREAMS = tuple(offload.STREAM_SERVICE)


@dataclass
class _Combo:
    platform: PlatformSpec
    design: dict
    schedule: DaySchedule
    policy: ThrottlePolicy
    battery: BatterySpec
    thermal: ThermalSpec
    puck: PuckSpec | None = None
    mw_levels: np.ndarray = None        # (L, n_seg) filled by compile
    pods_levels: np.ndarray = None      # (L, n_seg)
    mbps_levels: np.ndarray = None      # (L, n_seg) gated uplink rate
    pods_stream_levels: np.ndarray = None   # (L, n_seg, len(STREAMS))
    mw_p_levels: np.ndarray = None      # (L, n_seg) puck active power
    steady_mw: float = 0.0

    def label(self) -> dict:
        out = {"platform": self.platform.name,
               "design": self.design.get("name", ""),
               "on_device": "+".join(self.design["on_device"]) or "(none)",
               "schedule": self.schedule.name,
               "policy": self.policy.name,
               "battery": self.battery.name}
        if self.puck is not None:
            out["puck"] = self.puck.name
        return out


def _theta_key(theta) -> tuple | None:
    if not theta:
        return None
    # repro: ignore[R002]: cache key from the caller's theta overrides: host
    # floats on the query path
    return tuple(sorted((k, float(v)) for k, v in theta.items()))


# legacy row cache: (context id, row knobs) -> the row's table columns,
# where a context id stands for one (PlatformSpec, theta, n_users,
# results_dir, device) combination, keyed by the spec itself (frozen,
# hashable) so a modified same-named platform gets a fresh context.
# Policy combos repeat the same (design, segment, level) rows, so rows
# are evaluated once per context and then served from here.
_ROW_CACHE: dict = {}
_ROW_CACHE_MAX = 200_000
_CTX_IDS: dict = {}
CACHE_STATS = {"hits": 0, "misses": 0, "evaluate_calls": 0,
               "evictions": 0}


def _ctx_id(plat: PlatformSpec, theta, n_users: float, results_dir,
            device) -> int:
    """Small int id for one evaluation context (spec hashed once per
    call, not once per row key)."""
    key = (plat, _theta_key(theta), float(n_users), str(results_dir),
           str(device))
    return _CTX_IDS.setdefault(key, len(_CTX_IDS))


def _row_key(row: dict) -> tuple:
    return (tuple(row["on_device"]), float(row["compression"]),
            float(row["fps_scale"]), int(row["mcs_tier"]),
            float(row["upload_duty"]), float(row["brightness"]))


def clear_row_cache() -> None:
    _ROW_CACHE.clear()
    _CTX_IDS.clear()
    CACHE_STATS.update(hits=0, misses=0, evaluate_calls=0, evictions=0)


# host caches of the fused pipeline (see the module docstring)
_PIPELINES: dict = {}
_PIPELINES_MAX = 32
_ASSEMBLIES: dict = {}
_ASSEMBLIES_MAX = 64
EXEC_STATS = {"hits": 0, "misses": 0, "traces": 0}  # no executables: 0
PIPELINE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
ASSEMBLY_STATS = {"hits": 0, "misses": 0, "evictions": 0}
ROW_STAGE_STATS = {"passes": 0}     # fused row-stage passes run


def clear_exec_cache() -> None:
    """Drop the fused pipeline's host caches and zero their counters."""
    _PIPELINES.clear()
    _ASSEMBLIES.clear()
    EXEC_STATS.update(hits=0, misses=0, traces=0)
    PIPELINE_STATS.update(hits=0, misses=0, evictions=0)
    ASSEMBLY_STATS.update(hits=0, misses=0, evictions=0)


def cache_stats() -> dict:
    """One snapshot of every daysim cache tier: hit/miss/eviction (and
    trace) counters plus the live entry count, keyed by tier.

    ``rows`` is the legacy engine's `_ROW_CACHE`, ``assemblies`` the
    value-keyed host-assembly cache, ``pipelines`` the value- and
    device-keyed cache of assemblies resident on the device, and
    ``exec`` the reference's compiled-executable tier.  PyTorch runs
    eagerly and the port compiles no executables, so ``exec`` always
    reads 0 hits, 0 misses, 0 traces and size 0."""
    return {
        "rows": {**CACHE_STATS, "size": len(_ROW_CACHE)},
        "assemblies": {**ASSEMBLY_STATS, "size": len(_ASSEMBLIES)},
        "pipelines": {**PIPELINE_STATS, "size": len(_PIPELINES)},
        "exec": {**EXEC_STATS, "size": 0},
    }


def bucket_size(n: int) -> int:
    """Canonical shape bucket for a grid axis: the smallest power of
    two >= n (1, 2, 4, 8, ...).  Combo, scenario-row and batch axes are
    padded to buckets with clones of entry 0; padded combos are forced
    to worst-case objectives before the front is taken and sliced off
    before the DayReport is built, so padding never shows."""
    if n <= 0:
        raise ValueError(f"bucket_size needs n > 0, got {n}")
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=32)
def _row_stage(plat: PlatformSpec):
    """Table stage for one platform: a batch of knob rows -> glasses
    total mW, gated uplink Mbps, puck active mW, backend pods and
    per-stream pods, float32 on the rows' device.  The fused pipeline
    and the legacy engine's `_row_eval` run this same function, which
    keeps their tables bit-identical."""
    eng = scenarios.batched_fn(plat)
    asr_j = plat.primitives.index("asr")

    def stage(vec, th, rates, gate_scale, p_base, p_wan):
        out = eng(vec, th)
        pods, pods_stream = offload.pods_streams_device(
            vec["placement"][:, asr_j], vec["fps_scale"],
            vec["upload_duty"], rates, gate_scale)
        mw_p = p_base + p_wan * out["mbps"]
        return out["total"], out["mbps"], mw_p, pods, pods_stream

    return stage


def _puck_coeffs(plat: PlatformSpec) -> tuple:
    """(base+link mW, mW/Mbps) of the platform's puck (0, 0 if none)."""
    puck = puck_for(plat)
    if puck is None:
        return 0.0, 0.0
    return puck.base_mw + puck.wan_link_mw, puck.wan_mw_per_mbps


def _put(a, dev: torch.device) -> torch.Tensor:
    # repro: ignore[R002]: one push of a new assembly's host arrays;
    # `_PIPELINES` keeps the result, so a warm query never reaches it
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _vec_np(sset: ScenarioSet) -> dict:
    """A scenario batch's knob columns as the row stage takes them."""
    return {"placement": sset.placement, "compression": sset.compression,
            "fps_scale": sset.fps_scale, "mcs_tier": sset.mcs_tier,
            "upload_duty": sset.upload_duty, "brightness": sset.brightness}


def _theta_np(plat: PlatformSpec, theta) -> dict:
    th = plat.theta_dict()
    if theta:
        th.update(theta)
    return {k: np.float32(v) for k, v in th.items()}


def _row_eval(plat: PlatformSpec, rows: list, n_users: float,
              theta=None, results_dir=None, device="cuda") -> np.ndarray:
    """Evaluate fresh scenario rows through the row stage on `device`
    (one pass, one copy to the host); returns (R, 4 + S) float64
    columns [total_mw, pods, mbps, *per-stream pods, mw_puck]."""
    sset = ScenarioSet.build(rows, primitives=plat.primitives)
    scenarios._validate(plat, sset)
    dev = _device.resolve(device)
    rr = offload.stream_rates(results_dir)
    p_base, p_wan = _puck_coeffs(plat)
    total, mbps, mw_p, pods, pods_stream = _row_stage(plat)(
        {k: _put(v, dev) for k, v in _vec_np(sset).items()},
        {k: _put(v, dev) for k, v in _theta_np(plat, theta).items()},
        _put(np.asarray(rr["tok_per_cap"], np.float32), dev),
        _put(np.float32(n_users), dev),     # duty=1.0, the daysim rule
        _put(np.float32(p_base), dev), _put(np.float32(p_wan), dev))
    cols = torch.cat([torch.stack([total, pods, mbps], dim=1),
                      pods_stream, mw_p[:, None]], dim=1)
    return cols.cpu().numpy().astype(np.float64)


def _combo_rows(cb: _Combo, rows: list) -> tuple:
    """Append one combo's scenario rows (levels x segments + the steady
    reference row) to `rows`; returns its (start, steady) offsets."""
    start = len(rows)
    for level in range(cb.policy.n_levels):
        act = cb.policy.action(level)
        rows.extend(_design_row(cb.design, seg, act)
                    for seg in cb.schedule.segments)
    # steady-state reference row: the design at nominal always-on
    # knobs (duty 1, display off)
    rows.append(_design_row(cb.design, DaySegment("steady", 1.0),
                            ThrottleAction()))
    return start, len(rows) - 1


def _compile_platform(plat: PlatformSpec, combos: list, n_users: float,
                      theta=None, results_dir=None, device="cuda") -> None:
    """Fill the level tables of every combo of one platform.

    Rows are deduplicated (`_row_key`) and served from `_ROW_CACHE`;
    only rows never seen in this (platform, theta, n_users,
    results_dir, device) context go through the row stage — at most ONE
    `_row_eval` call per compile, and zero on a warm cache.  The cache
    is bounded by FIFO eviction of the oldest rows once `_ROW_CACHE_MAX`
    is crossed, after this call has read its rows."""
    if not combos:
        return
    dev = _device.resolve(device)
    rows, slices = [], []
    for cb in combos:
        slices.append(_combo_rows(cb, rows))
    ctx = (_ctx_id(plat, theta, n_users, results_dir, dev),)
    keys = [ctx + _row_key(r) for r in rows]
    fresh: dict = {}
    for k, r in zip(keys, rows):
        if k not in _ROW_CACHE and k not in fresh:
            fresh[k] = r
    CACHE_STATS["hits"] += sum(k in _ROW_CACHE for k in keys)
    CACHE_STATS["misses"] += len(fresh)
    if fresh:
        fvals = _row_eval(plat, list(fresh.values()), n_users, theta,
                          results_dir, dev)
        CACHE_STATS["evaluate_calls"] += 1
        for i, k in enumerate(fresh):
            _ROW_CACHE[k] = tuple(fvals[i])
    vals = np.asarray([_ROW_CACHE[k] for k in keys], np.float64)
    totals, pods, mbps = vals[:, 0], vals[:, 1], vals[:, 2]
    streams, mw_p = vals[:, 3:-1], vals[:, -1]
    for cb, (start, steady_i) in zip(combos, slices):
        n_seg, n_lvl = len(cb.schedule.segments), cb.policy.n_levels
        cb.mw_levels = totals[start:steady_i].reshape(n_lvl, n_seg)
        cb.pods_levels = pods[start:steady_i].reshape(n_lvl, n_seg)
        cb.mbps_levels = mbps[start:steady_i].reshape(n_lvl, n_seg)
        cb.pods_stream_levels = streams[start:steady_i].reshape(
            n_lvl, n_seg, len(STREAMS))
        cb.mw_p_levels = mw_p[start:steady_i].reshape(n_lvl, n_seg)
        cb.steady_mw = float(totals[steady_i])
    # bounded FIFO eviction AFTER serving this call (evicting before
    # the value extraction above could drop entries this call indexes)
    while len(_ROW_CACHE) > _ROW_CACHE_MAX:
        del _ROW_CACHE[next(iter(_ROW_CACHE))]
        CACHE_STATS["evictions"] += 1


def _battery_const(bat: BatterySpec, th: ThermalSpec, dt_s: float,
                   pre: str = "") -> dict:
    return {
        pre + "v_full": bat.v_full, pre + "sag_v": bat.sag_v,
        pre + "knee_v": bat.knee_v,
        pre + "knee_sharp": bat.knee_sharpness,
        pre + "r_ohm": bat.r_internal_ohm,
        pre + "dsoc_coeff": dt_s / (3600.0 * bat.effective_capacity_mwh),
        pre + "g_soc_skin": 1.0 / th.r_soc_skin_k_per_w,
        pre + "g_skin_amb": 1.0 / th.r_skin_amb_k_per_w,
        pre + "dt_c_soc": dt_s / th.c_soc_j_per_k,
        pre + "dt_c_skin": dt_s / th.c_skin_j_per_k,
    }


def _combo_const(cb: _Combo, dt_s: float, standby_mw: float,
                 shutdown_c: float) -> dict:
    """Scan-constant scalars for one combo (policy thresholds + battery/
    thermal coefficients), as Python floats cast to float32 later;
    shared by the legacy table builder and the fused pipeline."""
    return {
        "temp_trip": cb.policy.temp_trip_c,
        "temp_clear": cb.policy.temp_clear_c,
        "soc_trip": cb.policy.soc_trip, "soc_clear": cb.policy.soc_clear,
        "max_level": float(cb.policy.n_levels - 1),
        "standby_mw": standby_mw,
        "shutdown_c": shutdown_c,
        "ste_beta_c": STE_BETA_C, "ste_beta_soc": STE_BETA_SOC,
        "has_puck": 1.0 if cb.puck is not None else 0.0,
        "p_standby_mw": cb.puck.standby_mw if cb.puck is not None else 0.0,
        **_battery_const(cb.battery, cb.thermal, dt_s),
        **_battery_const(
            cb.puck.battery if cb.puck is not None else cb.battery,
            cb.puck.thermal if cb.puck is not None else cb.thermal,
            dt_s, "p_"),
    }


def _step_rows(cb: _Combo, dt_s: float, n_steps: int) -> tuple:
    """(segment of each real step, the combo's (n_steps,) step rows):
    ambient (padded with the last segment's), capture duty and valid mask
    (padded with 0), and the dock/pocket top-up current split across the
    two nodes by capacity share."""
    segs = cb.schedule.segments
    seg_steps = [max(1, round(s.hours * 3600.0 / dt_s)) for s in segs]
    seg_idx = np.repeat(np.arange(len(segs)), seg_steps)
    t = len(seg_idx)
    amb = np.full(n_steps, segs[-1].ambient_c, np.float32)
    amb[:t] = np.asarray([s.ambient_c for s in segs], np.float32)[seg_idx]
    active = np.zeros(n_steps, np.float32)
    active[:t] = np.asarray([s.active for s in segs], np.float32)[seg_idx]
    valid = np.zeros(n_steps, np.float32)
    valid[:t] = 1.0
    cap_g = cb.battery.capacity_mwh
    cap_p = cb.puck.battery.capacity_mwh if cb.puck is not None else 0.0
    share_g = cap_g / (cap_g + cap_p) if cap_p else 1.0
    seg_charge = np.asarray([s.charge_mw for s in segs],
                            np.float32)[seg_idx]
    charge = np.zeros(n_steps, np.float32)
    charge_p = np.zeros(n_steps, np.float32)
    charge[:t] = seg_charge * np.float32(share_g)
    charge_p[:t] = seg_charge * np.float32(1.0 - share_g)
    return seg_idx, {"ambient": amb, "active": active, "valid": valid,
                     "charge": charge, "charge_p": charge_p}


def _act_mult(policy: ThrottlePolicy, n_levels: int) -> np.ndarray:
    """Capture-duty multiplier of each throttle level (padded levels
    repeat the deepest)."""
    amult = np.ones(n_levels, np.float32)
    for lv in range(1, policy.n_levels):
        amult[lv:] = policy.action(lv).active_mult
    return amult


def _combo_tables(cb: _Combo, dt_s: float, n_steps: int,
                  max_levels: int, standby_mw: float,
                  shutdown_c: float = DEFAULT_SHUTDOWN_C) -> dict:
    """Per-step numpy tables for one compiled combo, padded to the batch
    shape (the reference's layout: step tables (T, L))."""
    seg_idx, rows = _step_rows(cb, dt_s, n_steps)
    t = len(seg_idx)
    mw, pods, mw_p = cb.mw_levels, cb.pods_levels, cb.mw_p_levels
    pods_stream = cb.pods_stream_levels          # (L, n_seg, S)
    if mw.shape[0] < max_levels:            # pad levels with the last row
        pad = max_levels - mw.shape[0]
        mw = np.concatenate([mw, np.repeat(mw[-1:], pad, 0)])
        pods = np.concatenate([pods, np.repeat(pods[-1:], pad, 0)])
        pods_stream = np.concatenate([pods_stream,
                                      np.repeat(pods_stream[-1:], pad, 0)])
        mw_p = np.concatenate([mw_p, np.repeat(mw_p[-1:], pad, 0)])
    n_streams = pods_stream.shape[-1]
    step_mw = np.zeros((n_steps, max_levels), np.float32)
    step_pods = np.zeros((n_steps, max_levels), np.float32)
    step_pods_stream = np.zeros((n_steps, max_levels, n_streams),
                                np.float32)
    step_mw_p = np.zeros((n_steps, max_levels), np.float32)
    step_mw[:t] = mw.T[seg_idx]
    step_pods[:t] = pods.T[seg_idx]
    step_pods_stream[:t] = pods_stream.transpose(1, 0, 2)[seg_idx]
    step_mw_p[:t] = mw_p.T[seg_idx]
    const = _combo_const(cb, dt_s, standby_mw, shutdown_c)
    return {"step_mw": step_mw, "step_mw_p": step_mw_p,
            "step_pods": step_pods, "step_pods_stream": step_pods_stream,
            **rows, "act_mult": _act_mult(cb.policy, max_levels),
            "const": {k: np.float32(v) for k, v in const.items()}}


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclass
class DayReport:
    """Batched day-in-the-life results; all arrays share leading dim N.

    Objectives per combo: time_to_empty_h (maximize), peak_skin_c
    (minimize), pod_hours (minimize), throttled_h (capture-hours
    degraded by the policy).  `front_mask` is filled by
    `dse.day_pareto`."""
    combos: list                    # N combo label dicts
    day_hours: np.ndarray           # (N,)
    steady_mw: np.ndarray           # (N,) nominal steady-state total
    time_to_empty_h: np.ndarray     # (N,)
    end_soc: np.ndarray             # (N,)
    end_soc_puck: np.ndarray        # (N,) 1.0 for single-node SKUs
    peak_skin_c: np.ndarray         # (N,) glasses node
    peak_skin_puck_c: np.ndarray    # (N,) pocket host
    pod_hours: np.ndarray           # (N,)
    throttled_h: np.ndarray         # (N,)
    energy_mwh: np.ndarray          # (N,) total drained from the cell(s)
    shutdown: np.ndarray            # (N,) bool: thermal hard-kill latched
    n_users: float
    dt_s: float
    front_mask: np.ndarray | None = None
    skipped: list = field(default_factory=list)
    battery_fade: np.ndarray | None = None  # (N,) capacity-fade fraction

    def __len__(self) -> int:
        return len(self.combos)

    def survives(self, skin_limit_c: float = 43.0) -> np.ndarray:
        """(N,) bool: made it through the whole day without emptying a
        cell, thermally shutting down, or breaching the skin-contact
        comfort limit."""
        return ((self.time_to_empty_h >= self.day_hours - 1e-9)
                & (self.peak_skin_c <= skin_limit_c)
                & ~self.shutdown)

    def objectives(self) -> np.ndarray:
        """(N, 3) [time_to_empty_h, peak_skin_c, pod_hours]."""
        return np.stack([self.time_to_empty_h, self.peak_skin_c,
                         self.pod_hours], axis=1)

    def row(self, i: int, _survives=None) -> dict:
        surv = self.survives() if _survives is None else _survives
        cost = offload.pod_cost(float(self.pod_hours[i]))
        return {
            "index": int(i), **self.combos[i],
            "steady_mw": round(float(self.steady_mw[i]), 1),
            "time_to_empty_h": round(float(self.time_to_empty_h[i]), 2),
            "day_hours": round(float(self.day_hours[i]), 2),
            "survives": bool(surv[i]),
            "shutdown": bool(self.shutdown[i]),
            "end_soc": round(float(self.end_soc[i]), 3),
            "end_soc_puck": round(float(self.end_soc_puck[i]), 3),
            "peak_skin_c": round(float(self.peak_skin_c[i]), 2),
            "peak_skin_puck_c": round(float(self.peak_skin_puck_c[i]), 2),
            "pod_hours": round(float(self.pod_hours[i]), 1),
            "usd": round(cost["usd"], 2),
            "kgco2": round(cost["kgco2"], 1),
            "throttled_h": round(float(self.throttled_h[i]), 2),
            **({"battery_fade": round(float(self.battery_fade[i]), 3)}
               if self.battery_fade is not None
               and self.battery_fade[i] else {}),
        }

    def rows(self) -> list:
        surv = self.survives()
        return [self.row(i, surv) for i in range(len(self))]

    def front_indices(self) -> np.ndarray:
        if self.front_mask is None:
            raise ValueError(
                "DayReport.front_mask is not set — build the report with "
                "dse.day_pareto(...) (or daysim.day_grid(..., "
                "with_front=True)) to fill the non-dominated front.")
        return np.flatnonzero(self.front_mask)

    def front_rows(self) -> list:
        surv = self.survives()
        rows = [self.row(i, surv) for i in self.front_indices()]
        return sorted(rows, key=lambda r: -r["time_to_empty_h"])


@dataclass
class DayTrace:
    """Single-combo run with full per-step traces (examples, tests)."""
    combo: dict
    dt_s: float
    soc: np.ndarray
    soc_puck: np.ndarray
    t_soc_c: np.ndarray
    t_skin_c: np.ndarray
    t_skin_puck_c: np.ndarray
    level: np.ndarray
    th_state: np.ndarray
    soc_state: np.ndarray
    shut: np.ndarray
    p_mw: np.ndarray
    p_puck_mw: np.ndarray
    drain_mw: np.ndarray
    drain_puck_mw: np.ndarray
    pods: np.ndarray
    valid: np.ndarray
    summary: dict


def _summarize(ys: dict, tables: dict, dt_s: float) -> dict:
    """(N, T) numpy traces -> (N,) objectives in float64 on the host
    (the legacy engine's summary, the reference's as-is)."""
    soc = np.asarray(ys["soc"], np.float64)
    soc_p = np.asarray(ys["soc_p"], np.float64)
    shut = np.asarray(ys["shut"], np.float64)
    valid = np.asarray(tables["valid"], bool)
    t_skin = np.asarray(ys["t_skin"], np.float64)
    level = np.asarray(ys["level"])
    active = np.asarray(tables["active"], np.float64)
    day_steps = valid.sum(axis=1)
    # either node emptying — or the thermal hard-kill — ends the day
    dead = (np.minimum(soc, soc_p) <= 0.0) | (shut > 0.5)
    hit = dead.any(axis=1)
    first = np.argmax(dead, axis=1).astype(np.float64) + 1.0
    tte = np.where(hit, first, day_steps) * dt_s / 3600.0
    peak = np.where(valid, t_skin, -np.inf).max(axis=1)
    t_skin_p = np.asarray(ys["t_skin_p"], np.float64)
    peak_p = np.where(valid, t_skin_p, -np.inf).max(axis=1)
    pods = np.asarray(ys["pods"], np.float64)
    # capture-hours degraded by the policy while the device was still
    # alive (time after the cell empties is lost outright, not throttled)
    alive = np.concatenate([np.zeros_like(dead[:, :1]), dead[:, :-1]],
                           axis=1) == 0.0
    throttled = ((level > 0) & valid & alive) * active
    drain = (np.asarray(ys["drain_mw"], np.float64)
             + np.asarray(ys["drain_p_mw"], np.float64))
    return {
        "day_hours": day_steps * dt_s / 3600.0,
        "time_to_empty_h": tte,
        "end_soc": soc[:, -1],
        "end_soc_puck": soc_p[:, -1],
        "peak_skin_c": peak,
        "peak_skin_puck_c": peak_p,
        "pod_hours": pods.sum(axis=1) * dt_s / 3600.0,
        "throttled_h": throttled.sum(axis=1) * dt_s / 3600.0,
        "energy_mwh": drain.sum(axis=1) * dt_s / 3600.0,
        "shutdown": shut[:, -1] > 0.5,
    }


def _batteries_arg(battery, plat_name: str) -> BatterySpec:
    if battery is None:
        return battery_for(plat_name)
    if isinstance(battery, dict):
        return battery.get(plat_name, battery_for(plat_name))
    return battery


DEFAULT_PLATFORMS = ("aria2_display", "rayban_cam", "aria2_puck_split")
DEFAULT_SCHEDULES = ("commuter", "field_day", "desk_day")
DEFAULT_POLICIES = ("none", "thermal_governor", "battery_saver")


def _enumerate_combos(platforms, designs, schedules, policies,
                      battery=None, thermal=None) -> tuple:
    """Resolve grid axes into per-platform combo groups (no tables yet).

    Returns ([(plat, [combo, ...]), ...], skipped).  Designs whose
    placement a platform cannot run on-device are skipped, mirroring
    the engine's placement check."""
    schedules = [_resolve(s, get_schedule, DaySchedule)
                 for s in schedules]
    policies = [_resolve(p, get_policy, ThrottlePolicy) for p in policies]
    therm = thermal or DEFAULT_THERMAL
    groups, skipped = [], []
    for p in platforms:
        plat = _plat(p)
        supported = set(plat.supported_primitives())
        bat = _batteries_arg(battery, plat.name)
        puck = puck_for(plat)
        plat_combos = []
        for d in designs:
            if not set(d["on_device"]) <= supported:
                # repro: ignore[R006]: host assembly: a list of skipped-design
                # dicts, not tensors
                skipped.append({"platform": plat.name,
                                "design": d.get("name", ""),
                                "reason": "unsupported placement"})
                continue
            plat_combos.extend(
                _Combo(plat, d, sched, pol, bat, therm, puck)
                for sched in schedules for pol in policies)
        # repro: ignore[R006]: host assembly: a list of (platform, combos), not
        # tensors
        groups.append((plat, plat_combos))
    return groups, skipped


def build_combos(platforms=DEFAULT_PLATFORMS, designs=DEFAULT_DESIGNS,
                 schedules=DEFAULT_SCHEDULES, policies=DEFAULT_POLICIES,
                 n_users: float = 1e6, battery=None,
                 thermal: ThermalSpec | None = None, theta=None,
                 results_dir=None, device="cuda") -> tuple:
    """Enumerate runnable combos and fill their level tables (at most one
    row-stage pass per platform on `device`, through the row cache).
    Returns (combos, skipped); designs whose placement a platform cannot
    run on-device are skipped."""
    groups, skipped = _enumerate_combos(platforms, designs, schedules,
                                        policies, battery, thermal)
    combos = []
    for plat, plat_combos in groups:
        _compile_platform(plat, plat_combos, n_users, theta, results_dir,
                          device)
        combos.extend(plat_combos)
    if not combos:
        raise ValueError("no runnable (platform, design) combos")
    return combos, skipped


def batch_tables(combos: list, dt_s: float = DEFAULT_DT_S,
                 standby_mw: float = DEFAULT_STANDBY_MW,
                 shutdown_c: float = DEFAULT_SHUTDOWN_C) -> dict:
    """Stack compiled combos' step tables (numpy, leading dim N, padded
    to the longest schedule / deepest policy)."""
    n_steps = max(cb.schedule.n_steps(dt_s) for cb in combos)
    max_levels = max(cb.policy.n_levels for cb in combos)
    per = [_combo_tables(cb, dt_s, n_steps, max_levels, standby_mw,
                         shutdown_c)
           for cb in combos]
    out = {k: np.stack([p[k] for p in per]) for k in per[0] if k != "const"}
    out["const"] = {k: np.stack([p["const"][k] for p in per])
                    for k in per[0]["const"]}
    return out


def _kernel_tables(tb: dict, dev: torch.device) -> dict:
    """`batch_tables` output -> the day scan's tensors on `dev` in its
    time-major layout ((T, L, N) tables, (T, N) step rows, (L, N) level
    multipliers), each pushed once; the constants go as one matrix."""
    out = {k: _put(tb[k].transpose(1, 2, 0), dev) for k in _ds.TABLE_KEYS}
    out.update({k: _put(tb[k].T, dev) for k in _ds.ROW_KEYS})
    out["act_mult"] = _put(tb["act_mult"].T, dev)
    keys = sorted(tb["const"])
    mat = _put(np.stack([tb["const"][k] for k in keys]), dev)
    out["const"] = dict(zip(keys, mat))
    return out


def _scan_host(tb: dict, dev: torch.device, full: bool = False) -> dict:
    """Numpy tables of N combos (the `batch_tables` layout) -> one
    day-scan launch on `dev` (the full-trace mode when `full`) -> the
    (N, T) numpy traces, in one copy to the host."""
    tables = _kernel_tables(tb, dev)
    # the default mode keeps the dispatch's one-argument call, which
    # wrappers of `day_scan` (the smoke run's recorder, tests) rely on
    ys = _ds.day_scan(tables, full=True) if full else _ds.day_scan(tables)
    keys = _ds.TRACE_OUTS if full else _ds.OUTS
    host = torch.stack([ys[k].float() for k in keys]).cpu().numpy()
    ys_np = dict(zip(keys, host))
    ys_np["level"] = ys_np["level"].astype(np.int32)
    return ys_np


def _scan_legacy(combos: list, dt_s: float, standby_mw: float,
                 shutdown_c: float, dev: torch.device) -> dict:
    """The legacy engine's day: numpy tables, one day-scan launch at N =
    len(combos), one copy of the traces to the host, and the float64
    `_summarize`."""
    tb = batch_tables(combos, dt_s, standby_mw, shutdown_c)
    return _summarize(_scan_host(tb, dev), tb, dt_s)


# ---------------------------------------------------------------------------
# the fused day pipeline: rows -> tables -> day scan -> objectives -> front
# ---------------------------------------------------------------------------

# x * dt_s / 3600.0 as the reference's compiled program evaluates it: a
# division by a constant becomes a product with its float32 reciprocal
_INV_3600 = float(np.float32(1.0) / np.float32(3600.0))


def _hours(steps_sum, dt_s):
    return steps_sum * dt_s * _INV_3600


def _step_sums(*xs) -> tuple:
    """Sums over the step axis of (N, T) traces in one fixed pairwise
    order: the steps are zero-padded to a power of two and halved,
    x[:h] + x[h:], until one is left.  Every add is elementwise, so a
    combo's sum does not depend on how many combos share the call (a
    reduction kernel may split its work by its number of outputs), and
    a query answered inside a batch keeps the bits it has alone."""
    x = torch.stack([v.t() for v in xs])                # (k, T, N)
    t = x.shape[1]
    p = 1 << (t - 1).bit_length()
    if p != t:
        x = torch.cat([x, x.new_zeros((x.shape[0], p - t, x.shape[2]))],
                      dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return tuple(x[:, 0])


def _summarize_torch(ys: dict, valid, active, dt_s) -> dict:
    """(N, T) traces -> (N,) objectives, float32 on the traces' device
    (the reference's `_summarize_jax`, same expressions in the same
    order; the step sums in `_step_sums`' fixed order).  `dt_s` is a
    0-dim or an (N,) tensor.  Integer-step quantities and trace maxima
    are exact."""
    soc, soc_p, shut = ys["soc"], ys["soc_p"], ys["shut"]
    vb = valid > 0.0
    day_steps = torch.sum(valid, dim=1)     # a count: exact in any order
    # either node emptying — or the thermal hard-kill — ends the day
    dead = (torch.minimum(soc, soc_p) <= 0.0) | (shut > 0.5)
    hit = torch.any(dead, dim=1)
    first = torch.argmax(dead.to(torch.int32), dim=1).to(soc.dtype) + 1.0
    tte = _hours(torch.where(hit, first, day_steps), dt_s)
    neg_inf = torch.full_like(ys["t_skin"], -float("inf"))
    peak = torch.amax(torch.where(vb, ys["t_skin"], neg_inf), dim=1)
    peak_p = torch.amax(torch.where(vb, ys["t_skin_p"], neg_inf), dim=1)
    # capture-hours degraded by the policy while the device was still
    # alive (time after the cell empties is lost outright, not throttled)
    alive = ~torch.cat([torch.zeros_like(dead[:, :1]), dead[:, :-1]],
                       dim=1)
    throttled = ((ys["level"] > 0) & vb & alive) * active
    drain = ys["drain_mw"] + ys["drain_p_mw"]
    pods_sum, throttled_sum, drain_sum = _step_sums(ys["pods"], throttled,
                                                    drain)
    return {
        "day_hours": _hours(day_steps, dt_s),
        "time_to_empty_h": tte,
        "end_soc": soc[:, -1],
        "end_soc_puck": soc_p[:, -1],
        "peak_skin_c": peak,
        "peak_skin_puck_c": peak_p,
        "pod_hours": _hours(pods_sum, dt_s),
        "throttled_h": _hours(throttled_sum, dt_s),
        "energy_mwh": _hours(drain_sum, dt_s),
        "shutdown": shut[:, -1] > 0.5,
    }


def _design_key(d: dict) -> tuple:
    """Hashable identity of a design dict (value-level, order-free)."""
    return tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple))
                         else v) for k, v in d.items()))


@dataclass
class _Assembly:
    """Host half of one fully-valued query, padded to bucket shapes:
    numpy masters for the value-level inputs (`dyn`) and the gather
    indices / step rows (`ix`), and the shape signature that decides
    which queries can share one batch."""
    combos: list
    skipped: list
    dyn: dict               # numpy masters (incl. combo_w), bucketed
    ix: dict                # numpy gather indices / step data, bucketed
    plats: tuple            # platform specs, row-stage order
    sig: tuple              # bucketed shape signature
    row_ctx: tuple          # per platform: what its row stage reads
                            # besides the rows (theta, n_users, rates)
    key: tuple              # value-level identity
    n_real: int             # combos before bucket padding
    n_users: float
    dt_s: float


@dataclass
class _Pipeline:
    """One assembled query with all of its tensors on one device."""
    asm: _Assembly
    dyn: dict               # value-level tensors
    ix: dict                # (T, L, N) gather rows, (T, N) step rows


def _assemble_query(platforms=DEFAULT_PLATFORMS, designs=DEFAULT_DESIGNS,
                    schedules=DEFAULT_SCHEDULES, policies=DEFAULT_POLICIES,
                    dt_s=DEFAULT_DT_S, n_users=1e6,
                    standby_mw=DEFAULT_STANDBY_MW, battery=None,
                    thermal=None, theta=None, results_dir=None,
                    shutdown_c=DEFAULT_SHUTDOWN_C) -> _Assembly:
    """Assemble (or fetch from `_ASSEMBLIES`) the bucket-padded host half
    of one query (`day_grid`'s grid arguments and defaults)."""
    groups, skipped = _enumerate_combos(platforms, designs, schedules,
                                        policies, battery, thermal)
    combos = [cb for _, grp in groups for cb in grp]
    if not combos:
        raise ValueError("no runnable (platform, design) combos")
    key = (tuple((plat, tuple((_design_key(cb.design), cb.schedule,
                               cb.policy, cb.battery, cb.thermal)
                              for cb in grp))
                 for plat, grp in groups),
           # repro: ignore[R002]: host query arguments (Python numbers)
           # normalised into the assembly's cache key
           float(dt_s), float(n_users), float(standby_mw),
           # repro: ignore[R002]: host query arguments (Python numbers)
           # normalised into the assembly's cache key
           _theta_key(theta), str(results_dir), float(shutdown_c))
    asm = _ASSEMBLIES.get(key)
    if asm is not None:
        # repro: ignore[R002]: the assembly cache's hit counter: host
        # bookkeeping by design
        ASSEMBLY_STATS["hits"] += 1
        return asm
    # repro: ignore[R002]: the assembly cache's miss counter: host bookkeeping
    # by design
    ASSEMBLY_STATS["misses"] += 1

    T = max(cb.schedule.n_steps(dt_s) for cb in combos)
    L = max(cb.policy.n_levels for cb in combos)
    rr = offload.stream_rates(results_dir)
    grp_dyn, theta_keys, row_counts, row_ctx = [], [], [], []
    lvl_row, seg_of, steady_of, amults, consts = [], [], [], [], []
    step_rows = {k: [] for k in _ds.ROW_KEYS}
    base = 0
    for plat, grp in groups:
        rows, slices = [], []
        for cb in grp:
            # repro: ignore[R006]: host assembly on a cache miss: numpy rows,
            # not tensors
            slices.append(_combo_rows(cb, rows))
        sset = ScenarioSet.build(rows, primitives=plat.primitives)
        scenarios._validate(plat, sset)
        r_b = bucket_size(len(rows)) if rows else 0
        sset = sset.pad(r_b)
        th = _theta_np(plat, theta)
        p_base, p_wan = _puck_coeffs(plat)
        # repro: ignore[R006]: host assembly on a cache miss: numpy rows, not
        # tensors
        grp_dyn.append({"vec": _vec_np(sset), "theta": th,
                        "p_base": np.float32(p_base),
                        "p_wan": np.float32(p_wan)})
        theta_keys.append(tuple(sorted(th)))
        row_counts.append(r_b)
        # repro: ignore[R006]: host assembly on a cache miss: numpy rows, not
        # tensors
        row_ctx.append((tuple(sorted(th.items())), float(n_users),
                        str(results_dir)))
        for cb, (start, steady_i) in zip(grp, slices):
            n_seg, n_lvl = len(cb.schedule.segments), cb.policy.n_levels
            seg_idx, rows_t = _step_rows(cb, dt_s, T)
            so = np.full(T, n_seg - 1, np.int64)   # pad: last segment
            so[:len(seg_idx)] = seg_idx
            # repro: ignore[R006]: host assembly on a cache miss: numpy rows,
            # not tensors
            seg_of.append(so)
            lv = np.minimum(np.arange(L), n_lvl - 1)  # pad: last level
            lvl_row.append(base + start + lv * n_seg)
            steady_of.append(base + steady_i)
            for k, v in rows_t.items():
                # repro: ignore[R006]: host assembly on a cache miss: numpy
                # rows, not tensors
                step_rows[k].append(v)
            # repro: ignore[R006]: host assembly on a cache miss: numpy rows,
            # not tensors
            amults.append(_act_mult(cb.policy, L))
            # repro: ignore[R006]: host assembly on a cache miss: numpy rows,
            # not tensors
            consts.append(_combo_const(cb, dt_s, standby_mw, shutdown_c))
        base += r_b

    n_real = len(combos)
    n_b = bucket_size(n_real)

    def _pad_n(a):
        # repro: ignore[R002]: host assembly on a cache miss: numpy arrays, not
        # tensors
        a = np.asarray(a)
        if n_b == n_real:
            return a
        return np.concatenate([a, np.repeat(a[:1], n_b - n_real, 0)])

    combo_w = np.zeros(n_b, np.float32)
    combo_w[:n_real] = 1.0
    dyn = {"groups": tuple(grp_dyn),
           # repro: ignore[R002]: host assembly on a cache miss: numpy arrays,
           # not tensors
           "rates": np.asarray(rr["tok_per_cap"], np.float32),
           "gate": np.float32(n_users),
           "act_mult": _pad_n(np.stack(amults)),
           "const": {k: _pad_n(np.asarray([c[k] for c in consts],
                                          np.float32))
                     for k in sorted(consts[0])},
           "combo_w": combo_w,
           "dt_s": np.float32(dt_s)}
    ix = {"lvl_row": _pad_n(np.stack(lvl_row)),
          "seg_of": _pad_n(np.stack(seg_of)),
          "steady_of": _pad_n(np.asarray(steady_of, np.int64)),
          **{k: _pad_n(np.stack(v)) for k, v in step_rows.items()}}

    plats = tuple(plat for plat, _ in groups)
    sig = (plats, tuple(theta_keys), tuple(row_counts), n_b, T, L,
           len(rr["tok_per_cap"]))
    asm = _Assembly(combos, skipped, dyn, ix, plats, sig, tuple(row_ctx),
                    # repro: ignore[R002]: host query argument (a Python
                    # number) in the assembly record
                    key, n_real, float(n_users), float(dt_s))
    # repro: ignore[R002]: the value-keyed assembly cache: host bookkeeping by
    # design
    _ASSEMBLIES[key] = asm
    while len(_ASSEMBLIES) > _ASSEMBLIES_MAX:
        del _ASSEMBLIES[next(iter(_ASSEMBLIES))]
        # repro: ignore[R002]: the assembly cache's eviction counter: host
        # bookkeeping by design
        ASSEMBLY_STATS["evictions"] += 1
    return asm


def _batch_defaults() -> dict:
    return {"platforms": DEFAULT_PLATFORMS, "designs": DEFAULT_DESIGNS,
            "schedules": DEFAULT_SCHEDULES, "policies": DEFAULT_POLICIES,
            "dt_s": DEFAULT_DT_S, "n_users": 1e6,
            "standby_mw": DEFAULT_STANDBY_MW, "battery": None,
            "thermal": None, "theta": None, "results_dir": None,
            "shutdown_c": DEFAULT_SHUTDOWN_C}


def _to_device(asm: _Assembly, dev: torch.device) -> _Pipeline:
    """Push one assembly's tensors to `dev`, in the kernel's time-major
    layout: (T, L, N) gather rows, (T, N) step rows, (L, N) level
    multipliers and the (C, N) constant matrix (rows in sorted key
    order)."""
    ix = asm.ix
    rows_tln = ix["lvl_row"].T[None, :, :] + ix["seg_of"].T[:, None, :]
    dix = {"rows_tln": _put(rows_tln, dev),
           "steady_of": _put(ix["steady_of"], dev)}
    for k in _ds.ROW_KEYS:
        dix[k] = _put(ix[k].T, dev)
    d = asm.dyn
    dyn = {"groups": tuple(
               {"vec": {k: _put(v, dev) for k, v in g["vec"].items()},
                "theta": {k: _put(v, dev) for k, v in g["theta"].items()},
                "p_base": _put(g["p_base"], dev),
                "p_wan": _put(g["p_wan"], dev)}
               for g in d["groups"]),
           "rates": _put(d["rates"], dev), "gate": _put(d["gate"], dev),
           "act_mult": _put(d["act_mult"].T, dev),
           "const": _put(np.stack(list(d["const"].values())), dev),
           "combo_w": _put(d["combo_w"], dev),
           "dt_s": _put(d["dt_s"], dev)}
    return _Pipeline(asm, dyn, dix)


def _pipeline_for(asm: _Assembly, dev: torch.device) -> _Pipeline:
    """The device-resident pipeline of one assembly (from `_PIPELINES`,
    or pushed now)."""
    key = asm.key + (str(dev),)
    pipe = _PIPELINES.get(key)
    if pipe is not None:
        # repro: ignore[R002]: the pipeline cache's hit counter: host
        # bookkeeping by design
        PIPELINE_STATS["hits"] += 1
        return pipe
    # repro: ignore[R002]: the pipeline cache's miss counter: host bookkeeping
    # by design
    PIPELINE_STATS["misses"] += 1
    # repro: ignore[R002]: the device-pipeline cache: host bookkeeping by
    # design
    pipe = _PIPELINES[key] = _to_device(asm, dev)
    while len(_PIPELINES) > _PIPELINES_MAX:
        del _PIPELINES[next(iter(_PIPELINES))]
        # repro: ignore[R002]: the pipeline cache's eviction counter: host
        # bookkeeping by design
        PIPELINE_STATS["evictions"] += 1
    return pipe


def _fused_pipeline(dev: torch.device, **query) -> _Pipeline:
    """Assemble (or fetch) the device-resident pipeline of one query;
    `query` takes `day_grid`'s grid arguments."""
    return _pipeline_for(_assemble_query(**query), dev)


def _batch_rows(pipes: list) -> tuple:
    """Row stages of a batch of same-signature pipelines: returns the
    (K, R) glasses totals, puck mW and pods of every query's scenario
    rows (its platforms' bucketed rows side by side, as one query lays
    them out).  Per platform, queries whose row stage reads the same
    theta, n_users and stream rates share ONE pass over their stacked
    rows; each distinct context gets one pass, never one per query."""
    out = ([], [], [])
    for p, plat in enumerate(pipes[0].asm.plats):
        by_ctx: dict = {}
        for q, pipe in enumerate(pipes):
            by_ctx.setdefault(pipe.asm.row_ctx[p], []).append(q)
        parts = []
        for qs in by_ctx.values():
            gs = [pipes[q].dyn["groups"][p] for q in qs]
            vec = gs[0]["vec"] if len(gs) == 1 else {
                # repro: ignore[R006]: one concatenation per platform and row
                # context of a batch, not per step
                k: torch.cat([g["vec"][k] for g in gs]) for k in gs[0]["vec"]}
            d0 = pipes[qs[0]].dyn
            total, _, mw_p, pods, _ = _row_stage(plat)(
                vec, gs[0]["theta"], d0["rates"], d0["gate"],
                gs[0]["p_base"], gs[0]["p_wan"])
            # repro: ignore[R002]: the row-stage pass counter
            # (ROW_STAGE_STATS): host bookkeeping by design
            ROW_STAGE_STATS["passes"] += 1
            # repro: ignore[R006]: one entry per platform and row context of a
            # batch, not per step
            parts.append((qs, [x.view(len(qs), -1)
                               for x in (total, mw_p, pods)]))
        for j in range(3):
            if len(parts) == 1:
                out[j].append(parts[0][1][j])
                continue
            buf = parts[0][1][j].new_empty(
                (len(pipes), parts[0][1][j].shape[1]))
            for qs, xs in parts:
                buf[qs] = xs[j]
            out[j].append(buf)
    return tuple(torch.cat(o, dim=1) for o in out)


def _batch_tables(pipes: list) -> tuple:
    """Row stages + the day tables of a batch: each query's (T, L, N_b)
    tables and (T, N_b) step rows laid side by side along the combo axis
    (N = K x N_b).  Returns (the day-scan tables, the (N,) steady
    totals)."""
    total, mw_p, pods = _batch_rows(pipes)
    if len(pipes) == 1:
        rows, steady_of = pipes[0].ix["rows_tln"], pipes[0].ix["steady_of"]
    else:
        off = torch.arange(len(pipes), device=total.device) * total.shape[1]
        rows = torch.stack([p.ix["rows_tln"] for p in pipes], dim=2) \
            + off[:, None]
        rows = rows.reshape(rows.shape[0], rows.shape[1], -1)
        steady_of = (torch.stack([p.ix["steady_of"] for p in pipes])
                     + off[:, None]).reshape(-1)
    total, mw_p, pods = total.reshape(-1), mw_p.reshape(-1), pods.reshape(-1)

    def side_by_side(get):
        xs = [get(p) for p in pipes]
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)

    const = side_by_side(lambda p: p.dyn["const"])
    tables = {"step_mw": total[rows], "step_mw_p": mw_p[rows],
              "step_pods": pods[rows],
              "act_mult": side_by_side(lambda p: p.dyn["act_mult"]),
              "const": dict(zip(pipes[0].asm.dyn["const"], const))}
    for k in _ds.ROW_KEYS:
        tables[k] = side_by_side(lambda p: p.ix[k])
    return tables, total[steady_of]


def day_tables(pipe: _Pipeline) -> tuple:
    """Row stages + the (T, L, N) gather of one pipeline: returns (the
    day-scan tables, the (N,) steady totals)."""
    return _batch_tables([pipe])


def _run_batch(pipes: list) -> dict:
    """The device half of K same-signature queries: row stages, the
    gather, ONE day-scan launch at N = K x N_b, summary and per-query
    fronts, all on the pipelines' device.  A single query is the batch
    of one; every step computes a lane's values the same way whatever
    the batch width, so a query's bits do not depend on its batch."""
    from . import dse
    k = len(pipes)
    tables, steady = _batch_tables(pipes)
    ys = _ds.day_scan(tables)
    n_b = pipes[0].ix["valid"].shape[1]
    dt = torch.cat([p.dyn["dt_s"].reshape(1) for p in pipes])
    summ = _summarize_torch(ys, tables["valid"].t(), tables["active"].t(),
                            dt[:, None].expand(k, n_b).reshape(-1))
    summ["steady_mw"] = steady
    obj = torch.stack([summ["time_to_empty_h"], summ["peak_skin_c"],
                       summ["pod_hours"]], dim=1)
    # bucket padding: zero-weight clone lanes are forced to the worst
    # corner (tte -inf maximized; peak/pods +inf minimized), so every
    # real row strictly dominates them
    w = torch.cat([p.dyn["combo_w"] for p in pipes]) > 0.0
    worst = torch.tensor([-float("inf"), float("inf"), float("inf")],
                         dtype=obj.dtype).to(obj.device)
    obj = torch.where(w[:, None], obj, worst)
    front = dse.non_dominated_torch(obj.view(k, n_b, 3), maximize=(0,))
    summ["front_mask"] = front.reshape(-1) & w
    return summ


def _reports(summ: dict, asms: list, with_front: bool) -> list:
    """Device summary of a batch -> one DayReport per query, its pad
    lanes sliced off; the whole summary goes to the host in one copy."""
    keys = sorted(summ)
    # repro: ignore[R002]: the twin's one copy of a batch summary to the host:
    # what the user asked for
    host = torch.stack([summ[k].float() for k in keys]).cpu().numpy()
    n_b = len(asms[0].dyn["combo_w"])
    reps = []
    for q, asm in enumerate(asms):
        lanes = slice(q * n_b, q * n_b + asm.n_real)
        f = {k: (host[i, lanes] > 0.5 if summ[k].dtype == torch.bool
                 # repro: ignore[R006]: host float64 report fields of the
                 # copied summary, as the reference's DayReport
                 else host[i, lanes].astype(np.float64))
             for i, k in enumerate(keys)}
        front = f.pop("front_mask")
        rep = DayReport(
            combos=[cb.label() for cb in asm.combos],
            steady_mw=f.pop("steady_mw"), n_users=asm.n_users,
            dt_s=asm.dt_s, skipped=asm.skipped,
            battery_fade=np.asarray([cb.battery.fade for cb in asm.combos]),
            **f)
        if with_front:
            rep.front_mask = front
        # repro: ignore[R006]: host DayReport objects, one per query of the
        # batch
        reps.append(rep)
    return reps


def _assemble_batch(queries, shared: dict) -> list:
    """One `_Assembly` per query: each entry of `queries` is a dict of
    `day_grid` grid kwargs layered over `shared` and the defaults."""
    asms = []
    for q in queries:
        kw = _batch_defaults()
        kw.update(shared)
        kw.update(q)
        asms.append(_assemble_query(**kw))
    if not asms:
        raise ValueError("day_grid_batch needs at least one query")
    return asms


def _answer(asms: list, dev: torch.device) -> list:
    """Reports of same-signature assemblies: one pass of the pipeline."""
    pipes = [_pipeline_for(a, dev) for a in asms]
    return _reports(_run_batch(pipes), asms, with_front=True)


def day_grid_batch(queries, device="cuda", **shared) -> list:
    """Evaluate K fully-valued queries through ONE day-scan launch.

    Each entry of `queries` is a dict of `day_grid` grid kwargs layered
    over `shared` and the daysim defaults.  All K must land in the same
    bucketed shape signature (same platforms, theta keys, schedule
    steps, level count and combo / row buckets); value-level differences
    (designs, thresholds, batteries, n_users, ambients) are what the
    batch carries.  The queries are assembled on the host (value-cached)
    and their day tables go side by side along the combo axis: the CUDA
    kernel runs once at N = K x N_b.  Queries whose row stages read the
    same theta, n_users and results_dir share one row-stage pass per
    platform.  Every query's report equals its serial
    `day_grid(..., with_front=True)` answer bit for bit; returns one
    `DayReport` per query (front attached)."""
    asms = _assemble_batch(queries, shared)
    sig0 = asms[0].sig
    for i, a in enumerate(asms[1:], 1):
        if a.sig != sig0:
            raise ValueError(
                f"batch query {i} maps to a different bucketed shape "
                f"signature than query 0 (N_b, T, L, rows "
                f"{a.sig[3:6] + a.sig[2:3]} vs {sig0[3:6] + sig0[2:3]}); "
                f"a batch is ONE day-scan launch — group queries by "
                f"signature first (day_grid_groups does)")
    return _answer(asms, _device.resolve(device))


def day_grid_groups(queries, device="cuda", **shared) -> tuple:
    """`day_grid_batch` over queries of any signatures: each query is
    assembled once, the queries are grouped by bucketed shape signature
    and each group runs as one batch (one day-scan launch).  Returns
    (one report per query in submission order, the number of
    groups)."""
    asms = _assemble_batch(queries, shared)
    dev = _device.resolve(device)
    groups: dict = {}
    for i, a in enumerate(asms):
        groups.setdefault(a.sig, []).append(i)
    reports: list = [None] * len(asms)
    for idx in groups.values():
        for i, rep in zip(idx, _answer([asms[i] for i in idx], dev)):
            reports[i] = rep
    return reports, len(groups)


def day_grid(platforms=DEFAULT_PLATFORMS, designs=DEFAULT_DESIGNS,
             schedules=DEFAULT_SCHEDULES, policies=DEFAULT_POLICIES,
             dt_s: float = DEFAULT_DT_S, n_users: float = 1e6,
             standby_mw: float = DEFAULT_STANDBY_MW, battery=None,
             thermal: ThermalSpec | None = None, theta=None,
             results_dir=None,
             shutdown_c: float = DEFAULT_SHUTDOWN_C,
             engine: str = "legacy", with_front: bool = False,
             device="cuda") -> DayReport:
    """Simulate every (platform x design x schedule x policy) combo on
    `device`.

    `engine="fused"` runs the device pipeline (row stages, table gather,
    day scan, summary and front on the device: the batch of one of
    `day_grid_batch`); `engine="legacy"` (the default, as in the
    reference; `dse.day_pareto` asks for the fused engine) fills
    host-cached numpy tables
    through the row cache, runs the same day scan and summarizes in
    float64 on the host (the reference's oracle for the fused engine:
    front masks and survival flags agree bit for bit).  Designs whose
    placement a platform cannot run on-device are skipped (recorded in
    `report.skipped`).  `battery` may be a single BatterySpec or a
    {platform_name: BatterySpec} map; defaults come from `BATTERIES`.
    `with_front=True` fills `front_mask`."""
    if engine not in ("fused", "legacy"):
        raise ValueError(f"unknown engine {engine!r}; "
                         f"expected 'fused' or 'legacy'")
    dev = _device.resolve(device)
    if engine == "fused":
        asm = _assemble_query(
            platforms=platforms, designs=designs, schedules=schedules,
            policies=policies, dt_s=dt_s, n_users=n_users,
            standby_mw=standby_mw, battery=battery, thermal=thermal,
            theta=theta, results_dir=results_dir, shutdown_c=shutdown_c)
        summ = _run_batch([_pipeline_for(asm, dev)])
        return _reports(summ, [asm], with_front)[0]
    combos, skipped = build_combos(platforms, designs, schedules,
                                   policies, n_users, battery, thermal,
                                   theta, results_dir, dev)
    rep = DayReport(
        combos=[cb.label() for cb in combos],
        steady_mw=np.asarray([cb.steady_mw for cb in combos]),
        n_users=n_users, dt_s=dt_s, skipped=skipped,
        battery_fade=np.asarray([cb.battery.fade for cb in combos]),
        **_scan_legacy(combos, dt_s, standby_mw, shutdown_c, dev))
    if with_front:
        from . import dse
        rep.front_mask = dse.non_dominated(rep.objectives(), maximize=(0,))
    return rep


def simulate(platform, design: dict, schedule, policy="none",
             dt_s: float = DEFAULT_DT_S, n_users: float = 1e6,
             standby_mw: float = DEFAULT_STANDBY_MW,
             battery: BatterySpec | None = None,
             thermal: ThermalSpec | None = None, theta=None,
             results_dir=None,
             shutdown_c: float = DEFAULT_SHUTDOWN_C,
             device="cuda") -> DayTrace:
    """One (platform, design, schedule, policy) day with full traces: the
    combo's tables through the row cache, one full-trace day-scan launch
    at N = 1 on `device`, the float64 `_summarize`."""
    dev = _device.resolve(device)
    plat = _plat(platform)
    cb = _Combo(plat, design, _resolve(schedule, get_schedule, DaySchedule),
                _resolve(policy, get_policy, ThrottlePolicy),
                _batteries_arg(battery, plat.name),
                thermal or DEFAULT_THERMAL, puck_for(plat))
    _compile_platform(plat, [cb], n_users, theta, results_dir, dev)
    tb = batch_tables([cb], dt_s, standby_mw, shutdown_c)
    ys = _scan_host(tb, dev, full=True)
    summary = {k: float(v[0]) for k, v in _summarize(ys, tb, dt_s).items()}
    summary["steady_mw"] = cb.steady_mw
    return DayTrace(
        combo=cb.label(), dt_s=dt_s, soc=ys["soc"][0],
        soc_puck=ys["soc_p"][0], t_soc_c=ys["t_soc"][0],
        t_skin_c=ys["t_skin"][0], t_skin_puck_c=ys["t_skin_p"][0],
        level=ys["level"][0], th_state=ys["th_state"][0],
        soc_state=ys["soc_state"][0], shut=ys["shut"][0],
        p_mw=ys["p_mw"][0], p_puck_mw=ys["p_p_mw"][0],
        drain_mw=ys["drain_mw"][0], drain_puck_mw=ys["drain_p_mw"][0],
        pods=ys["pods"][0], valid=tb["valid"][0], summary=summary)


def simulate_users(platform, design: dict, schedule, policy="none", *,
                   fades=None, ambient_offsets_c=None,
                   dt_s: float = DEFAULT_DT_S,
                   n_users_backend: float = 1.0,
                   standby_mw: float = DEFAULT_STANDBY_MW,
                   battery: BatterySpec | None = None,
                   thermal: ThermalSpec | None = None, theta=None,
                   results_dir=None,
                   shutdown_c: float = DEFAULT_SHUTDOWN_C,
                   device="cuda") -> DayReport:
    """Batched-user day for ONE (platform, design, schedule, policy)
    combo: users differ by battery age (capacity-fade fraction) and
    ambient-climate offset, and all of them run through one day-scan
    launch with N = the number of users.

    Age and climate touch only the battery/thermal constants and the
    ambient rows, never the scenario knobs, so the whole batch costs at
    most ONE row-stage pass through the row cache.  Per-user backend
    demand defaults to `n_users_backend=1.0` (one wearable per row)."""
    fades = np.atleast_1d(np.asarray(
        0.0 if fades is None else fades, np.float64))
    offs = np.atleast_1d(np.asarray(
        0.0 if ambient_offsets_c is None else ambient_offsets_c,
        np.float64))
    n = max(fades.size, offs.size)
    fades = np.broadcast_to(fades, (n,))
    offs = np.broadcast_to(offs, (n,))
    dev = _device.resolve(device)
    plat = _plat(platform)
    sched = _resolve(schedule, get_schedule, DaySchedule)
    pol = _resolve(policy, get_policy, ThrottlePolicy)
    bat = _batteries_arg(battery, plat.name)
    therm = thermal or DEFAULT_THERMAL
    puck = puck_for(plat)
    combos = [_Combo(plat, design, sched.with_ambient_offset(float(o)),
                     pol, bat.aged(float(f)), therm, puck)
              for f, o in zip(fades, offs)]
    _compile_platform(plat, combos, n_users_backend, theta, results_dir,
                      dev)
    summ = _scan_legacy(combos, dt_s, standby_mw, shutdown_c, dev)
    labels = []
    for cb, o in zip(combos, offs):
        lb = cb.label()
        lb["ambient_offset_c"] = round(float(o), 2)
        labels.append(lb)
    return DayReport(
        combos=labels,
        steady_mw=np.asarray([cb.steady_mw for cb in combos]),
        n_users=n_users_backend, dt_s=dt_s, skipped=[],
        battery_fade=np.asarray(fades, np.float64), **summ)


def compiled_tables(platform, design: dict, schedule, policy="none",
                    dt_s: float = DEFAULT_DT_S, n_users: float = 1e6,
                    standby_mw: float = DEFAULT_STANDBY_MW,
                    battery: BatterySpec | None = None,
                    thermal: ThermalSpec | None = None,
                    shutdown_c: float = DEFAULT_SHUTDOWN_C,
                    device="cuda") -> dict:
    """The per-step numpy tables of one combo (the legacy engine's,
    through the row cache) — the input `reference_integrate` takes."""
    plat = _plat(platform)
    cb = _Combo(plat, design, _resolve(schedule, get_schedule, DaySchedule),
                _resolve(policy, get_policy, ThrottlePolicy),
                _batteries_arg(battery, plat.name),
                thermal or DEFAULT_THERMAL, puck_for(plat))
    _compile_platform(plat, [cb], n_users, device=_device.resolve(device))
    return _combo_tables(cb, dt_s, cb.schedule.n_steps(dt_s),
                         cb.policy.n_levels, standby_mw, shutdown_c)


def scan_integrate(tb: dict, device="cuda") -> dict:
    """One combo's tables (`compiled_tables`' layout) through one
    full-trace day-scan launch on `device`: all 17 (T,) traces of the
    reference's `_step_math` as numpy."""
    batch = {k: np.asarray(tb[k], np.float32)[None]
             for k in (*_ds.TABLE_KEYS, *_ds.ROW_KEYS, "act_mult")}
    batch["const"] = {k: np.asarray(v, np.float32)[None]
                      for k, v in tb["const"].items()}
    ys = _scan_host(batch, _device.resolve(device), full=True)
    return {k: v[0] for k, v in ys.items()}


# ---------------------------------------------------------------------------
# the differentiable day: gradients from day objectives back to knobs
# ---------------------------------------------------------------------------
#
# The reference differentiates an XLA scan of `_step_math`; here it is an
# eager loop over T on any device (plain PyTorch, no kernel), autograd
# recording every step.  `kernels.day_scan.day_scan_plain` stays the
# kernel's forward-only test oracle and is not called here.

def _node_step(soc, t_soc, t_skin, p_mw, charge_mw, amb, pre, const):
    """One battery + thermal-RC Euler step for one node (`pre` prefixes
    the node's const keys: "" = glasses, "p_" = puck); the reference's
    operations in its order, with its max / min (an even gradient split
    at a tie, where a clamp would pass all of it)."""
    v = (const[pre + "v_full"] - const[pre + "sag_v"] * (1.0 - soc)
         - const[pre + "knee_v"]
         * torch.exp(-const[pre + "knee_sharp"] * soc))
    i_a = p_mw * 1e-3 / v
    loss_mw = i_a * i_a * const[pre + "r_ohm"] * 1e3
    drain_mw = p_mw + loss_mw
    soc_n = torch.minimum(torch.maximum(
        soc - drain_mw * const[pre + "dsoc_coeff"]
        + charge_mw * const[pre + "dsoc_coeff"], const["zero"]),
        const["one"])
    heat_w = drain_mw * 1e-3
    flow = (t_soc - t_skin) * const[pre + "g_soc_skin"]
    t_soc_n = t_soc + (heat_w - flow) * const[pre + "dt_c_soc"]
    t_skin_n = t_skin + (flow - (t_skin - amb)
                         * const[pre + "g_skin_amb"]) \
        * const[pre + "dt_c_skin"]
    return soc_n, t_soc_n, t_skin_n, drain_mw


def _step_math(carry, x, const):
    """One Euler step over BOTH nodes (glasses + optional puck), as the
    reference's `_step_math`.

    The throttle trip comparisons are straight-through estimators
    (`design.ste_gt` / `ste_lt`): forward values are the exact hard
    comparisons, the backward pass carries sigmoid surrogate gradients
    into the trip/clear thresholds.  The level tables go through
    `design.take_linear` (exact at the integer levels the forward
    produces, `table[l+1] - table[l]` as the level's gradient), all four
    in one call on `x["levels"]` ((4, L): mw, mw_p, pods, amult).  The
    thermal shutdown is a latched hard kill (no STE)."""
    (soc, soc_p, t_soc, t_skin, t_soc_p, t_skin_p,
     th_state, soc_state, shut) = carry

    # hysteresis triggers evaluate on the *previous* step's state
    trip_t = ste_gt(t_skin, const["temp_trip"], const["ste_beta_c"])
    clear_t = ste_lt(t_skin, const["temp_clear"], const["ste_beta_c"])
    th_state = trip_t + (1.0 - trip_t) * (1.0 - clear_t) * th_state
    soc_eff = torch.minimum(soc, soc_p)
    trip_s = ste_lt(soc_eff, const["soc_trip"], const["ste_beta_soc"])
    clear_s = ste_gt(soc_eff, const["soc_clear"], const["ste_beta_soc"])
    soc_state = trip_s + (1.0 - trip_s) * (1.0 - clear_s) * soc_state
    level_f = torch.minimum(th_state + soc_state, const["max_level"])

    # thermal shutdown: latched hard kill; EITHER node overheating
    # bricks the device
    dt = soc.dtype
    shut = torch.maximum(shut, (t_skin > const["shutdown_c"]).to(dt))
    shut = torch.maximum(shut, (t_skin_p > const["shutdown_c"]).to(dt)
                         * const["has_puck"])

    alive = ((soc > 0.0).to(dt) * (soc_p > 0.0).to(dt)
             * (1.0 - shut) * x["valid"])
    mw_l, mw_p_l, pods_l, amult_l = take_linear(x["levels"],
                                                level_f).unbind(0)
    act = x["active"] * amult_l
    p_mw = (act * mw_l + (1.0 - act) * const["standby_mw"]) * alive
    p_p_mw = (act * mw_p_l + (1.0 - act) * const["p_standby_mw"]) \
        * alive * const["has_puck"]

    soc_n, t_soc_n, t_skin_n, drain_mw = _node_step(
        soc, t_soc, t_skin, p_mw, x["charge"], x["amb"], "", const)
    soc_p_n, t_soc_p_n, t_skin_p_n, drain_p_mw = _node_step(
        soc_p, t_soc_p, t_skin_p, p_p_mw, x["charge_p"], x["amb"],
        "p_", const)

    pods = act * pods_l * alive
    new = (soc_n, soc_p_n, t_soc_n, t_skin_n, t_soc_p_n, t_skin_p_n,
           th_state, soc_state, shut)
    out = {"soc": soc_n, "soc_p": soc_p_n, "t_soc": t_soc_n,
           "t_skin": t_skin_n, "t_soc_p": t_soc_p_n,
           "t_skin_p": t_skin_p_n,
           "level": torch.round(level_f).to(torch.int32),
           "th_state": th_state, "soc_state": soc_state, "shut": shut,
           "p_mw": p_mw, "p_p_mw": p_p_mw, "drain_mw": drain_mw,
           "drain_p_mw": drain_p_mw, "pods": pods,
           "act": act, "alive": alive}
    return new, out


def _integrate_one(tb: dict) -> dict:
    """Whole-day loop for one combo: {name: (T,)} traces of all 17
    `_step_math` outputs.  Autograd-friendly: each step reads its rows
    through one `unbind` per table, the outputs are collected in lists
    and stacked at the end, and nothing autograd saves is written in
    place."""
    amb_rows = tb["ambient"].unbind(0)
    amb0 = amb_rows[0]
    one = torch.ones_like(amb0)
    zero = torch.zeros_like(amb0)
    const = {**tb["const"], "one": one, "zero": zero}
    carry = (one, one, amb0, amb0, amb0, amb0, zero, zero, zero)
    n_steps, n_lvl = tb["step_mw"].shape
    levels = torch.stack([tb["step_mw"], tb["step_mw_p"], tb["step_pods"],
                          tb["act_mult"].expand(n_steps, n_lvl)], dim=1)
    rows = {"levels": levels.unbind(0), "amb": amb_rows,
            **{k: tb[k].unbind(0) for k in ("active", "charge",
                                             "charge_p", "valid")}}
    outs = []
    for t in range(n_steps):
        carry, out = _step_math(carry, {k: v[t] for k, v in rows.items()},
                                const)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _hard_logits(design_row: dict, primitives: tuple, device="cuda",
                 dtype=torch.float32):
    """A design's placement as saturated logits (sigmoid ~ 0/1)."""
    on = set(design_row.get("on_device", ()))
    return torch.tensor([LOGIT_HI if p in on else -LOGIT_HI
                         for p in primitives], dtype=dtype,
                        device=_device.resolve(device))


def relaxed_day_fn(platform, schedule, policy, design_row=None, *,
                   dt_s: float = 30.0, n_users: float = 1e6,
                   standby_mw: float = DEFAULT_STANDBY_MW,
                   battery: BatterySpec | None = None,
                   thermal: ThermalSpec | None = None, theta=None,
                   results_dir=None,
                   tau: float = 1.0,
                   shutdown_c: float = DEFAULT_SHUTDOWN_C,
                   ste_beta_c: float = STE_BETA_C,
                   ste_beta_soc: float = STE_BETA_SOC,
                   soft_alive_margin: float = 0.03,
                   soft_alive_beta: float = 80.0,
                   device="cuda", dtype=torch.float32):
    """Build `f(point) -> outputs`, differentiable end to end, on
    `device` in float width `dtype`.

    `point` is a DesignSpace point that may carry any subset of
    `design.device_space` leaves (placement_logits, log2_compression,
    log2_fps_scale, upload_duty — the latter scales every segment's
    VAD gating) and/or `design.policy_space` leaves (temp_trip_c,
    temp_band_c, soc_trip, soc_band); leaves not present fall back to
    the static `design_row` dict / `policy` thresholds.  For every
    throttle level the ThrottleAction multipliers compose with the
    relaxed knobs, the per-(level, segment) power tables come from the
    relaxed engine *inside the same graph*, and the whole day
    integrates through `_integrate_one`, whose trip comparisons are
    straight-through, so autograd reaches both the design knobs (via
    the tables) and the policy thresholds (via the STE surrogates).
    `f` takes one point (0-dim leaves); `torch.func.vmap` maps it over
    restarts (`dse.gradient_descend`).

    Outputs: `soft_tte_h` (smoothly-alive hours: the sum of
    sigmoid((soc - margin) * beta) over steps — the maximization
    surrogate), `tte_h` / `peak_skin_c` / `pod_hours` / `end_soc` /
    `end_soc_puck` / `throttled_frac` (hard values off the same traces,
    for reporting), plus the raw `t_skin` / `soc` traces."""
    dev = _device.resolve(device)
    plat = _plat(platform)
    sched = _resolve(schedule, get_schedule, DaySchedule)
    pol = _resolve(policy, get_policy, ThrottlePolicy)
    bat = _batteries_arg(battery, plat.name)
    therm = thermal or DEFAULT_THERMAL
    puck = puck_for(plat)
    row = dict(design_row or DEFAULT_DESIGNS[0])
    n_lvl = pol.n_levels
    segs = sched.segments
    n_seg = len(segs)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=dev).to(dtype)

    # static per-segment / per-level data
    seg_steps = [max(1, round(s.hours * 3600.0 / dt_s)) for s in segs]
    seg_idx = torch.as_tensor(np.repeat(np.arange(n_seg), seg_steps),
                              device=dev)
    n_steps = int(seg_idx.shape[0])
    seg_duty = put([s.upload_duty for s in segs])
    seg_bright = put([s.brightness for s in segs])
    acts = [pol.action(lv) for lv in range(n_lvl)]
    fps_mult = put([a.fps_mult for a in acts])
    duty_mult = put([a.duty_mult for a in acts])
    bright_mult = put([a.brightness_mult for a in acts])
    act_mult = np.ones(n_lvl)
    for lv in range(1, n_lvl):
        act_mult[lv:] = acts[lv].active_mult
    keep_lv = put([0.0 if a.offload else 1.0 for a in acts])
    mcs_hot = put(np.eye(len(scenarios.MCS_TIERS))[
        int(row.get("mcs_tier", DEFAULT_MCS))])
    cap_g = bat.capacity_mwh
    cap_p = puck.battery.capacity_mwh if puck is not None else 0.0
    share_g = cap_g / (cap_g + cap_p) if cap_p else 1.0
    seg_charge = np.asarray([s.charge_mw for s in segs])
    static_const = {
        "max_level": float(n_lvl - 1), "standby_mw": standby_mw,
        "shutdown_c": shutdown_c,
        "ste_beta_c": ste_beta_c, "ste_beta_soc": ste_beta_soc,
        "has_puck": 1.0 if puck is not None else 0.0,
        "p_standby_mw": puck.standby_mw if puck is not None else 0.0,
        **_battery_const(bat, therm, dt_s),
        **_battery_const(puck.battery if puck is not None else bat,
                         puck.thermal if puck is not None else therm,
                         dt_s, "p_"),
    }
    const0 = {k: put(v) for k, v in static_const.items()}
    steps = {
        "ambient": put([s.ambient_c for s in segs])[seg_idx],
        "active": put([s.active for s in segs])[seg_idx],
        "valid": torch.ones(n_steps, dtype=dtype, device=dev),
        "charge": put(seg_charge * share_g)[seg_idx],
        "charge_p": put(seg_charge * (1.0 - share_g))[seg_idx],
        "act_mult": put(act_mult),
    }
    policy0 = {"temp_trip_c": put(pol.temp_trip_c),
               "temp_band_c": put(pol.temp_trip_c - pol.temp_clear_c),
               "soc_trip": put(pol.soc_trip),
               "soc_band": put(pol.soc_clear - pol.soc_trip)}
    logits0 = _hard_logits(row, plat.primitives, dev, dtype)
    comp0 = put(float(row.get("compression", 10.0)))
    fps0 = put(float(row.get("fps_scale", 1.0)))
    th = scenarios._theta_relaxed(plat, theta, dev, dtype)
    engine = scenarios._engine_relaxed(plat)
    n_rows = n_lvl * n_seg
    h = dt_s / 3600.0

    def f(point: dict) -> dict:
        pl = placement_probs(point.get("placement_logits", logits0),
                                    tau)                    # (n_prim,)
        comp = (2.0 ** point["log2_compression"]
                if "log2_compression" in point else comp0)
        fps = (2.0 ** point["log2_fps_scale"]
               if "log2_fps_scale" in point else fps0)
        # (L, S) knob rows: ThrottleAction multipliers compose smoothly
        pl_rows = pl[None, :] * keep_lv[:, None]
        vec = {
            "placement": pl_rows[:, None, :].expand(
                n_lvl, n_seg, pl.shape[-1]).reshape(n_rows, -1),
            "compression": comp.expand(n_rows),
            "fps_scale": (fps * fps_mult[:, None]
                          * torch.ones_like(seg_duty)[None, :]
                          ).reshape(-1),
            "upload_duty": (point.get("upload_duty", 1.0)
                            * seg_duty[None, :]
                            * duty_mult[:, None]).reshape(-1),
            "brightness": (seg_bright[None, :]
                           * bright_mult[:, None]).reshape(-1),
            "mcs_weights": mcs_hot.expand(n_rows, mcs_hot.shape[0]),
        }
        out = engine(vec, th)
        totals = out["total"].reshape(n_lvl, n_seg)
        mbps = out["mbps"].reshape(n_lvl, n_seg)
        mw_p = (puck.level_mw(mbps) if puck is not None
                else torch.zeros_like(totals))
        # smooth backend fleet demand for the same rows (duty=1.0 as the
        # hard path's level tables)
        pods_rows = offload.pods_relaxed(
            vec, n_users=n_users, duty=1.0, results_dir=results_dir,
            primitives=plat.primitives).reshape(n_lvl, n_seg)
        trip_t = point.get("temp_trip_c", policy0["temp_trip_c"])
        trip_s = point.get("soc_trip", policy0["soc_trip"])
        tb = {
            "step_mw": totals.t()[seg_idx],             # (T, L)
            "step_mw_p": mw_p.t()[seg_idx],
            "step_pods": pods_rows.t()[seg_idx],
            **steps,
            "const": {
                **const0,
                "temp_trip": trip_t,
                "temp_clear": trip_t - point.get("temp_band_c",
                                                 policy0["temp_band_c"]),
                "soc_trip": trip_s,
                "soc_clear": trip_s + point.get("soc_band",
                                                policy0["soc_band"]),
            },
        }
        ys = _integrate_one(tb)
        soc_eff = torch.minimum(ys["soc"], ys["soc_p"])
        soft_alive = soft_indicator(soc_eff, soft_alive_margin,
                                           soft_alive_beta)
        dead = ((soc_eff <= 0.0) | (ys["shut"] > 0.5)).to(soc_eff.dtype)
        # the first dead step (argmax takes the first maximum); no dead
        # step gives the day's n_steps
        first = torch.argmax(dead).to(soc_eff.dtype) + 1.0
        tte_h = torch.where(torch.any(dead > 0.0), first,
                            torch.full_like(first, float(n_steps))) * h
        return {
            "soft_tte_h": torch.sum(soft_alive) * h,
            "tte_h": tte_h,
            "peak_skin_c": torch.max(ys["t_skin"]),
            "pod_hours": torch.sum(ys["pods"]) * h,
            "end_soc": ys["soc"][-1],
            "end_soc_puck": ys["soc_p"][-1],
            "throttled_frac": torch.mean((ys["level"] > 0)
                                         .to(soc_eff.dtype)),
            "t_skin": ys["t_skin"],
            "soc": ys["soc"],
        }

    return f
