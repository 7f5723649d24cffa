"""Fleet-scale population simulator: a whole population's day on one card.

Everything below `daysim` models one device's day.  This module lifts it
to the service: a `PopulationSpec` declares usage archetypes (mixtures
over registered `DaySchedule`s with a platform SKU, design, throttle
policy, wake hour, ambient-climate offset range and battery-age
capacity-fade range) plus a timezone distribution; `sample_population`
draws N users from it with explicit seeded generators (no global RNG
state: the same key gives the same fleet on any device); and
`fleet_day` integrates every user's day through the day-scan kernel:

  * per-archetype power/pod tables are compiled once through the row
    cache (`daysim._compile_platform`, the row stage on the device) and
    held on the device in the kernel's time-major layout
    (`prepare_fleet`);
  * users run in chunks of at most `CHUNK_USERS`, one full-trace
    day-scan launch per chunk and day: each chunk gathers its users'
    archetype tables, adds their climate offsets to the ambient rows,
    and sets their age-derated dSoC coefficients; the kernel advances
    the same `_step_math` dynamics per user as the single-device day, so
    fleet dynamics equal `daysim`'s bit for bit;
  * after each launch the (T, N) traces reduce on the device to per-user
    survival, peak skin and pod-hours, and to the per-stream backend
    load: every user's pods at its throttle level, summed in float64 per
    distinct (wake - timezone) offset;
  * the host folds those (T, J) sums into UTC hour-of-day bins in
    float64.

The reference accumulates the curve in float32 with Kahan compensation
inside its scan; the port sums in float64, which stays within the
reference's own 1e-6 budget against its float64 oracle.  No atomics:
every sum runs in a fixed order, so a run repeats its own bits, and
per-user outputs do not depend on the chunk size or on a user's place in
a chunk (users are ordered by offset before chunking, and unordered
after).

The reference shards users over a `users` mesh with `shard_map`; the
port runs on one card, where a mesh of size 1 is the identity, so
`n_shards` must be None or 1.  `FLEET_STATS["traces"]` stays 0: the port
compiles no program to trace.

`reference_fleet` is the per-user oracle (a loop over
`daysim.reference_integrate`), binned in float64.

Multi-day horizons: `fleet_day(n_days=...)` carries each user's SoC
between days with the overnight dock top-up (the kernel's initial-SoC
input), while thermal state, throttle latches and the shutdown latch
reset each morning.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import device as _device
from ..kernels import day_scan as _ds
from . import daysim, offload
from .daysim import (DaySchedule, STREAMS, ThrottlePolicy, battery_for,
                     get_policy, get_schedule, puck_for)

DEFAULT_N_BINS = 24

# kept for callers of the reference's counter: the port traces nothing
FLEET_STATS = {"traces": 0}

# overnight dock power (mW) for multi-day horizons: a 0.5 A / 5 V phone
# charger, enough to fully recharge the shipped SKUs overnight
DEFAULT_OVERNIGHT_MW = 2500.0

# users per day-scan launch: at T = 720, L = 3 a user's tables, traces
# and curve terms take ~130 KB on the device, so a chunk peaks near 2 GB
CHUNK_USERS = 16384


# ---------------------------------------------------------------------------
# declarative population: archetypes x climates x timezones x battery ages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchetypeSpec:
    """One usage archetype: who wears what, and how their days run.

    `weight` is the mixture probability (normalized across the
    population's archetypes).  `ambient_offset_c` and `fade` are
    (lo, hi) uniform sampling ranges: the climate offset shifts every
    segment's ambient temperature, the capacity-fade fraction derates
    the platform's battery for aged devices.  `wake_hour` anchors the
    schedule's first segment in local time, so the timezone shift knows
    where the user's day sits in UTC."""
    name: str
    weight: float
    platform: str
    design: dict
    schedule: str | DaySchedule
    policy: str | ThrottlePolicy = "none"
    wake_hour: float = 7.0
    ambient_offset_c: tuple = (0.0, 0.0)
    fade: tuple = (0.0, 0.0)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"archetype {self.name!r}: weight must "
                             f"be > 0, got {self.weight}")
        lo, hi = self.ambient_offset_c
        if lo > hi:
            raise ValueError(f"archetype {self.name!r}: "
                             f"ambient_offset_c lo > hi")
        flo, fhi = self.fade
        if not (0.0 <= flo <= fhi < 1.0):
            raise ValueError(f"archetype {self.name!r}: fade range "
                             f"({flo}, {fhi}) outside [0, 1)")
        if not 0.0 <= self.wake_hour < 24.0:
            raise ValueError(f"archetype {self.name!r}: wake_hour "
                             f"{self.wake_hour} outside [0, 24)")

    def resolve_schedule(self) -> DaySchedule:
        return daysim._resolve(self.schedule, get_schedule, DaySchedule)

    def resolve_policy(self) -> ThrottlePolicy:
        return daysim._resolve(self.policy, get_policy, ThrottlePolicy)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "weight": self.weight,
            "platform": self.platform,
            "design": {**self.design,
                       "on_device": list(self.design.get("on_device", ()))},
            "schedule": (self.schedule if isinstance(self.schedule, str)
                         else self.schedule.to_dict()),
            "policy": (self.policy if isinstance(self.policy, str)
                       else self.policy.to_dict()),
            "wake_hour": self.wake_hour,
            "ambient_offset_c": list(self.ambient_offset_c),
            "fade": list(self.fade),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ArchetypeSpec":
        design_row = dict(d["design"])
        design_row["on_device"] = tuple(design_row.get("on_device", ()))
        sched = d["schedule"]
        if not isinstance(sched, str):
            sched = DaySchedule.from_dict(sched)
        pol = d.get("policy", "none")
        if not isinstance(pol, str):
            pol = ThrottlePolicy.from_dict(pol)
        return cls(d["name"], float(d["weight"]), d["platform"],
                   design_row, sched, pol,
                   float(d.get("wake_hour", 7.0)),
                   tuple(d.get("ambient_offset_c", (0.0, 0.0))),
                   tuple(d.get("fade", (0.0, 0.0))))


@dataclass(frozen=True)
class PopulationSpec:
    """A whole user population as declarative, JSON round-trip data:
    archetype mixture plus the timezone distribution that spreads their
    days around the clock (UTC offsets in hours, categorical weights)."""
    name: str
    archetypes: tuple
    tz_hours: tuple = (0.0,)
    tz_weights: tuple | None = None

    def __post_init__(self):
        if not self.archetypes:
            raise ValueError("population needs at least one archetype")
        if not self.tz_hours:
            raise ValueError("population needs at least one timezone")
        w = self.tz_weights
        if w is not None:
            if len(w) != len(self.tz_hours):
                raise ValueError(
                    f"tz_weights has {len(w)} entries for "
                    f"{len(self.tz_hours)} tz_hours")
            if any(x < 0 for x in w) or sum(w) <= 0:
                raise ValueError("tz_weights must be >= 0 and sum > 0")

    @property
    def n_archetypes(self) -> int:
        return len(self.archetypes)

    def weights(self) -> np.ndarray:
        w = np.asarray([a.weight for a in self.archetypes], np.float64)
        return w / w.sum()

    def tz_probs(self) -> np.ndarray:
        if self.tz_weights is None:
            return np.full(len(self.tz_hours), 1.0 / len(self.tz_hours))
        w = np.asarray(self.tz_weights, np.float64)
        return w / w.sum()

    def with_overrides(self, name: str, policy=None,
                       design: dict | None = None) -> "PopulationSpec":
        """A variant population: the same archetype mixture with a
        fleet-wide policy and/or design swap.  A design whose placement
        an archetype's platform cannot run on-device keeps that
        archetype's original design instead of failing the variant."""
        archs = []
        for a in self.archetypes:
            d = a.design
            if design is not None:
                plat = daysim._plat(a.platform)
                if set(design.get("on_device", ())) \
                        <= set(plat.supported_primitives()):
                    d = design
            archs.append(replace(a, design=d,
                                 policy=policy if policy is not None
                                 else a.policy))
        return PopulationSpec(name, tuple(archs), self.tz_hours,
                              self.tz_weights)

    def to_dict(self) -> dict:
        out = {"name": self.name,
               "archetypes": [a.to_dict() for a in self.archetypes],
               "tz_hours": list(self.tz_hours)}
        if self.tz_weights is not None:
            out["tz_weights"] = list(self.tz_weights)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "PopulationSpec":
        return cls(d["name"],
                   tuple(ArchetypeSpec.from_dict(a)
                         for a in d["archetypes"]),
                   tuple(d.get("tz_hours", (0.0,))),
                   tuple(d["tz_weights"]) if "tz_weights" in d else None)


# a world-ish default: four archetypes over the shipped SKUs/schedules,
# timezones weighted roughly by population (Americas / Europe-Africa /
# South Asia / East Asia-Pacific)
DEFAULT_POPULATION = PopulationSpec(
    "world_mix",
    archetypes=(
        ArchetypeSpec("commuter_display", 0.35, "aria2_display",
                      daysim.DEFAULT_DESIGNS[1], "commuter_dock",
                      "thermal_governor", wake_hour=7.0,
                      ambient_offset_c=(-4.0, 6.0), fade=(0.0, 0.25)),
        ArchetypeSpec("desk_lite", 0.30, "rayban_cam",
                      daysim.DEFAULT_DESIGNS[0], "commuter_dock",
                      "battery_saver", wake_hour=8.5,
                      ambient_offset_c=(-2.0, 3.0), fade=(0.0, 0.3)),
        ArchetypeSpec("field_worker", 0.15, "aria2_puck_split",
                      daysim.DEFAULT_DESIGNS[1], "field_day",
                      "battery_saver", wake_hour=6.0,
                      ambient_offset_c=(-2.0, 5.0), fade=(0.05, 0.3)),
        ArchetypeSpec("power_user", 0.20, "aria2_display",
                      daysim.DEFAULT_DESIGNS[2], "commuter",
                      "battery_saver", wake_hour=7.5,
                      ambient_offset_c=(-3.0, 4.0), fade=(0.0, 0.15)),
    ),
    tz_hours=(-8.0, -5.0, -3.0, 0.0, 1.0, 3.0, 5.5, 8.0, 9.0),
    tz_weights=(0.07, 0.12, 0.05, 0.10, 0.14, 0.06, 0.20, 0.18, 0.08),
)


# ---------------------------------------------------------------------------
# sampling: spec -> struct-of-arrays population (explicit seeded draws)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Population:
    """A sampled fleet (struct of arrays, leading dim N).  Sampling is a
    pure function of (spec, n, key) on the host, so the same key yields
    the identical fleet on any device."""
    spec: PopulationSpec
    archetype: np.ndarray           # (N,) int32 index into spec.archetypes
    tz_hours: np.ndarray            # (N,) UTC offset of the user's locale
    ambient_offset_c: np.ndarray    # (N,) climate shift on every segment
    fade: np.ndarray                # (N,) battery capacity-fade fraction

    def __len__(self) -> int:
        return int(self.archetype.shape[0])

    def counts(self) -> dict:
        c = np.bincount(self.archetype, minlength=self.spec.n_archetypes)
        return {a.name: int(k) for a, k in zip(self.spec.archetypes, c)}

    def take(self, idx) -> "Population":
        """Sub-population at integer indices (parity checks, benches)."""
        idx = np.asarray(idx)
        return Population(self.spec, self.archetype[idx],
                          self.tz_hours[idx],
                          self.ambient_offset_c[idx], self.fade[idx])


def split_seed(key, n: int) -> list:
    """`n` integer seeds derived from the integer `key` by one seeded CPU
    generator: the same key always gives the same seeds."""
    if isinstance(key, bool) or not isinstance(key, (int, np.integer)):
        raise TypeError(f"key must be an int seed, got "
                        f"{type(key).__name__}")
    g = torch.Generator().manual_seed(int(key))
    return torch.randint(0, 2 ** 62, (n,), generator=g).tolist()


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def sample_population(spec: PopulationSpec, n: int, key) -> Population:
    """Draw N users from the spec with one integer `key`.

    The reference splits a threefry key four ways (archetype, timezone,
    climate offset, battery age); threefry cannot be reproduced here, so
    each field draws from its own seeded CPU `torch.Generator`, the four
    seeds split from `key` (`split_seed`).  No global RNG state is read,
    so populations are reproducible on any device; their distribution,
    not their values, matches the reference's."""
    if n <= 0:
        raise ValueError(f"n must be > 0, got {n}")
    k_arch, k_tz, k_amb, k_fade = (_generator(s)
                                   for s in split_seed(key, 4))
    arch = torch.multinomial(torch.as_tensor(spec.weights()), n,
                             replacement=True, generator=k_arch)
    arch = arch.numpy().astype(np.int32)
    tz_idx = torch.multinomial(torch.as_tensor(spec.tz_probs()), n,
                               replacement=True, generator=k_tz).numpy()
    tz = np.asarray(spec.tz_hours, np.float64)[tz_idx]
    lo = np.asarray([a.ambient_offset_c[0] for a in spec.archetypes])
    hi = np.asarray([a.ambient_offset_c[1] for a in spec.archetypes])
    u = torch.rand(n, generator=k_amb, dtype=torch.float64).numpy()
    amb = lo[arch] + u * (hi - lo)[arch]
    flo = np.asarray([a.fade[0] for a in spec.archetypes])
    fhi = np.asarray([a.fade[1] for a in spec.archetypes])
    v = torch.rand(n, generator=k_fade, dtype=torch.float64).numpy()
    fade = flo[arch] + v * (fhi - flo)[arch]
    return Population(spec, arch, tz, amb, fade)


# ---------------------------------------------------------------------------
# archetype compilation: per-archetype step tables via the daysim engine
# ---------------------------------------------------------------------------

def _archetype_combos(spec: PopulationSpec, theta=None, results_dir=None,
                      device="cuda") -> list:
    """One compiled `daysim._Combo` per archetype (nominal battery; the
    per-user age derating goes into each user's constants).  Pod tables
    are sized for ONE user (`n_users=1`), so fleet demand aggregates
    user by user into the load curve."""
    dev = _device.resolve(device)
    combos = []
    by_plat: dict = {}
    for a in spec.archetypes:
        plat = daysim._plat(a.platform)
        if not set(a.design.get("on_device", ())) \
                <= set(plat.supported_primitives()):
            raise ValueError(
                f"archetype {a.name!r}: design "
                f"{a.design.get('name', '')!r} places "
                f"{sorted(a.design['on_device'])} on-device but "
                f"{plat.name} supports {plat.supported_primitives()}")
        cb = daysim._Combo(plat, a.design, a.resolve_schedule(),
                           a.resolve_policy(), battery_for(plat.name),
                           daysim.DEFAULT_THERMAL, puck_for(plat))
        by_plat.setdefault(plat.name, (plat, []))[1].append(cb)
        combos.append(cb)
    for plat, cbs in by_plat.values():
        daysim._compile_platform(plat, cbs, 1.0, theta, results_dir, dev)
    return combos


def _stack_archetype_tables(combos: list, dt_s: float, standby_mw: float,
                            shutdown_c: float) -> tuple:
    """(xs, tbs): the archetypes' step tables side by side in the day
    scan's time-major layout (numpy) — step_mw / step_mw_p / step_pods
    (T, L, A), pods_stream (T, L, A, S), the step rows (T, A), act_mult
    (L, A) — plus the per-archetype daysim tables they were built
    from."""
    n_steps = max(cb.schedule.n_steps(dt_s) for cb in combos)
    max_levels = max(cb.policy.n_levels for cb in combos)
    tbs = [daysim._combo_tables(cb, dt_s, n_steps, max_levels,
                                standby_mw, shutdown_c)
           for cb in combos]
    xs = {k: np.stack([tb[k] for tb in tbs], axis=2)
          for k in _ds.TABLE_KEYS}
    xs["pods_stream"] = np.stack([tb["step_pods_stream"] for tb in tbs],
                                 axis=2)
    xs.update({k: np.stack([tb[k] for tb in tbs], axis=1)
               for k in _ds.ROW_KEYS})
    xs["act_mult"] = np.stack([tb["act_mult"] for tb in tbs], axis=1)
    return xs, tbs


def _offsets(spec: PopulationSpec) -> tuple:
    """(wake hours (A,), the distinct (wake - tz) mod 24 offsets (J,)) of
    every archetype x timezone of the spec, float64: the offset table
    does not depend on which of them a draw happens to sample."""
    wake_a = np.asarray([a.wake_hour for a in spec.archetypes],
                        np.float64)
    tz_a = np.asarray(spec.tz_hours, np.float64)
    return wake_a, np.unique(np.mod(wake_a[:, None] - tz_a[None, :], 24.0))


def _bin_index(uniq: np.ndarray, dt_s: float, n_steps: int,
               n_bins: int) -> np.ndarray:
    """(T, J) int32 UTC hour-of-day bin of each step at each offset."""
    t_h = np.arange(n_steps, dtype=np.float64) * (dt_s / 3600.0)
    return np.floor(np.mod(t_h[:, None] + uniq[None, :], 24.0)
                    * (n_bins / 24.0)).astype(np.int32)


def _user_offsets(uniq, wake_a, pop: Population) -> np.ndarray:
    # exact match: the same float64 subtraction the table was built
    # from, so searchsorted lands on the entry itself
    return np.searchsorted(uniq, np.mod(wake_a[pop.archetype]
                                        - pop.tz_hours, 24.0)
                           ).astype(np.int32)


def _bin_tables(spec: PopulationSpec, pop: Population, dt_s: float,
                n_steps: int, n_bins: int) -> tuple:
    """UTC hour-of-day bin index per (step, distinct offset) and each
    user's offset index: binning is a pure function of (wake_hour - tz),
    which takes a handful of values, so the host computes the (T, J)
    table once in float64 and every path indexes the same integers."""
    wake_a, uniq = _offsets(spec)
    return (_bin_index(uniq, dt_s, n_steps, n_bins),
            _user_offsets(uniq, wake_a, pop))


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclass
class FleetReport:
    """One simulated fleet horizon (a day by default).  `curve` is the
    diurnal backend load — average pods active per UTC hour-of-day bin,
    per stream (in `streams` order), averaged across horizon days and
    scaled to `fleet_size` users, so ``curve_total.sum() * bin_hours``
    is pod-hours per day.  `stream_curve` is the matching average count
    of concurrently-live streams per bin.  Per-user arrays share the
    population's leading dim N; for `n_days > 1`, `time_to_empty_h`
    counts worn hours until the first death and `shutdown` flags a
    thermal hard-kill on any day.  `device` is where the fleet ran, and
    where `capacity_plan` runs the autoscaler."""
    population: Population
    streams: tuple
    curve: np.ndarray               # (n_bins, S)
    dt_s: float
    fleet_size: float
    day_hours: np.ndarray           # (N,) whole-horizon worn hours
    time_to_empty_h: np.ndarray     # (N,)
    peak_skin_c: np.ndarray         # (N,)
    end_soc: np.ndarray             # (N,)
    shutdown: np.ndarray            # (N,) bool
    pod_hours: np.ndarray           # (N,) per-user backend demand
    skin_limit_c: float = 43.0
    n_shards: int = 1
    stream_curve: np.ndarray | None = None   # (n_bins, S)
    n_days: int = 1
    device: str = "cuda"

    def __len__(self) -> int:
        return len(self.population)

    @property
    def curve_total(self) -> np.ndarray:
        """(n_bins,) pods-vs-hour-of-day summed over streams."""
        return self.curve.sum(axis=1)

    @property
    def stream_curve_total(self) -> np.ndarray | None:
        """(n_bins,) concurrently-live streams, summed over kinds."""
        return (None if self.stream_curve is None
                else self.stream_curve.sum(axis=1))

    def survives(self) -> np.ndarray:
        """(N,) bool, the `DayReport.survives` contract: full day on one
        charge, no thermal shutdown, skin under the comfort cap."""
        return ((self.time_to_empty_h >= self.day_hours - 1e-9)
                & (self.peak_skin_c <= self.skin_limit_c)
                & ~self.shutdown)

    def survival_rate(self) -> float:
        return float(self.survives().mean())

    def tte_quantiles(self, qs=(0.05, 0.25, 0.5, 0.75, 0.95)) -> dict:
        v = np.quantile(self.time_to_empty_h, qs)
        return {f"p{int(100 * q)}": round(float(x), 2)
                for q, x in zip(qs, v)}

    def by_archetype(self) -> list:
        """Per-archetype survival statistics: shutdown counts and
        time-to-empty quantiles."""
        surv = self.survives()
        rows = []
        for i, a in enumerate(self.population.spec.archetypes):
            m = self.population.archetype == i
            if not m.any():
                continue
            rows.append({
                "archetype": a.name, "users": int(m.sum()),
                "survival_rate": round(float(surv[m].mean()), 4),
                "shutdowns": int(self.shutdown[m].sum()),
                "tte_p5_h": round(float(np.quantile(
                    self.time_to_empty_h[m], 0.05)), 2),
                "tte_p50_h": round(float(np.quantile(
                    self.time_to_empty_h[m], 0.50)), 2),
                "mean_fade": round(float(self.population.fade[m].mean()),
                                   3),
            })
        return rows

    def capacity_plan(self, autoscaler=None) -> dict:
        """Autoscaled vs peak-provisioned pricing of the diurnal curve
        (`offload.curve_cost`), plus fleet survival headlines.  With an
        `autoscale.AutoscalerSpec` it also prices the lagging fleet and
        its dropped stream-hours, on the report's device."""
        out = offload.curve_cost(self.curve_total,
                                 bin_hours=24.0 / self.curve.shape[0],
                                 autoscaler=autoscaler,
                                 stream_curve=self.stream_curve_total,
                                 device=self.device)
        out["fleet_size"] = self.fleet_size
        out["survival_rate"] = round(self.survival_rate(), 4)
        out["tte_quantiles_h"] = self.tte_quantiles()
        out["shutdowns"] = int(self.shutdown.sum())
        return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@dataclass
class FleetPrep:
    """Spec-derived half of a fleet day, hoisted out of the per-draw
    loop: archetype combos, the archetypes' tables in the day scan's
    time-major layout resident on `device`, the (T, J) bin table, and the
    per-archetype constants per-user gathers index into.  A pure function
    of (spec, dt_s, n_bins, standby_mw, shutdown_c, theta, results_dir,
    device)."""
    spec: PopulationSpec
    dt_s: float
    n_bins: int
    standby_mw: float
    shutdown_c: float
    combos: list
    xs_dev: dict                # archetype tables on `device`
    n_steps: int
    uniq: np.ndarray            # (J,) distinct wake-tz offsets, f64
    wake_a: np.ndarray          # (A,) archetype wake hours, f64
    bins: np.ndarray            # (T, J) int32 UTC bin of each step
    const_a: dict               # (A,) scan constants per archetype
    cap_a: np.ndarray           # (A,) glasses capacity mwh, f64
    cap_p_a: np.ndarray         # (A,) puck (or glasses) capacity, f64
    day_steps_a: np.ndarray     # (A,) worn steps per day, f64
    amult: np.ndarray           # (A, L) active multiplier ladder
    device: torch.device


def prepare_fleet(spec: PopulationSpec, *, dt_s: float = 60.0,
                  n_bins: int = DEFAULT_N_BINS,
                  standby_mw: float = daysim.DEFAULT_STANDBY_MW,
                  shutdown_c: float = daysim.DEFAULT_SHUTDOWN_C,
                  theta=None, results_dir=None,
                  device="cuda") -> FleetPrep:
    """Build the population-independent `FleetPrep` for `fleet_day` on
    `device`; `fleet_day(pop, prep=prep)` gives the same bits as
    `fleet_day(pop)` with matching arguments."""
    dev = _device.resolve(device)
    combos = _archetype_combos(spec, theta, results_dir, dev)
    xs, tbs = _stack_archetype_tables(combos, dt_s, standby_mw,
                                      shutdown_c)
    n_steps = xs["step_mw"].shape[0]
    wake_a, uniq = _offsets(spec)
    const_a = {k: np.asarray([tb["const"][k] for tb in tbs], np.float32)
               for k in tbs[0]["const"]}
    t, n_lvl, n_arch, n_streams = xs["pods_stream"].shape
    xs_dev = {k: daysim._put(v, dev) for k, v in xs.items()}
    # (T, L * A, S): one gather at level * A + archetype reads a user's
    # per-stream pods
    xs_dev["pods_stream"] = xs_dev["pods_stream"].reshape(
        t, n_lvl * n_arch, n_streams)
    xs_dev["const"] = daysim._put(
        np.stack([const_a[k] for k in _ds.CONST_KEYS]), dev)
    return FleetPrep(
        spec=spec, dt_s=dt_s, n_bins=n_bins, standby_mw=standby_mw,
        shutdown_c=shutdown_c, combos=combos, xs_dev=xs_dev,
        n_steps=n_steps, uniq=uniq, wake_a=wake_a,
        bins=_bin_index(uniq, dt_s, n_steps, n_bins), const_a=const_a,
        cap_a=np.asarray([cb.battery.capacity_mwh for cb in combos],
                         np.float64),
        cap_p_a=np.asarray(
            [cb.puck.battery.capacity_mwh if cb.puck is not None
             else cb.battery.capacity_mwh for cb in combos],
            np.float64),
        day_steps_a=np.asarray([tb["valid"].sum() for tb in tbs],
                               np.float64),
        amult=xs["act_mult"].T.copy(), device=dev)


def _chunk_tables(xs: dict, users: dict, sl: slice) -> dict:
    """The day scan's tables for the users `sl` of `users` (device
    tensors): archetype tables gathered to (T, L, n) / (T, n) / (L, n),
    the climate offset added to the ambient rows in float32, and each
    user's age-derated dSoC coefficient in the constants."""
    a = users["arch"][sl]
    out = {k: xs[k].index_select(-1, a)
           for k in (*_ds.TABLE_KEYS, *_ds.ROW_KEYS, "act_mult")}
    out["ambient"] = out["ambient"] + users["amb_off"][sl]
    const = dict(zip(_ds.CONST_KEYS, xs["const"].index_select(1, a)))
    const["dsoc_coeff"] = users["dsoc_coeff"][sl]
    out["const"] = const
    return out


def _run_chunk(prep: FleetPrep, users: dict, sl: slice, js: list,
               n_days: int, acc: torch.Tensor) -> dict:
    """One chunk of users through the horizon: one full-trace day-scan
    launch per day, each reduced on the device.  Adds the chunk's curve
    terms to `acc` ((T, J, 2, S) float64: pods and live streams per step
    and offset) over the offsets `js` = [(j, lo, hi)], the chunk-relative
    user range of each offset; returns the per-user reductions."""
    xs = prep.xs_dev
    tables = _chunk_tables(xs, users, sl)
    a = users["arch"][sl]
    n_arch = xs["const"].shape[1]
    t_steps = prep.n_steps
    dev = a.device
    step1 = torch.arange(1, t_steps + 1, device=dev,
                         dtype=torch.float64)[:, None]
    valid = tables["valid"] > 0.0
    dsteps = users["dsteps"][sl]
    n = a.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    first = torch.zeros(n, dtype=torch.float64, device=dev)
    peak = torch.full((n,), -torch.inf, device=dev)
    pod_steps = torch.zeros(n, dtype=torch.float64, device=dev)
    shut_any = torch.zeros(n, device=dev)
    start: dict = {}                    # day 0 starts on a full battery
    for d in range(n_days):
        ys = _ds.day_scan({**tables, **start}, full=True)
        y = {k: v.t() for k, v in ys.items()}           # (T, n)
        dead = (torch.minimum(y["soc"], y["soc_p"]) <= 0.0) \
            | (y["shut"] > 0.5)
        # death times count worn steps: day d starts at d * (that user's
        # worn steps), not at the padded T
        hit_d = dead.any(0)
        first_d = torch.where(dead, step1, torch.inf).amin(0)
        first = torch.where(~hit & hit_d, dsteps * d + first_d, first)
        hit = hit | hit_d
        peak = torch.maximum(peak, torch.where(valid, y["t_skin"],
                                               -torch.inf).amax(0))
        pod_steps = pod_steps + daysim._step_sums(ys["pods"].double())[0]
        shut_any = torch.maximum(shut_any, y["shut"][-1])
        # the curve: each user's per-stream pods at its throttle level
        # (the reference's take_linear, exact at an integer level) times
        # act * alive, and the streams live at that step
        idx = y["level"].long() * n_arch + a
        ps = torch.gather(xs["pods_stream"], 1,
                          idx[..., None].expand(-1, -1,
                                                xs["pods_stream"].shape[2]))
        aa = y["act"] * y["alive"]
        terms = aa[..., None, None] * torch.stack([ps, (ps > 0.0).float()],
                                                  dim=2)   # (T, n, 2, S)
        for j, lo, hi in js:
            acc[:, j] += terms[:, lo:hi].sum(1, dtype=torch.float64)
        # overnight dock top-up into the next morning; thermal state and
        # latches restart inside the kernel
        start = {"soc0": torch.clamp_max(y["soc"][-1] + users["night"][sl],
                                         1.0),
                 "soc0_p": torch.clamp_max(
                     y["soc_p"][-1] + users["night_p"][sl], 1.0)}
    return {"end_soc": y["soc"][-1], "shut": shut_any, "first": first,
            "hit": hit, "peak": peak, "pod_steps": pod_steps}


def fleet_day(population, n_users: int | None = None, key=0, *,
              dt_s: float = 60.0, n_shards: int | None = None,
              n_bins: int = DEFAULT_N_BINS,
              fleet_size: float | None = None,
              standby_mw: float = daysim.DEFAULT_STANDBY_MW,
              shutdown_c: float = daysim.DEFAULT_SHUTDOWN_C,
              skin_limit_c: float = 43.0,
              n_days: int = 1,
              overnight_charge_mw: float = DEFAULT_OVERNIGHT_MW,
              theta=None, results_dir=None,
              prep: FleetPrep | None = None,
              device="cuda") -> FleetReport:
    """Integrate a whole population's day on `device` and aggregate the
    diurnal backend load curve.

    `population` is a `PopulationSpec` (sampled here with `n_users` and
    `key`) or an already-sampled `Population`.  Users run in chunks of
    at most `CHUNK_USERS`, one full-trace day-scan launch per chunk and
    day; per-user results do not depend on the chunk size.  `n_shards`
    must be None or 1: the port runs on one card, where the reference's
    `users` mesh of size 1 is the identity.  `fleet_size` linearly
    rescales the curve from the sampled N to the real deployment.  Keep
    `dt_s` under roughly twice the SoC node's thermal time constant
    (~126 s for the default `ThermalSpec`): the explicit-Euler thermal
    step goes unstable beyond it, as in `daysim.simulate`.

    `n_days > 1` integrates a multi-day horizon: each user's SoC carries
    between days, topped up by `overnight_charge_mw` on the dock for the
    off-wrist gap (24 h minus worn hours); thermal state and the
    throttle/shutdown latches reset each morning; the curve is the
    per-day average."""
    if isinstance(population, PopulationSpec):
        if n_users is None:
            raise ValueError("pass n_users when sampling from a "
                             "PopulationSpec")
        pop = sample_population(population, n_users, key)
    elif isinstance(population, Population):
        pop = population
    else:
        raise TypeError(f"expected PopulationSpec or Population, got "
                        f"{type(population).__name__}")
    spec = pop.spec
    n = len(pop)
    if n_shards is not None and n_shards != 1:
        raise ValueError(f"n_shards={n_shards} exceeds the 1 local "
                         f"device the port runs on")
    if not (isinstance(n_days, int) and n_days >= 1):
        raise ValueError(f"n_days must be an int >= 1, got {n_days!r}")
    if overnight_charge_mw < 0.0:
        raise ValueError(f"overnight_charge_mw must be >= 0, got "
                         f"{overnight_charge_mw}")
    dev = _device.resolve(device)

    if prep is None:
        prep = prepare_fleet(spec, dt_s=dt_s, n_bins=n_bins,
                             standby_mw=standby_mw,
                             shutdown_c=shutdown_c, theta=theta,
                             results_dir=results_dir, device=dev)
    else:
        if prep.spec is not spec:
            raise ValueError("prep was built for a different "
                             "PopulationSpec than this population's")
        mismatch = [(k, got, want) for k, got, want in
                    (("dt_s", prep.dt_s, dt_s),
                     ("n_bins", prep.n_bins, n_bins),
                     ("standby_mw", prep.standby_mw, standby_mw),
                     ("shutdown_c", prep.shutdown_c, shutdown_c),
                     ("device", prep.device, dev))
                    if got != want]
        if mismatch:
            raise ValueError(f"prep kwargs disagree with fleet_day "
                             f"kwargs: {mismatch}")
    arch = pop.archetype
    joff = _user_offsets(prep.uniq, prep.wake_a, pop)
    cap_eff = prep.cap_a[arch] * (1.0 - pop.fade)
    h = dt_s / 3600.0
    day_steps = prep.day_steps_a[arch]
    # overnight dock energy -> SoC fraction, per node: charge power x the
    # off-wrist gap over effective (age-derated) capacity, in float64
    # like the dSoC coefficients
    gap_h = np.maximum(24.0 - day_steps * h, 0.0)
    night = overnight_charge_mw * gap_h

    # users ordered by offset, so each offset's users are one contiguous
    # range of a chunk
    order = np.argsort(joff, kind="stable")
    host = {"arch": arch.astype(np.int64),
            "amb_off": pop.ambient_offset_c.astype(np.float32),
            "dsoc_coeff": (dt_s / (3600.0 * cap_eff)).astype(np.float32),
            "night": (night / cap_eff).astype(np.float32),
            "night_p": (night / prep.cap_p_a[arch]).astype(np.float32),
            "dsteps": day_steps}
    users = {k: daysim._put(v[order], dev) for k, v in host.items()}
    joff_sorted = joff[order]
    n_streams = prep.xs_dev["pods_stream"].shape[2]
    acc = torch.zeros((prep.n_steps, prep.uniq.size, 2, n_streams),
                      dtype=torch.float64, device=dev)
    parts = []
    for c0 in range(0, n, CHUNK_USERS):
        c1 = min(c0 + CHUNK_USERS, n)
        js_here = np.unique(joff_sorted[c0:c1])
        js = [(int(j), int(np.searchsorted(joff_sorted, j, "left")) - c0,
               int(np.searchsorted(joff_sorted, j, "right")) - c0)
              for j in js_here]
        js = [(j, max(lo, 0), min(hi, c1 - c0)) for j, lo, hi in js]
        parts.append(_run_chunk(prep, users, slice(c0, c1), js, n_days,
                                acc))
    keys = ("end_soc", "shut", "first", "hit", "peak", "pod_steps")
    cat = {k: torch.cat([p[k] for p in parts]) for k in keys}
    sums = torch.stack([cat[k].double() for k in keys]).cpu().numpy()
    acc = acc.cpu().numpy()
    per_user = {k: np.empty(n) for k in keys}
    for k, v in zip(keys, sums):
        per_user[k][order] = v

    # fold (T, J) into UTC bins in float64; the raw per-step sums become
    # the average pods live during each bin (one step covers dt_s of the
    # bin's hours), averaged over the horizon's days
    curves = np.zeros((2, n_bins, n_streams), np.float64)
    flat = prep.bins.ravel()
    for i in range(2):
        np.add.at(curves[i], flat, acc[:, :, i].reshape(flat.size,
                                                        n_streams))
    norm = (h / (24.0 / n_bins)) / n_days
    scale = (fleet_size / n) if fleet_size else 1.0
    hit = per_user["hit"] > 0.5
    tte = np.where(hit, per_user["first"], day_steps * n_days) * h
    return FleetReport(
        population=pop, streams=STREAMS,
        curve=curves[0] * norm * scale, dt_s=dt_s,
        fleet_size=fleet_size or float(n),
        day_hours=day_steps * h * n_days, time_to_empty_h=tte,
        peak_skin_c=per_user["peak"], end_soc=per_user["end_soc"],
        shutdown=per_user["shut"] > 0.5,
        pod_hours=per_user["pod_steps"] * h,
        skin_limit_c=skin_limit_c, n_shards=1,
        stream_curve=curves[1] * norm * scale, n_days=n_days,
        device=str(dev))


def reference_fleet(pop: Population, *, dt_s: float = 60.0,
                    n_bins: int = DEFAULT_N_BINS,
                    standby_mw: float = daysim.DEFAULT_STANDBY_MW,
                    shutdown_c: float = daysim.DEFAULT_SHUTDOWN_C,
                    skin_limit_c: float = 43.0,
                    theta=None, results_dir=None,
                    device="cuda") -> FleetReport:
    """Per-user oracle: a loop over `daysim.reference_integrate`, one
    aged / climate-offset device at a time (its rows through the row
    cache on `device`), with the curve binned in float64.  `end_soc` is
    each user's last SoC (the reference's oracle leaves it 0).
    O(N * steps) Python: parity checks only."""
    spec = pop.spec
    n = len(pop)
    dev = _device.resolve(device)
    combos = _archetype_combos(spec, theta, results_dir, dev)
    xs, tbs = _stack_archetype_tables(combos, dt_s, standby_mw,
                                      shutdown_c)
    n_steps = xs["step_mw"].shape[0]
    bins, joff = _bin_tables(spec, pop, dt_s, n_steps, n_bins)
    n_levels_max = max(cb.policy.n_levels for cb in combos)

    curve = np.zeros((n_bins, len(STREAMS)), np.float64)
    stream_curve = np.zeros((n_bins, len(STREAMS)), np.float64)
    tte = np.zeros(n)
    peak = np.zeros(n)
    shut = np.zeros(n, bool)
    end_soc = np.zeros(n)
    pod_hours = np.zeros(n)
    day_steps = np.asarray([tb["valid"].sum() for tb in tbs],
                           np.float64)
    h = dt_s / 3600.0
    for u in range(n):
        a_i = int(pop.archetype[u])
        a = spec.archetypes[a_i]
        plat = daysim._plat(a.platform)
        # climate offset applied in float32 exactly as the fleet adds it
        # to the float32 ambient rows (f32(x) round-trips through a
        # python float unchanged)
        off = np.float32(pop.ambient_offset_c[u])
        segs = tuple(
            replace(s, ambient_c=float(np.float32(s.ambient_c) + off))
            for s in a.resolve_schedule().segments)
        cb = daysim._Combo(
            plat, a.design,
            DaySchedule(f"u{u}", segs), a.resolve_policy(),
            battery_for(plat.name).aged(float(pop.fade[u])),
            daysim.DEFAULT_THERMAL, puck_for(plat))
        daysim._compile_platform(plat, [cb], 1.0, theta, results_dir, dev)
        tb = daysim._combo_tables(cb, dt_s, n_steps, n_levels_max,
                                  standby_mw, shutdown_c)
        ref = daysim.reference_integrate(tb)
        t = int(day_steps[a_i])
        dead = (np.minimum(ref["soc"], ref["soc_p"]) <= 0.0) \
            | (ref["shut"] > 0.5)
        hit = dead.any()
        first = float(np.argmax(dead) + 1) if hit else day_steps[a_i]
        tte[u] = first * h
        valid = tb["valid"] > 0.0
        peak[u] = np.where(valid, ref["t_skin"], -np.inf).max()
        shut[u] = ref["shut"][-1] > 0.5
        end_soc[u] = ref["soc"][-1]
        pod_hours[u] = np.float64(ref["pods"]).sum() * h
        aa = ref["act"] * ref["alive"]          # float32, device order
        ps = tb["step_pods_stream"][np.arange(n_steps), ref["level"]]
        contrib = aa[:, None] * ps              # float32 products
        live = aa[:, None] * (ps > 0.0).astype(np.float32)
        np.add.at(curve, bins[:t, joff[u]],
                  np.asarray(contrib[:t], np.float64))
        np.add.at(stream_curve, bins[:t, joff[u]],
                  np.asarray(live[:t], np.float64))
    # the same per-step -> average-pods-per-bin normalization as fleet_day
    norm = h / (24.0 / n_bins)
    return FleetReport(
        population=pop, streams=STREAMS, curve=curve * norm, dt_s=dt_s,
        fleet_size=float(n), day_hours=day_steps[pop.archetype] * h,
        time_to_empty_h=tte, peak_skin_c=peak,
        end_soc=end_soc, shutdown=shut, pod_hours=pod_hours,
        skin_limit_c=skin_limit_c, n_shards=0,
        stream_curve=stream_curve * norm, device=str(dev))
