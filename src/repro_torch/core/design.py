"""Unified differentiable design core: the `DesignSpace` of the port.

A `DesignSpace` is an ordered set of declared `Knob` leaves (bounds and
a discrete / continuous tag); a *design point* is a plain
``{name: tensor}`` dict, so autograd, `torch.func.vmap` and the
projected-Adam step below flow through it unchanged.

Discrete knobs carry smooth relaxations so gradients exist end to end:

  * placement      — per-primitive Bernoulli logits; `placement_probs`
                     is a temperature-annealed sigmoid that the relaxed
                     engine (`scenarios.evaluate_relaxed`) consumes
                     directly; a binary point reproduces the
                     int-indexed engine exactly.
  * mcs            — logits over the WiFi MCS tiers; `mcs_probs` is a
                     temperature-annealed softmax.
  * throttle trips — straight-through comparisons (`ste_gt` /
                     `ste_lt`): the forward value is the exact hard
                     comparison, the backward pass a sigmoid surrogate's
                     gradient.  With ``beta=None`` they are the hard
                     comparison alone, which the day scan's plain
                     version (`kernels.day_scan.day_scan_plain`) uses.
  * table levels   — `take_linear` indexes throttle-level tables with a
                     float level: exact at integer levels, linear
                     (sub)gradient between them.

On top sit `uniform_sample` / `clip` over a space and `adam_init` /
`adam_update`, the projected-Adam step of `dse.gradient_descend` and
`calibrate`.  Samples come from an explicit `torch.Generator` seeded
from the caller's seed, drawn on the CPU and then moved, so a seed gives
the same points on every device.

Standard spaces: `device_space(platform)` (the ScenarioSet knobs),
`policy_space()` (throttle trip points + hysteresis band widths; the
band parameterization keeps clear-below-trip satisfied under any
projection).  `calibrate.theta_space()` builds the theta space from its
calibration bounds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device
from .platform import PlatformSpec

CONTINUOUS = "continuous"
DISCRETE = "discrete"


@dataclass(frozen=True)
class Knob:
    """One declared design-space leaf.

    `lo`/`hi` bound the raw leaf value (for DISCRETE knobs these bound
    the *logits*, not the relaxed probabilities); `shape` is the leaf
    shape of one design point (scalar knobs use ())."""
    name: str
    lo: float
    hi: float
    tag: str = CONTINUOUS
    shape: tuple = ()
    doc: str = ""

    def __post_init__(self):
        if self.tag not in (CONTINUOUS, DISCRETE):
            raise ValueError(f"knob {self.name!r}: tag must be "
                             f"{CONTINUOUS!r} or {DISCRETE!r}")
        if not self.lo < self.hi:
            raise ValueError(f"knob {self.name!r}: need lo < hi, "
                             f"got [{self.lo}, {self.hi}]")


@dataclass(frozen=True)
class DesignSpace:
    """An ordered set of `Knob`s; design points are {name: tensor} dicts."""
    knobs: tuple

    def __post_init__(self):
        names = [k.name for k in self.knobs]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate knob names in {names}")

    def __len__(self) -> int:
        return len(self.knobs)

    def names(self) -> tuple:
        return tuple(k.name for k in self.knobs)

    def knob(self, name: str) -> Knob:
        for k in self.knobs:
            if k.name == name:
                return k
        raise KeyError(f"unknown knob {name!r}; one of {self.names()}")

    def subset(self, names) -> "DesignSpace":
        return DesignSpace(tuple(self.knob(n) for n in names))

    # -- points -------------------------------------------------------------
    def midpoint(self, device="cuda") -> dict:
        dev = _device.resolve(device)
        return {k.name: torch.full(k.shape, 0.5 * (k.lo + k.hi),
                                   device=dev)
                for k in self.knobs}

    def validate(self, point: dict) -> dict:
        """Check leaf names/shapes (bounds are enforced by `clip`)."""
        missing = set(self.names()) - set(point)
        extra = set(point) - set(self.names())
        if missing or extra:
            raise ValueError(f"design point keys mismatch: missing "
                             f"{sorted(missing)}, extra {sorted(extra)}")
        for k in self.knobs:
            got = tuple(np.shape(point[k.name]))[-len(k.shape):] \
                if k.shape else ()
            if k.shape and got != k.shape:
                raise ValueError(f"knob {k.name!r}: trailing shape {got} "
                                 f"!= declared {k.shape}")
        return point

    def clip(self, point: dict) -> dict:
        """Project a point (or a batch of points) back into bounds."""
        return {k.name: torch.clamp(torch.as_tensor(point[k.name]),
                                    k.lo, k.hi)
                for k in self.knobs}

    def uniform_sample(self, seed, n: int, device="cuda") -> dict:
        """(n,)-batched uniform-in-bounds restarts (leading axis n),
        float32, drawn on the CPU from `seed` (an int, or a CPU
        `torch.Generator` that the draws advance) and moved to
        `device`."""
        dev = _device.resolve(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        out = {}
        for k in self.knobs:
            u = torch.rand((n,) + k.shape, generator=gen)
            out[k.name] = (k.lo + (k.hi - k.lo) * u).to(dev)
        return out

    def to_dict(self) -> dict:
        return {"knobs": [{"name": k.name, "lo": k.lo, "hi": k.hi,
                           "tag": k.tag, "shape": list(k.shape),
                           "doc": k.doc} for k in self.knobs]}

    @classmethod
    def from_dict(cls, d: dict) -> "DesignSpace":
        return cls(tuple(Knob(k["name"], float(k["lo"]), float(k["hi"]),
                              k["tag"], tuple(k["shape"]),
                              k.get("doc", ""))
                         for k in d["knobs"]))


# ---------------------------------------------------------------------------
# smooth relaxations of discrete structure
# ---------------------------------------------------------------------------

def placement_probs(logits, tau: float = 1.0):
    """Temperature-annealed per-primitive on-device probabilities."""
    return torch.sigmoid(logits / tau)


def mcs_probs(logits, tau: float = 1.0):
    """Temperature-annealed soft one-hot over WiFi MCS tiers."""
    return torch.softmax(logits / tau, dim=-1)


def _hard(cmp, x, thresh):
    return cmp.to(torch.result_type(x, thresh))


def ste_gt(x, thresh, beta=None):
    """Straight-through x > thresh.

    Forward: the exact hard comparison (0.0/1.0).  With `beta` the
    backward pass carries the gradient of sigmoid((x - thresh) * beta)
    to both `x` and `thresh`; with ``beta=None`` the result is the hard
    comparison alone (no surrogate, nothing for autograd)."""
    hard = _hard(x > thresh, x, thresh)
    if beta is None:
        return hard
    soft = torch.sigmoid((x - thresh) * beta)
    # (soft - soft.detach()) is EXACTLY 0.0 in every float width, so the
    # forward value is exactly `hard`; (hard + soft) - soft.detach()
    # would round at the ulp and leak into the scanned trigger state
    return hard + (soft - soft.detach())


def ste_lt(x, thresh, beta=None):
    """Straight-through x < thresh (see `ste_gt`)."""
    hard = _hard(x < thresh, x, thresh)
    if beta is None:
        return hard
    soft = torch.sigmoid((thresh - x) * beta)
    return hard + (soft - soft.detach())


def take_linear(table, idx_f):
    """Index the last axis of `table` at float position `idx_f`, one
    position per row: `idx_f` has (or broadcasts to) the table's leading
    shape, as the reference's `take_linear` mapped over combos.  Exact
    lookup at integer positions (frac == 0 contributes an exact
    `a * 1 + b * 0`), linear between them, so a straight-through
    throttle level carries `table[l+1] - table[l]` as its gradient."""
    n = table.shape[-1]
    l0 = torch.clamp(torch.floor(idx_f), 0, n - 1)
    frac = idx_f - l0
    i0 = l0.long()
    i1 = torch.clamp_max(i0 + 1, n - 1)

    def at(i):
        return torch.gather(table, -1, i.expand(table.shape[:-1])
                            .unsqueeze(-1)).squeeze(-1)

    return at(i0) * (1.0 - frac) + at(i1) * frac


def soft_indicator(x, margin, beta):
    """Smooth 1[x > margin] for surrogate objectives (e.g. soft
    time-to-empty = sum of soft-alive steps)."""
    return torch.sigmoid((x - margin) * beta)


# ---------------------------------------------------------------------------
# standard spaces
# ---------------------------------------------------------------------------

LOGIT_LO, LOGIT_HI = -6.0, 6.0


def device_space(platform: PlatformSpec | None = None,
                 n_mcs: int = 3) -> DesignSpace:
    """The ScenarioSet knob set as one differentiable space.

    Compression and fps_scale are optimized in log2 (their sweeps span
    decades); placement/MCS are DISCRETE logits leaves."""
    n_prim = len(platform.primitives) if platform is not None else 4
    return DesignSpace((
        Knob("placement_logits", LOGIT_LO, LOGIT_HI, DISCRETE, (n_prim,),
             "per-primitive on-device Bernoulli logits"),
        Knob("log2_compression", 0.0, 7.0, CONTINUOUS, (),
             "visual stream compression = 2**x (1..128)"),
        Knob("log2_fps_scale", 0.0, 5.0, CONTINUOUS, (),
             "sensor frame-rate reduction = 2**x (1..32)"),
        Knob("upload_duty", 0.02, 1.0, CONTINUOUS, (),
             "VAD/saliency uplink gating"),
        Knob("brightness", 0.0, 1.0, CONTINUOUS, (),
             "display brightness (display SKUs)"),
        Knob("mcs_logits", LOGIT_LO, LOGIT_HI, DISCRETE, (n_mcs,),
             "WiFi MCS tier softmax logits"),
    ))


def device_vec(point: dict, tau: float = 1.0) -> dict:
    """DesignPoint -> the relaxed engine's knob vector
    (`scenarios.evaluate_relaxed`).  Leading batch axes pass through."""
    return {
        "placement": placement_probs(point["placement_logits"], tau),
        "compression": 2.0 ** point["log2_compression"],
        "fps_scale": 2.0 ** point["log2_fps_scale"],
        "upload_duty": point["upload_duty"],
        "brightness": point["brightness"],
        "mcs_weights": mcs_probs(point["mcs_logits"], tau),
    }


def policy_space() -> DesignSpace:
    """Throttle-governor thresholds as a differentiable space.

    Hysteresis is parameterized as (trip, band) with band > 0, so
    clear = trip - band (thermal) / trip + band (SoC) satisfies the
    policy invariants under any clipping/projection."""
    return DesignSpace((
        Knob("temp_trip_c", 34.0, 43.0, CONTINUOUS, (),
             "skin temp that trips the thermal throttle"),
        Knob("temp_band_c", 0.5, 6.0, CONTINUOUS, (),
             "thermal hysteresis band; clear = trip - band"),
        Knob("soc_trip", 0.02, 0.6, CONTINUOUS, (),
             "state of charge that trips the battery throttle"),
        Knob("soc_band", 0.02, 0.35, CONTINUOUS, (),
             "SoC hysteresis band; clear = trip + band"),
    ))


def policy_point(policy, device="cuda") -> dict:
    """daysim.ThrottlePolicy -> a policy_space design point (float32)."""
    dev = _device.resolve(device)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    return {
        "temp_trip_c": f32(policy.temp_trip_c),
        "temp_band_c": f32(policy.temp_trip_c - policy.temp_clear_c),
        "soc_trip": f32(policy.soc_trip),
        "soc_band": f32(policy.soc_clear - policy.soc_trip),
    }


# ---------------------------------------------------------------------------
# projected Adam over design points
# ---------------------------------------------------------------------------

def adam_init(point: dict) -> dict:
    return {"m": {k: torch.zeros_like(v) for k, v in point.items()},
            "v": {k: torch.zeros_like(v) for k, v in point.items()},
            "t": 0}


def adam_update(point: dict, grads: dict, state: dict, lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple:
    """One Adam step on a design point; returns (point, state).

    Leaves may carry a leading restart axis: the update is elementwise,
    and all restarts share the step count `t`.  Callers compose with
    `space.clip` for the projection."""
    t = state["t"] + 1
    m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state["v"][k] + (1 - b2) * g * g
         for k, g in grads.items()}
    new = {}
    for k, p in point.items():
        tf = torch.tensor(float(t), dtype=p.dtype, device=p.device)
        new[k] = p - lr * (m[k] / (1 - b1 ** tf)) \
            / (torch.sqrt(v[k] / (1 - b2 ** tf)) + eps)
    return new, {"m": m, "v": v, "t": t}
