"""Autoscaler dynamics: backend capacity that lags the diurnal curve.

`offload.curve_cost`'s "autoscaled" pricing integrates the demand curve
directly: an idealized autoscaler with zero reaction time.  Real fleets
boot pods with minutes of spin-up latency, keep headroom through a
target utilization, and hold a scale-down hysteresis band so capacity
does not chatter around a noisy plateau.  `AutoscalerSpec` declares
those dynamics as JSON round-trip data and `simulate` integrates them
over the (substep-resampled) diurnal curve:

  * launches enter a fixed-length boot pipeline and serve only after
    `spinup_h` (booting pods are billed from launch);
  * desired capacity is demand over `target_utilization`, clipped to
    `[min_pods, max_pods]`;
  * capacity above the hysteresis band scales down at once; inside the
    band it holds, so it never oscillates on wiggles smaller than the
    band;
  * served work is `min(demand, capacity)`; the shortfall while the
    morning ramp outruns spin-up is dropped work: dropped pod-hours and,
    against the fleet's active-stream curve, dropped stream-hours, the
    QoS objective `dse.fleet_pareto` trades against $/day.

As `spinup_h -> 0` (with `target_utilization=1`, `down_band=0`) the
provisioned pod-hours converge to the curve's integral and dropped work
to zero (`INSTANT`), so dynamic pricing degenerates to `curve_cost`'s
autoscaled figure.

The capacity scan is a scalar recurrence of B x `substeps_per_bin`
steps.  It runs as plain PyTorch on `device` in float32, one eager step
at a time with the reference's operations in its order (the boot ring a
`torch.roll` and then a set), so on a card it is bound by kernel
launches, not by work; all reductions happen on the host in float64
from the per-substep trajectory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as _device


@dataclass(frozen=True)
class AutoscalerSpec:
    """Declarative autoscaler dynamics.

    `target_utilization` is the demand fraction of capacity the
    controller aims for (headroom = 1/util - 1); `spinup_h` the
    launch-to-serving boot latency; `down_band` the scale-down
    hysteresis fraction (capacity holds while demand/util stays within
    `[cap * (1 - down_band), cap]`); `min_pods`/`max_pods` clamp the
    fleet (`max_pods=None` means uncapped); `substeps_per_bin` the
    scan resolution inside each curve bin."""
    name: str = "default"
    target_utilization: float = 0.75
    spinup_h: float = 0.5
    down_band: float = 0.10
    min_pods: float = 0.0
    max_pods: float | None = None
    substeps_per_bin: int = 12

    def __post_init__(self):
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError(f"target_utilization must be in (0, 1], "
                             f"got {self.target_utilization}")
        if self.spinup_h < 0.0:
            raise ValueError(f"spinup_h must be >= 0, got "
                             f"{self.spinup_h}")
        if not 0.0 <= self.down_band < 1.0:
            raise ValueError(f"down_band must be in [0, 1), got "
                             f"{self.down_band}")
        if self.min_pods < 0.0:
            raise ValueError(f"min_pods must be >= 0, got "
                             f"{self.min_pods}")
        if self.max_pods is not None and self.max_pods < self.min_pods:
            raise ValueError(f"max_pods={self.max_pods} < "
                             f"min_pods={self.min_pods}")
        if not (isinstance(self.substeps_per_bin, int)
                and self.substeps_per_bin >= 1):
            raise ValueError(f"substeps_per_bin must be an int >= 1, "
                             f"got {self.substeps_per_bin!r}")

    def to_dict(self) -> dict:
        return {"name": self.name,
                "target_utilization": self.target_utilization,
                "spinup_h": self.spinup_h,
                "down_band": self.down_band,
                "min_pods": self.min_pods,
                "max_pods": self.max_pods,
                "substeps_per_bin": self.substeps_per_bin}

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalerSpec":
        return cls(
            d.get("name", "default"),
            float(d.get("target_utilization", 0.75)),
            float(d.get("spinup_h", 0.5)),
            float(d.get("down_band", 0.10)),
            float(d.get("min_pods", 0.0)),
            None if d.get("max_pods") is None else float(d["max_pods"]),
            int(d.get("substeps_per_bin", 12)))


# the idealized spec: zero latency, no headroom, no band; dynamic pricing
# equals the curve's integral under it
INSTANT = AutoscalerSpec("instant", target_utilization=1.0,
                         spinup_h=0.0, down_band=0.0)

TRAJ_KEYS = ("cap", "booting", "served", "dropped", "launch", "down")


def _scale_scan(demand: torch.Tensor, params: dict, n_boot: int) -> dict:
    """The capacity scan over (n,) float32 `demand` on its device, one
    eager step per substep; returns the (n,) trajectories of
    `TRAJ_KEYS`.  The fleet starts in steady state at the first
    substep's demand: dropped work comes from ramps the controller
    cannot follow, not from a cold start."""
    util, band = params["util"], params["band"]
    lo, hi = params["min_pods"], params["max_pods"]
    keep = 1.0 - band
    cap = torch.clamp(demand[0] / util, lo, hi)
    boot = demand.new_zeros(n_boot)
    traj = {k: [] for k in TRAJ_KEYS}
    for d in demand:
        if n_boot:                  # pods finishing boot come online
            cap = cap + boot[0]
            boot = torch.roll(boot, -1)
            boot[-1] = 0.0
        booting = boot.sum()
        desired = torch.clamp(d / util, lo, hi)
        launch = torch.clamp_min(desired - (cap + booting), 0.0)
        if n_boot:
            boot[-1] += launch
        else:
            cap = cap + launch
        down = desired < cap * keep
        cap = torch.where(down, torch.maximum(desired, lo), cap)
        served = torch.minimum(d, cap)
        for k, v in (("cap", cap), ("booting", boot.sum()),
                     ("served", served), ("dropped", d - served),
                     ("launch", launch), ("down", down.float())):
            traj[k].append(v)
    return {k: torch.stack(v) for k, v in traj.items()}


def _validate_curve(curve, bin_hours: float) -> np.ndarray:
    # repro: ignore[R002,R006]: host input check: the curve is the caller's
    # numpy demand, not a tensor
    c = np.asarray(curve, np.float64)
    if c.ndim != 1 or c.size == 0:
        raise ValueError(f"expected a (B,) demand curve, got shape "
                         f"{np.shape(curve)}")
    if float(c.min()) < 0.0:
        raise ValueError("curve has negative pods")
    if not math.isclose(bin_hours * c.size, 24.0, rel_tol=1e-9):
        raise ValueError(f"curve covers {bin_hours * c.size:g} h "
                         f"({c.size} bins x {bin_hours:g} h), expected "
                         f"a 24 h diurnal day")
    return c


def simulate(spec: AutoscalerSpec, curve, bin_hours: float = 1.0,
             stream_curve=None, device="cuda") -> dict:
    """Integrate the autoscaler over one diurnal day on `device`.

    `curve` is the (B,) average-pods-per-bin demand
    (`FleetReport.curve_total`); `stream_curve` the matching
    concurrently-live stream counts (`FleetReport.stream_curve_total`)
    that turn the dropped demand fraction into stream-hours.  Demand is
    held piecewise-constant across `spec.substeps_per_bin` substeps, so
    ramps happen at bin edges and a boot latency longer than one substep
    visibly lags them.

    Returns provisioned/served/dropped pod-hours (provisioned bills
    online + booting pods), the per-bin mean capacity curve, dropped
    stream-hours (None without `stream_curve`), and the effective
    spin-up latency after rounding to whole substeps."""
    c = _validate_curve(curve, bin_hours)
    dev = _device.resolve(device)
    dt_h = bin_hours / spec.substeps_per_bin
    n_boot = int(round(spec.spinup_h / dt_h))
    demand = np.repeat(c, spec.substeps_per_bin).astype(np.float32)
    params = {k: torch.tensor(v, dtype=torch.float32, device=dev)
              for k, v in (("util", spec.target_utilization),
                           ("band", spec.down_band),
                           ("min_pods", spec.min_pods),
                           ("max_pods", np.inf if spec.max_pods is None
                            else spec.max_pods))}
    traj = _scale_scan(torch.as_tensor(demand, device=dev), params, n_boot)
    # repro: ignore[R002]: the call's one copy of its trajectories to the host
    host = torch.stack([traj[k] for k in TRAJ_KEYS]).cpu().numpy()
    # repro: ignore[R006]: host float64 summary of the copied trajectories, as
    # the reference sums them
    traj = {k: v.astype(np.float64) for k, v in zip(TRAJ_KEYS, host)}

    billed = traj["cap"] + traj["booting"]
    dropped_frac = np.divide(traj["dropped"], demand,
                             out=np.zeros_like(traj["dropped"]),
                             where=demand > 0)
    out = {
        "spec": spec.to_dict(),
        "effective_spinup_h": n_boot * dt_h,
        "capacity_curve": traj["cap"].reshape(
            c.size, spec.substeps_per_bin).mean(axis=1),
        "peak_capacity_pods": float(billed.max()),
        "provisioned_pod_hours": float(billed.sum() * dt_h),
        "served_pod_hours": float(traj["served"].sum() * dt_h),
        "dropped_pod_hours": float(traj["dropped"].sum() * dt_h),
        "dropped_stream_hours": None,
        "launched_pods": float(traj["launch"].sum()),
        "scale_down_events": int(traj["down"].sum()),
    }
    if stream_curve is not None:
        # repro: ignore[R002,R006]: host float64 stream curve of the caller, as
        # the reference reads it
        s = np.asarray(stream_curve, np.float64)
        if s.shape != c.shape:
            raise ValueError(f"stream_curve shape {s.shape} != demand "
                             f"curve shape {c.shape}")
        streams_sub = np.repeat(s, spec.substeps_per_bin)
        out["dropped_stream_hours"] = float(
            (dropped_frac * streams_sub).sum() * dt_h)
    return out
