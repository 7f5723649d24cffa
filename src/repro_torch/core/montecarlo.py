"""Monte Carlo fleets: survival and load as distributions, not points.

`fleet.fleet_day` integrates ONE sampled population, a point estimate.
This module lifts it to a distribution over the sampling key:
`draw_keys` derives per-draw integer seeds from one explicit key (no
hidden RNG state), `fleet_distribution` samples and integrates each
draw, and the result is a `FleetDistribution`: survival rate,
time-to-empty quantiles, the diurnal curve and the capacity plan's
dollar figures as mean + CI bands, JSON round-trip.

Common random numbers across variants: `sample_population` draws
archetype / timezone / climate / fade from the mixture weights, which
`PopulationSpec.with_overrides` never touches, so calling
`fleet_distribution` on each design/policy variant with the same key
integrates the identical users under every variant, and the deltas
`dse.fleet_pareto` ranks are design effects with the sampling noise
differenced out.

With an `autoscale.AutoscalerSpec` every draw is also priced
dynamically (capacity lagging demand) and the distribution carries
dynamic $/day and dropped-stream-hours bands.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import fleet, offload

DEFAULT_TTE_QS = (0.05, 0.25, 0.5, 0.75, 0.95)


def draw_keys(key, n_draws: int) -> np.ndarray:
    """(n_draws,) int64 per-draw seeds from one integer `key`, drawn by
    one seeded CPU generator (`fleet.split_seed`).

    The CRN contract: the same (key, n_draws) yields the same seeds, so
    two variant sweeps seeded identically simulate identical populations
    draw for draw."""
    if n_draws <= 0:
        raise ValueError(f"n_draws must be > 0, got {n_draws}")
    return np.asarray(fleet.split_seed(key, n_draws), np.int64)


def _band(draws: np.ndarray, ci: float) -> dict:
    """mean/std/CI-quantile summary of one scalar across draws."""
    lo = (1.0 - ci) / 2.0
    return {"mean": float(draws.mean()),
            "std": float(draws.std(ddof=1)) if draws.size > 1 else 0.0,
            "lo": float(np.quantile(draws, lo)),
            "hi": float(np.quantile(draws, 1.0 - lo))}


@dataclass(frozen=True)
class FleetDistribution:
    """Monte Carlo fleet-day results: per-draw arrays plus band
    summaries.  `curve_draws` keeps the full (D, B, S) per-stream curves,
    so CI bands are computed on demand at any level; scalar draws follow
    the same convention.  `dynamic_usd_draws` / `dropped_stream_h_draws`
    are None unless the distribution was priced with an autoscaler."""
    spec_name: str
    n_users: int
    n_draws: int
    ci: float
    streams: tuple
    bin_hours: float
    fleet_size: float
    survival_draws: np.ndarray          # (D,)
    tte_qs: tuple                       # quantile levels
    tte_draws: np.ndarray               # (D, len(tte_qs)) hours
    curve_draws: np.ndarray             # (D, B, S)
    stream_curve_draws: np.ndarray      # (D, B, S)
    usd_draws: np.ndarray               # (D,) autoscaled $/day
    autoscaler: dict | None = None
    dynamic_usd_draws: np.ndarray | None = None
    dropped_stream_h_draws: np.ndarray | None = None

    def survival_rate(self) -> dict:
        return _band(self.survival_draws, self.ci)

    def tte_quantiles(self) -> dict:
        """{p50: {mean, std, lo, hi}, ...} across draws, in hours."""
        return {f"p{int(100 * q)}": _band(self.tte_draws[:, i], self.ci)
                for i, q in enumerate(self.tte_qs)}

    def curve_bands(self) -> dict:
        """Per-bin total-pods curve: mean and CI band across draws."""
        tot = self.curve_draws.sum(axis=2)              # (D, B)
        lo = (1.0 - self.ci) / 2.0
        return {"mean": tot.mean(axis=0),
                "lo": np.quantile(tot, lo, axis=0),
                "hi": np.quantile(tot, 1.0 - lo, axis=0)}

    def cost(self) -> dict:
        """$/day bands: autoscaled always, dynamic + dropped QoS when
        the distribution was priced with an autoscaler."""
        out = {"autoscaled_usd": _band(self.usd_draws, self.ci)}
        if self.dynamic_usd_draws is not None:
            out["dynamic_usd"] = _band(self.dynamic_usd_draws, self.ci)
            out["dropped_stream_hours"] = _band(
                self.dropped_stream_h_draws, self.ci)
            out["autoscaler"] = self.autoscaler
        return out

    def summary(self) -> dict:
        """The headline dict examples and benchmarks print."""
        return {"spec": self.spec_name, "n_users": self.n_users,
                "n_draws": self.n_draws, "ci": self.ci,
                "fleet_size": self.fleet_size,
                "survival_rate": self.survival_rate(),
                "tte_quantiles_h": self.tte_quantiles(),
                **self.cost()}

    def to_dict(self) -> dict:
        d = {"spec_name": self.spec_name, "n_users": self.n_users,
             "n_draws": self.n_draws, "ci": self.ci,
             "streams": list(self.streams),
             "bin_hours": self.bin_hours,
             "fleet_size": self.fleet_size,
             "survival_draws": self.survival_draws.tolist(),
             "tte_qs": list(self.tte_qs),
             "tte_draws": self.tte_draws.tolist(),
             "curve_draws": self.curve_draws.tolist(),
             "stream_curve_draws": self.stream_curve_draws.tolist(),
             "usd_draws": self.usd_draws.tolist(),
             "autoscaler": self.autoscaler}
        if self.dynamic_usd_draws is not None:
            d["dynamic_usd_draws"] = self.dynamic_usd_draws.tolist()
            d["dropped_stream_h_draws"] = \
                self.dropped_stream_h_draws.tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FleetDistribution":
        def arr(k):
            return (np.asarray(d[k], np.float64)
                    if d.get(k) is not None else None)
        return cls(
            d["spec_name"], int(d["n_users"]), int(d["n_draws"]),
            float(d["ci"]), tuple(d["streams"]),
            float(d["bin_hours"]), float(d["fleet_size"]),
            arr("survival_draws"), tuple(d["tte_qs"]),
            arr("tte_draws"), arr("curve_draws"),
            arr("stream_curve_draws"), arr("usd_draws"),
            d.get("autoscaler"), arr("dynamic_usd_draws"),
            arr("dropped_stream_h_draws"))


_PREP_KEYS = ("dt_s", "n_bins", "standby_mw", "shutdown_c", "theta",
              "results_dir", "device")


def fleet_distribution(spec, n_users: int, n_draws: int = 16, key=0, *,
                       ci: float = 0.90, autoscaler=None,
                       tte_qs: tuple = DEFAULT_TTE_QS,
                       fleet_size: float | None = None,
                       reuse_prep: bool = True,
                       **fleet_kw) -> FleetDistribution:
    """Monte Carlo `fleet.fleet_day` over the population sampling key.

    Derives `n_draws` seeds from `key` (`draw_keys`), samples and
    integrates each draw, and aggregates survival / TTE / curve / $ into
    a `FleetDistribution` with `ci`-level bands.  Extra keyword arguments
    flow to `fleet.fleet_day` (dt_s, n_bins, n_days, device, ...; the
    default device is the card's).  With `reuse_prep` (the default) the
    spec-derived half of the day (archetype combos, tables on the
    device) is built once (`fleet.prepare_fleet`) and every draw
    re-derives only its users' gathers; `reuse_prep=False` rebuilds it
    per draw.  Results are bit-identical either way.  Pass the same
    `key` when comparing variant specs: the draws are then common random
    numbers."""
    if not 0.0 < ci < 1.0:
        raise ValueError(f"ci must be in (0, 1), got {ci}")
    if reuse_prep and "prep" not in fleet_kw:
        prep_kw = {k: fleet_kw[k] for k in _PREP_KEYS if k in fleet_kw}
        fleet_kw = dict(fleet_kw,
                        prep=fleet.prepare_fleet(spec, **prep_kw))
    keys = draw_keys(key, n_draws)
    surv, ttes, curves, scurves, usd = [], [], [], [], []
    dyn_usd, dropped = [], []
    streams, bin_hours, fsize = (), 1.0, 0.0
    for k in keys:
        pop = fleet.sample_population(spec, n_users, k)
        rep = fleet.fleet_day(pop, fleet_size=fleet_size, **fleet_kw)
        streams, fsize = rep.streams, rep.fleet_size
        bin_hours = 24.0 / rep.curve.shape[0]
        surv.append(rep.survival_rate())
        ttes.append(np.quantile(rep.time_to_empty_h, tte_qs))
        curves.append(rep.curve)
        scurves.append(rep.stream_curve)
        plan = offload.curve_cost(rep.curve_total, bin_hours,
                                  autoscaler=autoscaler,
                                  stream_curve=rep.stream_curve_total,
                                  device=rep.device)
        usd.append(plan["autoscaled"]["usd"])
        if autoscaler is not None:
            dyn_usd.append(plan["dynamic"]["usd"])
            dropped.append(plan["dropped_stream_hours"])
    return FleetDistribution(
        spec_name=spec.name, n_users=n_users, n_draws=n_draws, ci=ci,
        streams=streams, bin_hours=bin_hours, fleet_size=fsize,
        survival_draws=np.asarray(surv, np.float64),
        tte_qs=tuple(tte_qs),
        tte_draws=np.asarray(ttes, np.float64),
        curve_draws=np.asarray(curves, np.float64),
        stream_curve_draws=np.asarray(scurves, np.float64),
        usd_draws=np.asarray(usd, np.float64),
        autoscaler=(None if autoscaler is None
                    else autoscaler.to_dict()),
        dynamic_usd_draws=(np.asarray(dyn_usd, np.float64)
                           if autoscaler is not None else None),
        dropped_stream_h_draws=(np.asarray(dropped, np.float64)
                                if autoscaler is not None else None))
