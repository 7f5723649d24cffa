"""Wearable -> backend offload bridge (§II-A: signals are "offloaded and
processed by a backend datacenter").

Maps a device scenario's offloaded streams to backend pod fleets: which
assigned architecture serves each egocentric stream, at what request
rate, sized from the committed dry-run roofline artifacts under
`results/dryrun/` (read unchanged, shared with the reference package).
When no artifact exists for a cell, sizing falls back to a
deterministic nominal capacity (`FALLBACK_BOUND_S`), so pods are always
finite.

`stream_rates` resolves each stream's serving cell once per artifact
directory (the only part that touches the filesystem);
`pods_streams_device` is the batched tensor math the day pipeline runs
on the device; `pod_cost` prices pod-hours and `curve_cost` a fleet's
diurnal load curve (autoscaled, peak-provisioned, or through
`autoscale.simulate`'s lagging fleet).  `pods_breakdown` is the
host numpy sizing of a whole `ScenarioSet` (the joint device + backend
front's), `size_fleet` / `fleet_grid` its per-scenario rows.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import aria2, scenarios
from .aria2 import Scenario
from .platform import PRIMITIVES
from .scenarios import ScenarioSet

RESULTS = Path(__file__).resolve().parents[3] / "results"

# backend service per offloaded stream: (arch, shape cell, tokens-or-frames
# produced per user-second of stream); the arch here is the PRIMARY
# candidate — STREAM_CANDIDATES below may swap in a cheaper serving arch
STREAM_SERVICE = {
    # ASR: 1 s audio ~= 50 acoustic frames -> whisper decoder tokens
    "audio": ("whisper-medium", "prefill_32k", 50.0),
    # RGB POV frames -> VLM scene/object understanding (576 tokens/frame@5fps)
    "rgb": ("phi-3-vision-4.2b", "prefill_32k", 576.0 * 5),
    # egocentric signal narration -> personal-context LM ingest
    "signals": ("granite-3-2b", "prefill_32k", 30.0),
    # long-horizon personal-context aggregation (months of signals)
    "context": ("mamba2-2.7b", "train_4k", 30.0),
}

# candidate (arch, shape cell) serving options per stream; fleet sizing
# picks the min-pods candidate (artifact-backed capacities preferred)
STREAM_CANDIDATES = {
    "audio": (("whisper-medium", "prefill_32k"),),
    "rgb": (("phi-3-vision-4.2b", "prefill_32k"),),
    "signals": (("granite-3-2b", "prefill_32k"),
                ("zamba2-1.2b", "prefill_32k")),
    "context": (("mamba2-2.7b", "train_4k"),
                ("zamba2-1.2b", "train_4k")),
}

# deterministic nominal step-time bounds (s) per shape class, used when no
# dry-run artifact exists
FALLBACK_BOUND_S = {"prefill": 2.0, "train": 6.0, "decode": 0.05}


# -- backend cost model (pods -> pod-hours -> $ and kgCO2) ------------------
POD_POWER_KW = 140.0            # 256 accelerators + interconnect/cooling
USD_PER_KWH = 0.085
KGCO2_PER_KWH = 0.30            # grid-average carbon intensity
POD_CAPEX_USD_PER_HOUR = 260.0  # pod price amortized over service life


def usd_per_pod_hour() -> float:
    return POD_CAPEX_USD_PER_HOUR + POD_POWER_KW * USD_PER_KWH


def pod_cost(pod_hours) -> dict:
    """pod-hours -> {pod_hours, energy_kwh, usd, kgco2}.

    Broadcasts over any array shape; scalars return plain floats.
    Negative pod-hours are a caller bug and raise."""
    ph = np.asarray(pod_hours, np.float64)
    if ph.size and float(np.min(ph)) < 0.0:
        raise ValueError(f"pod_hours must be >= 0, got min {np.min(ph)}")
    kwh = ph * POD_POWER_KW
    out = {"pod_hours": ph, "energy_kwh": kwh,
           "usd": ph * POD_CAPEX_USD_PER_HOUR + kwh * USD_PER_KWH,
           "kgco2": kwh * KGCO2_PER_KWH}
    if np.ndim(pod_hours) == 0:
        return {k: float(v) for k, v in out.items()}
    return out


def _check_fleet_args(n_users: float, duty: float) -> None:
    """Shared validation for every fleet-sizing entry: a non-positive
    user count or an out-of-range duty would zero (or negate) every pod
    figure downstream."""
    if not n_users > 0:
        raise ValueError(f"n_users must be > 0, got {n_users}")
    if not 0.0 <= duty <= 1.0:
        raise ValueError(f"duty={duty} outside [0, 1]")


def curve_cost(pods_by_hour, bin_hours: float = 1.0, *,
               per_stream: bool = False, autoscaler=None,
               stream_curve=None, device="cuda") -> dict:
    """Price a diurnal backend load curve: autoscaled vs peak-provisioned
    (vs *dynamic*, when an autoscaler is supplied).  Host numpy in
    float64, as the reference computes it.

    `pods_by_hour` is a (B,) pods-vs-hour-of-day curve (average pods
    active during each bin) or (B, S) per-stream curves, summed over
    streams first.  The bins must cover exactly one 24 h day
    (`bin_hours * B == 24`).  Provisioning strategies priced via
    `pod_cost`:

      autoscaled        — capacity follows the curve instantaneously;
                          pod-hours/day is the curve integral
                          (sum * bin_hours)
      peak_provisioned  — static fleet sized for the worst bin running
                          all day
      dynamic           — only with `autoscaler` (an
                          `autoscale.AutoscalerSpec`): capacity lags
                          demand through spin-up latency and the
                          hysteresis band (`autoscale.simulate`, run on
                          `device`); `stream_curve` (B,) turns the
                          dropped fraction into dropped stream-hours

    With `per_stream=True` and a (B, S) input, `"per_stream"` carries
    the per-stream autoscaled pod-hours/$ breakdown.  The trough/peak
    ratio is the flatness headline: 1.0 means timezone spreading has
    fully flattened the day and autoscaling buys nothing."""
    raw = np.asarray(pods_by_hour, np.float64)
    curve = raw.sum(axis=1) if raw.ndim == 2 else raw
    if curve.ndim != 1 or curve.size == 0:
        raise ValueError(f"expected a (B,) or (B, S) curve, "
                         f"got shape {np.shape(pods_by_hour)}")
    if float(curve.min()) < 0.0:
        raise ValueError("curve has negative pods")
    if not np.isclose(bin_hours * curve.size, 24.0, rtol=1e-9):
        raise ValueError(f"curve covers {bin_hours * curve.size:g} h "
                         f"({curve.size} bins x {bin_hours:g} h), "
                         f"expected a 24 h diurnal day — pass the "
                         f"matching bin_hours")
    if per_stream and raw.ndim != 2:
        raise ValueError("per_stream=True needs a (B, S) curve, got "
                         f"shape {np.shape(pods_by_hour)}")
    peak = float(curve.max())
    trough = float(curve.min())
    auto_ph = float(curve.sum() * bin_hours)
    peak_ph = peak * curve.size * bin_hours
    auto, prov = pod_cost(auto_ph), pod_cost(peak_ph)
    out = {
        "peak_pods": peak, "trough_pods": trough,
        "trough_peak_ratio": trough / peak if peak > 0 else 1.0,
        "autoscaled": auto, "peak_provisioned": prov,
        "savings_usd": prov["usd"] - auto["usd"],
        "savings_pct": (100.0 * (1.0 - auto["usd"] / prov["usd"])
                        if prov["usd"] > 0 else 0.0),
    }
    if per_stream:
        stream_ph = raw.sum(axis=0) * bin_hours         # (S,)
        out["per_stream"] = {
            **pod_cost(stream_ph),
            "peak_pods": raw.max(axis=0),
            "share": (stream_ph / auto_ph if auto_ph > 0
                      else np.zeros_like(stream_ph)),
        }
    if autoscaler is not None:
        from . import autoscale
        sim = autoscale.simulate(autoscaler, curve, bin_hours,
                                 stream_curve=stream_curve, device=device)
        dyn = pod_cost(sim["provisioned_pod_hours"])
        out["dynamic"] = dyn
        out["dynamic_gap_usd"] = dyn["usd"] - auto["usd"]
        out["dropped_pod_hours"] = sim["dropped_pod_hours"]
        out["dropped_stream_hours"] = sim["dropped_stream_hours"]
        out["autoscaler"] = sim["spec"]
        out["effective_spinup_h"] = sim["effective_spinup_h"]
        out["peak_capacity_pods"] = sim["peak_capacity_pods"]
    return out


@dataclass(frozen=True)
class BackendDemand:
    stream: str
    arch: str
    cell: str
    tokens_per_user_s: float
    offloaded: bool


def backend_demand(sc: Scenario) -> list[BackendDemand]:
    """Which backend services are active for a device scenario."""
    on = sc.placements()
    rows = []
    rows.append(BackendDemand("rgb", *STREAM_SERVICE["rgb"][:2],
                              STREAM_SERVICE["rgb"][2], True))  # RGB always
    rows.append(BackendDemand(
        "audio", *STREAM_SERVICE["audio"][:2], STREAM_SERVICE["audio"][2],
        not on["asr"]))           # ASR off-device -> backend transcribes
    rows.append(BackendDemand("signals", *STREAM_SERVICE["signals"][:2],
                              STREAM_SERVICE["signals"][2], True))
    rows.append(BackendDemand("context", *STREAM_SERVICE["context"][:2],
                              STREAM_SERVICE["context"][2], True))
    return rows


def _shape_tokens(shape: str) -> float:
    if shape.startswith("train"):
        return 256 * 4096
    if shape.startswith("prefill"):
        return 32 * 32768
    return 128


class CapacityTable:
    """Backend cell capacities, loaded ONCE per artifact directory from
    the ``<arch>__<shape>__<mesh>.json`` dry-run artifacts (the modeled
    step-time bound of each cell)."""

    def __init__(self, results_dir=None):
        self.dir = Path(results_dir) if results_dir else RESULTS / "dryrun"
        self._bound_s: dict[tuple, float] = {}
        if self.dir.is_dir():
            for f in sorted(self.dir.glob("*.json")):
                parts = tuple(f.stem.split("__"))
                if len(parts) != 3:
                    continue
                try:
                    r = json.loads(f.read_text())
                except (json.JSONDecodeError, OSError):
                    continue
                if r.get("ok") and r.get("terms"):
                    self._bound_s[parts] = max(r["terms"].values())

    def bound_s(self, arch: str, shape: str,
                mesh: str = "single") -> float | None:
        """Modeled step-time bound (s) from the artifact, if present."""
        return self._bound_s.get((arch, shape, mesh))

    def tokens_per_s(self, arch: str, shape: str,
                     mesh: str = "single") -> tuple[float, str]:
        """(tokens/s/pod, source): "dryrun" when the roofline artifact
        exists, else the deterministic "fallback" path."""
        bound = self.bound_s(arch, shape, mesh)
        if bound:
            return _shape_tokens(shape) / bound, "dryrun"
        cls = shape.split("_")[0]
        fb = FALLBACK_BOUND_S.get(cls, FALLBACK_BOUND_S["prefill"])
        return _shape_tokens(shape) / fb, "fallback"

    def resolve(self, candidates) -> tuple[str, str, float, str]:
        """Min-pods (arch, cell, tokens/s, source) among candidate cells:
        artifact-backed capacities beat fallback bounds, then the largest
        capacity wins."""
        best = None
        for arch, cell in candidates:
            cap, source = self.tokens_per_s(arch, cell)
            key = (source == "dryrun", cap)
            if best is None or key > best[0]:
                best = (key, (arch, cell, cap, source))
        return best[1]


_TABLES: dict[Path, CapacityTable] = {}


def capacity_table(results_dir=None) -> CapacityTable:
    """Shared per-directory CapacityTable (loaded once, cached)."""
    key = (Path(results_dir) if results_dir else RESULTS / "dryrun").resolve()
    if key not in _TABLES:
        _TABLES[key] = CapacityTable(key)
    return _TABLES[key]


def size_fleet(sc: Scenario, n_users: float = 1e6,
               duty: float = 0.35, results_dir=None) -> list[dict]:
    """Pods needed to serve n_users wearables in scenario `sc`.

    duty = fraction of the day streams are active; the scenario's own
    upload_duty gating throttles ingest on top, as in `pods_breakdown`.
    Rows sized from the fallback capacity carry
    note="missing_artifact"; pods are always finite."""
    _check_fleet_args(n_users, duty)
    rows = []
    eff_duty = duty * getattr(sc, "upload_duty", 1.0)
    table = capacity_table(results_dir)
    for d in backend_demand(sc):
        if not d.offloaded:
            rows.append({"stream": d.stream, "arch": d.arch,
                         "pods": 0.0, "note": "computed on-device"})
            continue
        demand = n_users * eff_duty * d.tokens_per_user_s
        if d.stream == "rgb":           # frame-driven VLM ingest
            demand /= max(sc.fps_scale, 1.0)
        arch, cell, cap, source = table.resolve(
            STREAM_CANDIDATES.get(d.stream, ((d.arch, d.cell),)))
        row = {
            "stream": d.stream, "arch": arch, "cell": cell,
            "tokens_per_s": demand,
            "pod_tokens_per_s": round(cap, 1),
            "pods": round(demand / cap, 1),
        }
        if source == "fallback":
            row["note"] = "missing_artifact"    # sized from FALLBACK_BOUND_S
        rows.append(row)
    return rows


def offload_summary(sc: Scenario, device="cuda") -> dict:
    """Device-side uplink vs backend-side ingest for a scenario."""
    return {
        "scenario": sc.name,
        "uplink_mbps": round(float(aria2.offloaded_mbps(sc, device)), 2),
        "device_mw": round(float(aria2.total_mw(sc, device=device)), 1),
        "backend": [d.__dict__ for d in backend_demand(sc)],
    }


@dataclass
class PodsBreakdown:
    """Vectorized fleet sizing with per-stream pod components.

    Arrays share the ScenarioSet's leading dim N.  `active[s][i]` is True
    where stream s reaches the backend for design point i (audio only
    when ASR is off-device), so fallback capacities of inactive streams
    raise no ``missing_artifact`` flag."""
    pods: np.ndarray                # (N,) total backend pods
    by_stream: dict                 # stream -> (N,) pods
    archs: dict                     # stream -> chosen serving arch
    cells: dict                     # stream -> shape cell of that arch
    sources: dict                   # stream -> "dryrun" | "fallback"
    active: dict = field(default_factory=dict)   # stream -> (N,) bool

    def missing_streams(self) -> list[str]:
        """Fallback-sized streams that are active in >= 1 design point."""
        return [s for s, src in self.sources.items()
                if src == "fallback" and bool(np.any(self.active[s]))]

    def missing_row(self, i: int) -> list[str]:
        """Fallback-sized streams active for design point i."""
        return [s for s, src in self.sources.items()
                if src == "fallback" and bool(self.active[s][i])]

    def row(self, i: int) -> dict:
        """stream -> pods for design point i (rounded display values)."""
        return {s: round(float(p[i]), 1) for s, p in self.by_stream.items()}


def pods_breakdown(sset: ScenarioSet, n_users: float = 1e6,
                   duty: float = 0.35, results_dir=None) -> PodsBreakdown:
    """Per-stream backend pods for a whole ScenarioSet, numpy float64 on
    the host (no loop over scenarios): each stream's min-pods
    STREAM_CANDIDATES cell, audio masked where ASR runs on-device,
    upload_duty gating ingest, RGB->VLM ingest scaled down with the
    frame-rate knob."""
    _check_fleet_args(n_users, duty)
    table = capacity_table(results_dir)
    asr_on = np.asarray(sset.placement, np.float64)[
        :, sset.primitives.index("asr")]
    fps = np.maximum(np.asarray(sset.fps_scale, np.float64), 1.0)
    gate = n_users * duty * np.asarray(sset.upload_duty, np.float64)
    ones = np.ones(len(sset), np.float64)
    by, archs, cells, sources, active = {}, {}, {}, {}, {}
    for s, (arch0, cell0, tok) in STREAM_SERVICE.items():
        arch, cell, cap, source = table.resolve(
            STREAM_CANDIDATES.get(s, ((arch0, cell0),)))
        archs[s], cells[s], sources[s] = arch, cell, source
        if s == "rgb":
            by[s] = gate * (tok / cap) / fps
            active[s] = ones > 0.0
        elif s == "audio":
            by[s] = gate * (tok / cap) * (1.0 - asr_on)
            active[s] = asr_on < 0.5
        else:
            by[s] = gate * (tok / cap) * ones
            active[s] = ones > 0.0
    pods = np.sum(np.stack(list(by.values())), axis=0)
    return PodsBreakdown(pods, by, archs, cells, sources, active)


def pods_relaxed(vec: dict, n_users: float = 1e6, duty: float = 0.35,
                 results_dir=None, primitives=None):
    """Differentiable fleet sizing over a RELAXED knob vector.

    The smooth counterpart of `pods_breakdown` for the gradient path
    (`scenarios.evaluate_relaxed` vecs): the audio stream is gated by
    the ASR placement *probability* (exact at binary points), RGB->VLM
    ingest scales with the continuous fps knob, and upload_duty gates
    everything, so autograd sees how a design move shifts backend pods.
    Capacities come from the same cached CapacityTable; returns a tensor
    with the vec's leading shape."""
    _check_fleet_args(n_users, duty)
    prim = primitives or PRIMITIVES
    table = capacity_table(results_dir)
    asr_p = vec["placement"][..., prim.index("asr")]
    fps = scenarios._maximum(vec["fps_scale"], 1.0)
    gate = n_users * duty * vec["upload_duty"]
    pods = 0.0
    for s, (arch0, cell0, tok) in STREAM_SERVICE.items():
        _, _, cap, _ = table.resolve(
            STREAM_CANDIDATES.get(s, ((arch0, cell0),)))
        if s == "rgb":
            pods = pods + gate * (tok / cap) / fps
        elif s == "audio":
            pods = pods + gate * (tok / cap) * (1.0 - asr_p)
        else:
            pods = pods + gate * (tok / cap)
    return pods


def pods_vector(sset: ScenarioSet, n_users: float = 1e6, duty: float = 0.35,
                results_dir=None) -> tuple[np.ndarray, dict]:
    """((N,) backend pods, stream -> "dryrun" | "fallback") for a whole
    ScenarioSet (see `pods_breakdown`)."""
    bd = pods_breakdown(sset, n_users, duty, results_dir)
    return bd.pods, bd.sources


def missing_streams(sources: dict) -> list[str]:
    """Streams whose capacity came from the fallback path (the raw
    per-source view; `PodsBreakdown.missing_streams` knows which are
    active)."""
    return [s for s, src in sources.items() if src == "fallback"]


def fleet_grid(sset: ScenarioSet, n_users: float = 1e6, duty: float = 0.35,
               results_dir=None, platform=None, device="cuda") -> list[dict]:
    """Fleet sizing for a whole ScenarioSet off one batched evaluation
    on `device`: device power, gated uplink, total backend pods and the
    per-stream pods of each scenario."""
    plat = platform or aria2.aria2_platform()
    rep = scenarios.evaluate(plat, sset, device=device)
    totals = rep.total_mw.cpu().numpy()
    mbps = rep.offloaded_mbps.cpu().numpy()
    bd = pods_breakdown(sset, n_users, duty, results_dir)
    out = []
    for i in range(len(sset)):
        missing = bd.missing_row(i)
        out.append({
            "scenario": sset.label(i),
            "device_mw": round(float(totals[i]), 1),
            "uplink_mbps": round(float(mbps[i]), 2),
            "backend_pods": round(float(bd.pods[i]), 1),
            "pods_by_stream": bd.row(i),
            **({"note": "missing_artifact:" + "+".join(missing)}
               if missing else {}),
        })
    return out


def stream_rates(results_dir=None) -> dict:
    """Host-resolved per-stream serving rates for the device pods path.

    Returns {"streams": tuple, "tok_per_cap": (S,) float64,
    "archs"/"cells"/"sources": dicts}, in `STREAM_SERVICE` order."""
    table = capacity_table(results_dir)
    streams, rates, archs, cells, sources = [], [], {}, {}, {}
    for s, (arch0, cell0, tok) in STREAM_SERVICE.items():
        arch, cell, cap, source = table.resolve(
            STREAM_CANDIDATES.get(s, ((arch0, cell0),)))
        streams.append(s)
        rates.append(tok / cap)
        archs[s], cells[s], sources[s] = arch, cell, source
    return {"streams": tuple(streams),
            "tok_per_cap": np.asarray(rates, np.float64),
            "archs": archs, "cells": cells, "sources": sources}


def pods_streams_device(asr_on, fps_scale, upload_duty, tok_per_cap,
                        gate_scale):
    """Batched per-stream backend pods on tensors.

    `gate_scale` is the `n_users * duty` prefactor (0-dim tensor),
    `tok_per_cap` the (S,) rates from `stream_rates`, `asr_on` /
    `fps_scale` / `upload_duty` per-row (R,) knob columns.  Returns
    ((R,) total pods, (R, S) per-stream pods).  The audio stream is
    masked where ASR runs on-device and RGB->VLM ingest scales down with
    the frame-rate knob."""
    gate = gate_scale * upload_duty
    fps = torch.clamp_min(fps_scale, 1.0)
    cols = []
    for si, s in enumerate(STREAM_SERVICE):
        x = gate * tok_per_cap[si]
        if s == "rgb":
            x = x / fps
        elif s == "audio":
            x = x * (1.0 - asr_on)
        cols.append(x)
    pods_stream = torch.stack(cols, dim=-1)
    return torch.sum(pods_stream, dim=-1), pods_stream
