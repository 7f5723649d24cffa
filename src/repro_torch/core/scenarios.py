"""`ScenarioSet` batch API + the batched torch evaluation engine.

Scenarios are encoded struct-of-arrays: a placement mask over the
platform's egocentric primitives plus per-scenario knobs (compression,
fps_scale, WiFi MCS tier, upload duty / VAD gating, display brightness).
`batched_fn(platform)` maps a whole batch of knob rows (a leading row
axis on every tensor) to per-component loads, delivered totals (incl.
power-delivery losses) and uplink rates in float32, one tensor op per
load-rule term: the row axis is written out where the reference package
maps a single-row function over the batch.

    platform = aria2.aria2_platform()
    sset = ScenarioSet.grid()                    # 768 design points
    rep = evaluate(platform, sset, device="cuda")
    rep.total_mw                                 # (768,) tensor
    rep.category_breakdown()["wireless"]         # (768,) tensor

Every expression keeps the reference engine's operation order.  Where
a Python number is the dividend it is lifted to a tensor first
(`_rdiv`): `number / tensor` in PyTorch is a reciprocal times a product,
which rounds differently from the division the reference performs.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, replace as _dc_replace

import numpy as np
import torch

from .. import device as _device
from .platform import PRIMITIVES, PlatformSpec

# WiFi MCS tiers: (name, energy-per-bit scale, link-maintenance scale)
# relative to the MCS8 calibration point. Lower-order modulations spend
# less energy per bit and idle cheaper; 256-QAM buys peak rate at a
# link-power premium.
MCS_TIERS = (
    ("mcs2_qpsk", 0.62, 0.82),
    ("mcs8_baseline", 1.00, 1.00),
    ("mcs11_256qam", 1.38, 1.17),
)
DEFAULT_MCS = 1                         # mcs8: the paper's operating point

_MCS_EBIT = np.array([t[1] for t in MCS_TIERS], np.float32)
_MCS_LINK = np.array([t[2] for t in MCS_TIERS], np.float32)

# default DSE grid axes (paper Fig 4 x Fig 6)
GRID_COMPRESSIONS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
GRID_FPS_SCALES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


def _unit_knob(name: str, value):
    """Validate a [0, 1] fraction knob (scalar or array)."""
    arr = np.asarray(value, np.float64)
    if arr.size and (np.any(arr < 0.0) or np.any(arr > 1.0)):
        raise ValueError(f"{name} must be within [0, 1], got "
                         f"{float(arr.min())}..{float(arr.max())}")
    return value


def all_placements(primitives=PRIMITIVES) -> tuple:
    """All 2^n on-device subsets, in the paper's sweep order (by size)."""
    out = []
    for r in range(len(primitives) + 1):
        out.extend(itertools.combinations(primitives, r))
    return tuple(out)


@dataclass(frozen=True)
class ScenarioSet:
    """Struct-of-arrays scenario batch (all arrays share leading dim N)."""
    placement: np.ndarray           # (N, n_primitives) 0/1 mask
    compression: np.ndarray         # (N,)
    fps_scale: np.ndarray           # (N,)
    mcs_tier: np.ndarray            # (N,) int index into MCS_TIERS
    upload_duty: np.ndarray         # (N,) fraction of time uplink streams
    brightness: np.ndarray          # (N,) display brightness 0..1
    names: tuple = ()
    primitives: tuple = PRIMITIVES

    def __len__(self) -> int:
        return int(self.placement.shape[0])

    def vec(self, device="cuda") -> dict:
        """The engine's batched knob vector (dict of tensors)."""
        dev = _device.resolve(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return {
            "placement": f32(self.placement),
            "compression": f32(self.compression),
            "fps_scale": f32(self.fps_scale),
            "mcs_tier": torch.as_tensor(np.asarray(self.mcs_tier, np.int64),
                                        device=dev),
            "upload_duty": f32(self.upload_duty),
            "brightness": f32(self.brightness),
        }

    def on_device(self, i: int) -> tuple:
        return tuple(p for j, p in enumerate(self.primitives)
                     if self.placement[i, j] > 0.5)

    def label(self, i: int) -> str:
        if self.names and i < len(self.names) and self.names[i]:
            return self.names[i]
        return "+".join(self.on_device(i)) or "(none)"

    # -- constructors -------------------------------------------------------
    @classmethod
    def build(cls, rows: list, primitives=PRIMITIVES) -> "ScenarioSet":
        """rows: dicts with on_device/compression/fps_scale/... knobs."""
        n = len(rows)
        pl = np.zeros((n, len(primitives)), np.float32)
        comp = np.ones(n, np.float32)
        fps = np.ones(n, np.float32)
        mcs = np.full(n, DEFAULT_MCS, np.int32)
        duty = np.ones(n, np.float32)
        bright = np.zeros(n, np.float32)
        names = []
        for i, r in enumerate(rows):
            for p in r.get("on_device", ()):
                if p not in primitives:
                    raise ValueError(f"unknown primitive {p!r}; "
                                     f"one of {primitives}")
                pl[i, primitives.index(p)] = 1.0
            comp[i] = r.get("compression", 10.0)
            fps[i] = r.get("fps_scale", 1.0)
            tier = int(r.get("mcs_tier", DEFAULT_MCS))
            if not 0 <= tier < len(MCS_TIERS):
                raise ValueError(f"mcs_tier {tier} out of range "
                                 f"[0, {len(MCS_TIERS)})")
            mcs[i] = tier
            duty[i] = _unit_knob("upload_duty", r.get("upload_duty", 1.0))
            bright[i] = _unit_knob("brightness", r.get("brightness", 0.0))
            names.append(r.get("name", ""))
        return cls(pl, comp, fps, mcs, duty, bright, tuple(names),
                   primitives)

    @classmethod
    def from_scenarios(cls, scenarios, primitives=PRIMITIVES):
        """From `aria2.Scenario` objects."""
        return cls.build([{
            "name": s.name, "on_device": s.on_device,
            "compression": s.compression, "fps_scale": s.fps_scale,
            "mcs_tier": getattr(s, "mcs_tier", DEFAULT_MCS),
            "upload_duty": getattr(s, "upload_duty", 1.0),
            "brightness": getattr(s, "brightness", 0.0),
        } for s in scenarios], primitives)

    @classmethod
    def grid(cls, placements=None, compressions=GRID_COMPRESSIONS,
             fps_scales=GRID_FPS_SCALES, mcs_tiers=(DEFAULT_MCS,),
             upload_duties=(1.0,), brightnesses=(0.0,),
             primitives=PRIMITIVES) -> "ScenarioSet":
        """Cartesian product over knob axes (placement outermost)."""
        placements = (all_placements(primitives) if placements is None
                      else tuple(placements))
        rows = [{"on_device": p, "compression": float(c),
                 "fps_scale": float(f), "mcs_tier": int(m),
                 "upload_duty": float(u), "brightness": float(b)}
                for p in placements for c in compressions
                for f in fps_scales for m in mcs_tiers
                for u in upload_duties for b in brightnesses]
        return cls.build(rows, primitives)

    def take(self, idx) -> "ScenarioSet":
        """Row subset (or reorder) by integer indices or a boolean mask
        (e.g. a Pareto front_mask), names included."""
        idx = np.asarray(idx)
        idx = (np.flatnonzero(idx) if idx.dtype == bool
               else idx.astype(np.int64))
        if idx.size and (idx.min() < -len(self) or idx.max() >= len(self)):
            raise IndexError(f"take indices out of range for "
                             f"{len(self)}-row ScenarioSet")
        names = tuple(self.names[i] for i in idx) if self.names else ()
        return _dc_replace(
            self, placement=self.placement[idx],
            compression=self.compression[idx],
            fps_scale=self.fps_scale[idx], mcs_tier=self.mcs_tier[idx],
            upload_duty=self.upload_duty[idx],
            brightness=self.brightness[idx], names=names)

    def pad(self, n_rows: int) -> "ScenarioSet":
        """Pad up to ``n_rows`` by repeating row 0 (canonical shape
        bucketing: the clone rows are valid scenarios, and callers never
        index past the real rows).  No-op when already ``n_rows`` long."""
        n = len(self)
        if n_rows < n:
            raise ValueError(f"pad target {n_rows} < {n} real rows")
        if n_rows == n or n == 0:
            return self
        idx = np.concatenate([np.arange(n),
                              np.zeros(n_rows - n, np.int64)])
        padded = self.take(idx)
        if self.names:
            return _dc_replace(padded, names=tuple(self.names)
                               + ("",) * (n_rows - n))
        return padded

    def row_matrix(self) -> np.ndarray:
        """(N, n_prim + 5) float64 matrix of every knob column, the
        canonical row identity used for deduplication."""
        return np.column_stack([
            np.asarray(self.placement, np.float64),
            np.asarray(self.compression, np.float64),
            np.asarray(self.fps_scale, np.float64),
            np.asarray(self.mcs_tier, np.float64),
            np.asarray(self.upload_duty, np.float64),
            np.asarray(self.brightness, np.float64)])

    def dedupe(self) -> tuple:
        """(unique ScenarioSet, inverse indices): `inverse` maps every
        original row to its unique representative, so
        `evaluate(plat, unique).total_mw[inverse]` recovers the full
        batch from one call on the unique rows."""
        _, first, inverse = np.unique(self.row_matrix(), axis=0,
                                      return_index=True,
                                      return_inverse=True)
        return self.take(first), inverse.reshape(-1)

    def with_knob(self, **arrays) -> "ScenarioSet":
        """Replace whole knob columns (broadcast scalars over N)."""
        n = len(self)
        if "mcs_tier" in arrays:
            tiers = np.asarray(arrays["mcs_tier"])
            if tiers.min() < 0 or tiers.max() >= len(MCS_TIERS):
                raise ValueError(f"mcs_tier out of range "
                                 f"[0, {len(MCS_TIERS)})")
        for knob in ("upload_duty", "brightness"):
            if knob in arrays:
                _unit_knob(knob, arrays[knob])
        upd = {k: np.broadcast_to(np.asarray(v, np.float32), (n,)).copy()
               if k != "mcs_tier"
               else np.broadcast_to(np.asarray(v, np.int32), (n,)).copy()
               for k, v in arrays.items()}
        return _dc_replace(self, **upd)


# ---------------------------------------------------------------------------
# derived per-scenario features feeding the load rules
# ---------------------------------------------------------------------------

@dataclass
class Features:
    """(R,) float32 tensors derived from a batch of knob rows."""
    vio: torch.Tensor
    et: torch.Tensor
    asr: torch.Tensor
    ht: torch.Tensor
    n_on: torch.Tensor
    compression: torch.Tensor
    fps_scale: torch.Tensor
    fps_f: torch.Tensor             # sensor static-power factor
    mbps: torch.Tensor              # instantaneous uplink rate
    mbps_eff: torch.Tensor          # duty-gated average uplink rate
    codec_raw: torch.Tensor         # raw pixel rate entering the codec
    raw_visual: torch.Tensor        # raw visual traffic (DRAM)
    isp_duty: torch.Tensor
    duty_npu: torch.Tensor          # placement-indexed sim duties feeding
    duty_dsp: torch.Tensor          # the queue_mw_per_duty contention
    duty_dram: torch.Tensor         # terms (queueing effects)
    upload_duty: torch.Tensor
    brightness: torch.Tensor
    mcs_ebit_scale: torch.Tensor
    mcs_link_scale: torch.Tensor
    r_npu_ht: float                 # platform GFLOP/s x primitive constants
    r_npu_et: float
    r_hwa_vio: float
    r_dsp_asr: float


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of an (R, C) tensor, each independent of its
    row's position in the batch.  On the card a reduction over the last
    axis reads a row in 16-byte vectors from the row's first aligned
    address, so with a row stride of C floats (147 components on the
    SKUs) a row's sum order, and its last bit, followed its index: the
    same scenario row gave another total in another batch.  The rows are
    copied into a buffer whose row stride is a multiple of 4 floats, so
    every row starts aligned; the CPU sums a row the same way either
    way.  Verified with torch 2.11.0+cu128 on an H100;
    tests/test_torch_kernels_cuda.py holds rows at shifted positions to
    their own bits."""
    r, c = x.shape
    buf = x.new_zeros((r, -(-c // 4) * 4))
    buf[:, :c] = x
    return torch.sum(buf[:, :c], dim=1)


@functools.lru_cache(maxsize=None)
def _scalar(c: float) -> torch.Tensor:
    """`c` as a 0-dim float64 CPU tensor: an operand that a binary op on
    any device takes as a scalar (no copy, no extra launch), cast to the
    other operand's float width as a Python number would be."""
    return torch.tensor(c, dtype=torch.float64)


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """`max(x, c)` whose gradient splits evenly at a tie, as the
    reference's `jnp.maximum` does (a clamp passes all of it): the relaxed
    engine differentiates through it at fps_scale = 1."""
    return torch.maximum(x, _scalar(c))


def _minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """`min(x, c)` with the reference's tie gradient (see `_maximum`)."""
    return torch.minimum(x, _scalar(c))


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """float32 `num / den` for a Python-number dividend, as a true
    division (see the module note)."""
    return torch.full_like(den, num) / den


def _features_core(platform: PlatformSpec, on, c, fs, duty, brightness,
                   duty_of, mcs_ebit, mcs_link) -> Features:
    """Knob->feature math over a row batch (`on` is (R, n_prim) 0/1)."""
    R = dict(platform.raw_mbps)
    rates = dict(platform.ip_rates)
    prim = platform.primitives
    vio = on[:, prim.index("vio")]
    et = on[:, prim.index("eye_tracking")]
    asr = on[:, prim.index("asr")]
    ht = on[:, prim.index("hand_tracking")]
    n_on = torch.sum(on, dim=-1)
    fps_f = 0.35 + _rdiv(0.65, fs)

    # outward GS cameras: consumed on-device by HT(+VIO), else offloaded
    gs_off = (1.0 - ht) * R["gs"] + ht * (1.0 - vio) * R["gs_vio_share"]
    visual_off = R["rgb"] + gs_off + (1.0 - et) * R["et"]
    mbps = (visual_off / (c * fs) + (1.0 - asr) * R["audio_opus"]
            + R["imu"] + R["aux"] + R["signals"] * n_on)
    codec_raw = visual_off / fs
    raw_visual = _rdiv(R["rgb"] + R["gs"] + R["et"], fs)

    return Features(
        vio=vio, et=et, asr=asr, ht=ht, n_on=n_on, compression=c,
        fps_scale=fs, fps_f=fps_f, mbps=mbps, mbps_eff=mbps * duty,
        codec_raw=codec_raw, raw_visual=raw_visual,
        isp_duty=duty_of("isp", 1.0),
        duty_npu=duty_of("npu", 0.0), duty_dsp=duty_of("dsp", 0.0),
        duty_dram=duty_of("dram_bus", 0.0),
        upload_duty=duty, brightness=brightness,
        mcs_ebit_scale=mcs_ebit, mcs_link_scale=mcs_link,
        r_npu_ht=rates.get("npu_ht", 0.0), r_npu_et=rates.get("npu_et", 0.0),
        r_hwa_vio=rates.get("hwa_vio", 0.0),
        r_dsp_asr=rates.get("dsp_asr", 0.0))


def _features(platform: PlatformSpec, vec: dict, tabs: dict) -> Features:
    """Int-indexed feature path; `tabs` holds the platform's duty and
    MCS tables on the batch's device (see `_tables`)."""
    on = vec["placement"]
    # placement-mask index -> per-resource duty from the event-driven
    # taskgraph sim (ISP duty rule + NPU/DSP/DRAM contention terms)
    idx = torch.round(torch.sum(on * tabs["bits"], dim=-1)).long()

    def duty_of(resource, default):
        return tabs["duty"][resource][idx]

    mcs = vec["mcs_tier"]
    return _features_core(
        platform, on, vec["compression"], vec["fps_scale"],
        vec["upload_duty"], vec["brightness"], duty_of,
        tabs["mcs_ebit"][mcs], tabs["mcs_link"][mcs])


# ---------------------------------------------------------------------------
# load-rule implementations (platform.LOAD_KIND_NAMES)
# ---------------------------------------------------------------------------

def _npu(p, f, th):
    any_on = torch.maximum(f.ht, f.et)
    active = (th["ip_idle_mw"] + f.ht * f.r_npu_ht * th["pj_ht"]
              + f.et * f.r_npu_et * th["pj_et"])
    # queueing overhead: frame-driven NPU duty from the taskgraph sim
    # (shared by HT + ET nets), scaled down with the frame rate
    queue = th["queue_mw_per_duty"] * f.duty_npu \
        / _maximum(f.fps_scale, 1.0)
    return any_on * active + (1.0 - any_on) * p["off_mw"] + queue


# kind -> fn(params, features, theta) -> (R,) mW; "const" is filled from
# the platform's constant row in `batched_fn` instead (no per-row math)
LOAD_KINDS = {
    "sensor_fps": lambda p, f, th: p["mw"] * f.fps_f,
    "isp": lambda p, f, th: (p["active_mw"] * f.isp_duty
                             / _maximum(f.fps_scale, 1.0)
                             + p["floor_mw"]),
    "codec": lambda p, f, th: (th["codec_mw_per_rawmbps"] * f.codec_raw
                               + p["floor_mw"]),
    "dsp_audio": lambda p, f, th: (p["base_mw"]
                                   + f.asr * f.r_dsp_asr * th["pj_asr"]
                                   + (1.0 - f.asr) * p["idle_mw"]
                                   + th["queue_mw_per_duty"] * f.duty_dsp),
    "npu": _npu,
    "hwa_vio": lambda p, f, th: (f.vio * (th["ip_idle_mw"]
                                          + f.r_hwa_vio * th["pj_vio"])
                                 + (1.0 - f.vio) * p["off_mw"]),
    "dram": lambda p, f, th: (p["base_mw"]
                              + th["dram_mw_per_mbps"] * f.raw_visual / 8.0
                              + th["queue_mw_per_duty"] * f.duty_dram
                              / _maximum(f.fps_scale, 1.0)),
    "wifi": lambda p, f, th: (th["wifi_link_mw"] * f.mcs_link_scale
                              + th["wifi_mw_per_mbps"] * f.mcs_ebit_scale
                              * f.mbps_eff),
    "display": lambda p, f, th: p["base_mw"] + p["max_mw"] * f.brightness,
}


# ---------------------------------------------------------------------------
# batched engine (one per platform, cached)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _tables(platform: PlatformSpec, device: torch.device) -> dict:
    """Per-(platform, device) constant tensors of the engine."""
    comps = platform.components
    rails = platform.rail_dict()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    const = [c.load.p()["mw"] if c.load.kind == "const" else 0.0
             for c in comps]
    return {
        "bits": f32([1 << i for i in range(len(platform.primitives))]),
        "duty": {r: f32(platform.duty_table(r, d)) for r, d in
                 (("isp", 1.0), ("npu", 0.0), ("dsp", 0.0),
                  ("dram_bus", 0.0))},
        "mcs_ebit": f32(_MCS_EBIT), "mcs_link": f32(_MCS_LINK),
        "rail_eff": f32([rails[c.rail] for c in comps]),
        "const_row": f32(const),
    }


@functools.lru_cache(maxsize=32)
def _rules(platform: PlatformSpec) -> tuple:
    """(column, load rule, params) of every non-constant component."""
    return tuple((j, LOAD_KINDS[c.load.kind], c.load.p())
                 for j, c in enumerate(platform.components)
                 if c.load.kind != "const")


@functools.lru_cache(maxsize=32)
def batched_fn(platform: PlatformSpec):
    """Batched engine core for one platform.

    The returned `fn(vec, th) -> {"loads", "pd_loss", "total", "mbps"}`
    takes a knob-vector dict of (R, ...) tensors (`ScenarioSet.vec`) and
    a theta dict of 0-dim float32 tensors (`_theta`) on one device, and
    returns (R, C) loads and (R,) totals / PD losses / gated uplink."""
    rules = _rules(platform)

    def fn(vec, th):
        tabs = _tables(platform, vec["compression"].device)
        return _row_loads(rules, _features(platform, vec, tabs), th, tabs,
                          vec["compression"].shape[0])

    return fn


def _row_loads(rules: tuple, f: Features, th: dict, tabs: dict,
               n: int) -> dict:
    """Features of n rows -> {"loads", "pd_loss", "total", "mbps"}: the
    load rules (`_rules`), the rail losses and the row sums, shared by
    the hard and the relaxed engines (so both give the same bits at
    binary rows)."""
    cols = list(tabs["const_row"].expand(n, tabs["const_row"].shape[0])
                .unbind(1))
    for j, rule, p in rules:
        cols[j] = rule(p, f, th)
    loads = torch.stack(cols, dim=1)
    eff = _minimum(tabs["rail_eff"] * th["eff_scale"], 0.97)
    delivered = loads / eff
    return {"loads": loads,
            "pd_loss": torch.sum(delivered - loads, dim=1),
            "total": _row_sums(delivered), "mbps": f.mbps_eff}


def _theta(platform: PlatformSpec, theta=None, device="cuda") -> dict:
    """Platform theta merged with overrides, as 0-dim float32 tensors.
    An override that is already a tensor is cast, not copied, so
    autograd reaches it (`dse.sensitivity`)."""
    dev = _device.resolve(device)
    th = platform.theta_dict()
    if theta:
        th.update(theta)
    return {k: v.to(device=dev, dtype=torch.float32)
            if isinstance(v, torch.Tensor)
            else torch.tensor(float(np.float32(v)), dtype=torch.float32,
                              device=dev) for k, v in th.items()}


def evaluate_batched(platform: PlatformSpec, vec: dict, theta=None) -> dict:
    """Batch evaluation on a raw knob vector (`ScenarioSet.vec`), on the
    vector's device: {"loads": (N, C), "pd_loss": (N,), "total": (N,),
    "mbps": (N,)}.  Theta overrides may be tensors."""
    return batched_fn(platform)(
        vec, _theta(platform, theta, vec["compression"].device))


@dataclass
class BatchReport:
    """Batched evaluation result; all tensors have leading dim N."""
    platform: PlatformSpec
    sset: ScenarioSet
    loads_mw: torch.Tensor          # (N, n_components)
    total_mw: torch.Tensor          # (N,)
    pd_loss_mw: torch.Tensor        # (N,)
    offloaded_mbps: torch.Tensor    # (N,)

    def category_breakdown(self) -> dict:
        """category -> (N,) mW; PD losses land under "power" (Fig 3).
        Each category sums its own columns (the reference's product with
        a 0/1 mask, without a matrix product that the card could run in
        TF32)."""
        out: dict = {}
        cats = np.array([c.category for c in self.platform.components])
        for cat in sorted(set(cats)):
            idx = torch.as_tensor(np.flatnonzero(cats == cat),
                                  device=self.loads_mw.device)
            out[cat] = torch.sum(self.loads_mw[:, idx], dim=1)
        out["power"] = out.get("power", 0.0) + self.pd_loss_mw
        return out

    def pd_share(self) -> torch.Tensor:
        return self.pd_loss_mw / self.total_mw

    def component_loads(self, i: int) -> dict:
        names = self.platform.component_names()
        row = self.loads_mw[i].detach().cpu().numpy()
        return dict(zip(names, row.tolist()))

    def rows(self) -> list:
        """Host-side summary rows (one copy to the host for the batch)."""
        total = self.total_mw.detach().cpu().numpy()
        mbps = self.offloaded_mbps.detach().cpu().numpy()
        return [{"name": self.sset.label(i),
                 "on_device": "+".join(self.sset.on_device(i)) or "(none)",
                 "compression": float(self.sset.compression[i]),
                 "fps_scale": float(self.sset.fps_scale[i]),
                 "total_mw": float(total[i]),
                 "offload_mbps": float(mbps[i])}
                for i in range(len(self.sset))]


def _validate(platform: PlatformSpec, sset: ScenarioSet) -> None:
    if sset.primitives != platform.primitives:
        raise ValueError(
            f"ScenarioSet primitives {sset.primitives} do not match "
            f"platform {platform.name!r} primitives {platform.primitives}")
    supported = set(platform.supported_primitives())
    for j, p in enumerate(platform.primitives):
        if p not in supported and np.any(np.asarray(sset.placement)[:, j]):
            raise ValueError(
                f"platform {platform.name!r} cannot run {p!r} on-device "
                f"(its accelerator was dropped from the component table); "
                f"supported: {sorted(supported)}")


def evaluate(platform: PlatformSpec, sset: ScenarioSet, theta=None,
             device="cuda") -> BatchReport:
    """Evaluate the whole scenario batch in one batched pass."""
    _validate(platform, sset)
    out = batched_fn(platform)(sset.vec(device),
                               _theta(platform, theta, device))
    return BatchReport(platform, sset, out["loads"], out["total"],
                       out["pd_loss"], out["mbps"])


def total_mw(platform: PlatformSpec, sset: ScenarioSet, theta=None,
             device="cuda") -> torch.Tensor:
    """(N,) delivered system power."""
    return evaluate(platform, sset, theta, device).total_mw


def component_loads(platform: PlatformSpec, sset: ScenarioSet, theta=None,
                    device="cuda") -> torch.Tensor:
    """(N, n_components) component loads (pre-PD), names aligned."""
    return evaluate(platform, sset, theta, device).loads_mw


def offloaded_mbps(platform: PlatformSpec, sset: ScenarioSet, theta=None,
                   device="cuda") -> torch.Tensor:
    """(N,) duty-gated average uplink rate."""
    return evaluate(platform, sset, theta, device).offloaded_mbps


def category_breakdown(platform: PlatformSpec, sset: ScenarioSet,
                       theta=None, device="cuda") -> dict:
    return evaluate(platform, sset, theta, device).category_breakdown()


# ---------------------------------------------------------------------------
# relaxed (differentiable-in-every-knob) evaluation
# ---------------------------------------------------------------------------

RELAXED_KEYS = ("placement", "compression", "fps_scale", "mcs_weights",
                "upload_duty", "brightness")


@functools.lru_cache(maxsize=64)
def _relaxed_tables(platform: PlatformSpec, device: torch.device,
                    dtype: torch.dtype) -> dict:
    """The relaxed engine's constants in the batch's float width: the
    (2^n, n) mask enumeration in placement-index order, the duty tables,
    and the MCS scales, rail efficiencies and constant loads at their
    float32 values (as the reference holds them) widened to `dtype`."""
    n_prim = len(platform.primitives)
    f32 = _tables(platform, device)

    def wide(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=device).to(dtype)

    return {
        "masks": wide([[idx >> j & 1 for j in range(n_prim)]
                       for idx in range(1 << n_prim)]),
        "duty": {r: wide(platform.duty_table(r, d)) for r, d in
                 (("isp", 1.0), ("npu", 0.0), ("dsp", 0.0),
                  ("dram_bus", 0.0))},
        **{k: f32[k].to(dtype) for k in ("mcs_ebit", "mcs_link",
                                         "rail_eff", "const_row")},
    }


def _features_relaxed(platform: PlatformSpec, vec: dict,
                      tabs: dict) -> Features:
    """Differentiable feature path over relaxed (soft) discrete knobs.

    `placement` holds per-primitive on-device probabilities; the
    placement-indexed duty tables are interpolated multilinearly — the
    exact expectation over the product-Bernoulli placement distribution,
    which reduces to plain indexing at binary probabilities (every
    weight is then an exact 0 or 1).  MCS scales are mixed by
    `mcs_weights` (one-hot == the int path's lookup).  The weighted
    sums are products and a sum, never a matrix product, which the card
    could run in TF32."""
    on = vec["placement"]
    masks = tabs["masks"]
    w = torch.prod(on[:, None, :] * masks
                   + (1.0 - on[:, None, :]) * (1.0 - masks), dim=-1)

    def duty_of(resource, default):
        return torch.sum(w * tabs["duty"][resource], dim=-1)

    mw = vec["mcs_weights"]
    return _features_core(
        platform, on, vec["compression"], vec["fps_scale"],
        vec["upload_duty"], vec["brightness"], duty_of,
        torch.sum(mw * tabs["mcs_ebit"], dim=-1),
        torch.sum(mw * tabs["mcs_link"], dim=-1))


@functools.lru_cache(maxsize=32)
def _engine_relaxed(platform: PlatformSpec):
    """Relaxed engine core for one platform: `fn(vec, th)` over a batch
    of relaxed knob rows (a leading row axis on every leaf, one float
    width) -> {"loads", "pd_loss", "total", "mbps"}, differentiable in
    every knob and in theta.  The load rules, rail losses and row sums
    are the hard engine's own (`_row_loads`)."""
    rules = _rules(platform)

    def fn(vec, th):
        x = vec["compression"]
        tabs = _relaxed_tables(platform, x.device, x.dtype)
        return _row_loads(rules, _features_relaxed(platform, vec, tabs),
                          th, tabs, x.shape[0])

    return fn


def relax_vec(sset: ScenarioSet, device="cuda") -> dict:
    """ScenarioSet -> relaxed float32 knob vector (hard rows as a special
    case).

    Placement becomes float probabilities (0/1 for a hard set), the MCS
    tier becomes a one-hot weight row — at these values the relaxed
    engine reproduces `evaluate` exactly."""
    dev = _device.resolve(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return {
        "placement": put(sset.placement),
        "compression": put(sset.compression),
        "fps_scale": put(sset.fps_scale),
        "upload_duty": put(sset.upload_duty),
        "brightness": put(sset.brightness),
        "mcs_weights": put(np.eye(len(MCS_TIERS))[
            np.asarray(sset.mcs_tier)]),
    }


def _validate_relaxed(platform: PlatformSpec, vec: dict) -> None:
    missing = set(RELAXED_KEYS) - set(vec)
    if missing:
        raise ValueError(f"relaxed vec missing knobs {sorted(missing)}")
    n_prim = len(platform.primitives)
    if vec["placement"].shape[-1] != n_prim:
        raise ValueError(
            f"placement last dim {vec['placement'].shape[-1]} != "
            f"platform {platform.name!r} primitive count {n_prim}")
    if vec["mcs_weights"].shape[-1] != len(MCS_TIERS):
        raise ValueError(f"mcs_weights last dim must be {len(MCS_TIERS)}")


def _theta_relaxed(platform: PlatformSpec, theta=None, device="cuda",
                   dtype=torch.float32) -> dict:
    """Theta merge that KEEPS each tensor leaf as it is (its dtype and
    its graph), unlike `_theta`, which casts to float32; Python numbers
    become 0-dim tensors of `dtype` (the batch's float width), so
    float64 finite differences run end to end."""
    dev = _device.resolve(device)
    th = platform.theta_dict()
    if theta:
        th.update(theta)
    return {k: v if isinstance(v, torch.Tensor)
            else torch.tensor(float(v), dtype=dtype, device=dev)
            for k, v in th.items()}


def evaluate_relaxed(platform: PlatformSpec, vec: dict,
                     theta=None) -> dict:
    """Batched relaxed evaluation on the vector's device, differentiable
    in EVERY knob (placement probabilities, compression, fps, duty,
    brightness, MCS weights) as well as theta.

    `vec` is the relaxed knob dict (see `relax_vec` /
    `design.device_vec`), all leaves sharing leading dim N.  Returns
    {"loads": (N, C), "total": (N,), "pd_loss": (N,), "mbps": (N,)}."""
    _validate_relaxed(platform, vec)
    x = vec["compression"]
    return _engine_relaxed(platform)(
        vec, _theta_relaxed(platform, theta, x.device, x.dtype))


def total_mw_relaxed(platform: PlatformSpec, vec: dict, theta=None):
    """(N,) delivered totals; autograd flows through every knob leaf —
    the substrate for `dse.sensitivity_map` and `dse.gradient_descend`."""
    return evaluate_relaxed(platform, vec, theta)["total"]
