"""Aria2 full-system architecture model (§IV-B) — 145-component inventory.

The inventory is **declarative platform data** (`platform.PlatformSpec`):
every mechanistic component (sensors per Table II, the coprocessor
complex, ML IPs, memories, WiFi combo, PMIC rails) is a `ComponentSpec`
whose load is a named `LoadRule` of the scenario knob vector and the
physical coefficient set THETA (energy/bit of the radio, pJ/FLOP per IP
class, codec energy/pixel, ...) which calibrate.py fits against the
paper's published aggregates (Fig 3/4, Table III, §VI-C).  A long tail
of small auxiliary parts (bridges, oscillators, load switches — §V-A3's
"129 components individually below 1%") completes the inventory.

Three platforms are registered:
  aria2               — the paper's baseline glasses,
  aria2_display       — + microLED display subsystem (brightness knob),
  aria2_capture_only  — low-power capture/offload SKU without ML IPs.

Scenario knobs (the design space):
  placements   — which egocentric primitives compute on-device,
  compression  — visual stream compression ratio (Fig 6),
  fps_scale    — sensor frame-rate reduction (Fig 6),
  mcs_tier     — WiFi modulation tier (scenarios.MCS_TIERS),
  upload_duty  — VAD/saliency-gated uplink duty cycle,
  brightness   — display brightness (display SKUs).

Batch evaluation goes through `scenarios.ScenarioSet` and
`scenarios.evaluate` (one batch of torch ops for a whole DSE grid); the
single-`Scenario` wrappers (`total_mw`, `component_loads`,
`offloaded_mbps`, `pd_share`, `build_system`) evaluate a batch of one.
The pre-redesign dict-based implementation survives as `legacy_*` — the
reference oracle for parity tests.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from . import workloads
from .platform import (PRIMITIVES, ComponentSpec, LoadRule, PlatformSpec,
                       register)
from .power import Component, Rail, SystemModel

# raw sensor data rates, Mbps (Table II; RGB after 2x2 binning, §V-A)
RAW_MBPS = {
    "rgb": 1440 * 1440 * 5 * 8 / 1e6,            # 82.94
    "gs": 4 * 640 * 480 * 30 * 8 / 1e6,          # 294.91
    "gs_vio_share": 4 * 640 * 480 * 10 * 8 / 1e6,  # VIO needs 10 of 30 fps
    "et": 2 * 320 * 240 * 30 * 8 / 1e6,          # 36.86
    "audio_opus": 2 * 0.128,                      # OPUS streams (§V-B)
    "imu": 2 * 800 * 6 * 16 / 1e6,
    "aux": 0.05,                                  # GNSS/mag/baro/telemetry
    "signals": 0.06,                              # egocentric signal upload
}

# calibration coefficients (fitted by calibrate.py; defaults = fitted values)
THETA0 = {
    "wifi_mw_per_mbps": 9.0,      # radio energy/bit at MCS8
    "wifi_link_mw": 95.0,         # link maintenance / beacons / RX listen
    "pj_ht": 15.0,                # NPU effective pJ/FLOP (hand tracking)
    "pj_et": 30.0,                # eye tracking (smaller net, worse amortize)
    "pj_vio": 5.0,                # 6DoF hardware IP
    "pj_asr": 30.0,               # audio DSP
    "ip_idle_mw": 4.0,            # per-enabled-IP idle/clock overhead
    "codec_mw_per_rawmbps": 0.085,  # H265 energy per raw pixel rate
    "dram_mw_per_mbps": 0.10,
    "queue_mw_per_duty": 40.0,    # active-clock overhead per unit of
                                  # sim duty (NPU/DSP/DRAM-bus contention);
                                  # pre-fit nominal — calibrated.json
                                  # carries the trace-fitted value
                                  # (calibrate.fit_queue_coeff)
    "eff_scale": 1.0,             # global PD-efficiency adjustment
}

RAIL_EFF = {"sensor": 0.82, "core": 0.78, "mem": 0.80, "rf": 0.75,
            "sys": 0.80}

TAIL_TOTAL_MW = 80.0             # long-tail auxiliary components (100 parts)

# Part-level aggregation for per-component accounting (Table III): the
# coprocessor is one package [ref 12] even though the scenario model tracks
# its internal IPs separately.
PART_AGGREGATION = {
    "coproc_soc": ("coproc_soc_base", "isp", "h265_codec", "npu_ml",
                   "hwa_vio6dof", "ocm_sram"),
}

# load fitted coefficients: the port carries a byte copy of the reference
# package's calibrated.json under data/
_CAL = __import__("pathlib").Path(__file__).resolve().parents[1] \
    / "data" / "calibrated.json"
if _CAL.exists():
    import json as _json
    THETA0.update(_json.loads(_CAL.read_text()))


@dataclass(frozen=True)
class Scenario:
    name: str
    on_device: tuple[str, ...] = ()      # subset of PRIMITIVES
    compression: float = 10.0
    fps_scale: float = 1.0
    mcs_tier: int = 1                    # scenarios.MCS_TIERS index
    upload_duty: float = 1.0             # VAD/saliency uplink gating
    brightness: float = 0.0              # display SKUs only

    def placements(self) -> dict[str, bool]:
        return {p: p in self.on_device for p in PRIMITIVES}


FULL_OFFLOAD = Scenario("full_offload")
FULL_ON_DEVICE = Scenario("full_on_device", tuple(PRIMITIVES))


@functools.lru_cache(maxsize=64)
def _duties(on_device: tuple) -> dict:
    tel = workloads.duty_cycles(dict(on_device))
    return dict(tel.duty)


# ---------------------------------------------------------------------------
# component metadata (category / process / rail / digital fraction)
# ---------------------------------------------------------------------------

COMPONENT_META = {
    # name-prefix -> (category, process, rail, digital_fraction)
    "rgb_camera": ("sensor", "mixed", "sensor", 0.45),
    "gs_camera": ("sensor", "mixed", "sensor", 0.45),
    "et_camera": ("sensor", "mixed", "sensor", 0.45),
    "et_ir": ("sensor", "analog", "sensor", 0.0),
    "imu": ("sensor", "analog", "sensor", 0.2),
    "mic": ("sensor", "analog", "sensor", 0.1),
    "gnss": ("sensor", "rf", "rf", 0.3),
    "magnetometer": ("sensor", "analog", "sensor", 0.2),
    "barometer": ("sensor", "analog", "sensor", 0.2),
    "coproc": ("compute", "digital", "core", 1.0),
    "isp": ("compute", "digital", "core", 1.0),
    "h265": ("compute", "digital", "core", 1.0),
    "sensor_hub": ("compute", "digital", "core", 1.0),
    "dsp": ("compute", "digital", "core", 1.0),
    "npu": ("compute", "digital", "core", 1.0),
    "hwa": ("compute", "digital", "core", 1.0),
    "lpddr": ("memory", "digital", "mem", 0.85),
    "ocm": ("memory", "digital", "mem", 1.0),
    "nor": ("memory", "digital", "mem", 0.8),
    "wifi": ("wireless", "rf", "rf", 0.35),
    "bt": ("wireless", "rf", "rf", 0.35),
    "speaker": ("output", "analog", "sys", 0.15),
    "ui_led": ("output", "analog", "sys", 0.0),
    "microled": ("output", "digital", "sys", 0.7),
    "display_pmic": ("output", "mixed", "sys", 0.3),
}


def _meta(name: str):
    for prefix, meta in COMPONENT_META.items():
        if name.startswith(prefix):
            return meta
    return ("misc", "mixed", "sys", 0.5)


def tail_components() -> list[Component]:
    """100 small auxiliary parts (§V-A3 long tail), deterministic set."""
    # repro: ignore[R003]: frozen host-side table generator — the long
    # tail is a fixed dataset (seed 7); THETA0 fits are pinned to it
    rng = np.random.RandomState(7)
    names = []
    kinds = [("i2c_bridge", 13), ("spi_bridge", 6), ("load_switch", 15),
             ("ldo_aux", 12), ("osc", 5), ("level_shifter", 11),
             ("temp_sensor", 8), ("esd_prot", 9), ("gpio_expander", 4),
             ("adc_aux", 6), ("rtc", 1), ("fuel_gauge", 1),
             ("haptic_drv", 1), ("debug_uart", 1), ("clk_buf", 6)]
    for kind, n in kinds:
        for i in range(n):
            names.append(f"{kind}_{i}")
    assert len(names) == 99, len(names)
    # sizes: 78 tiny parts + 21 mid parts (bucket A/B structure, Table III)
    sizes = np.concatenate([
        np.full(78, 0.16) * (1 + 0.15 * rng.randn(78)),
        np.full(21, 3.2) * (1 + 0.10 * rng.randn(21)),
    ])
    sizes = np.abs(sizes) * (TAIL_TOTAL_MW / np.abs(sizes).sum())
    rng.shuffle(names)
    comps = []
    for name, mw in zip(names, sizes):
        proc = "analog" if name.startswith(("ldo", "osc", "esd", "adc")) \
            else "mixed"
        comps.append(Component(name, "misc", proc, idle_mw=float(mw),
                               rail="sys",
                               digital_fraction=0.3 if proc == "mixed"
                               else 0.0))
    return comps


# ---------------------------------------------------------------------------
# declarative platform construction
# ---------------------------------------------------------------------------

def _mech_rows() -> list:
    """(name, load kind, params) for the 46 mechanistic components."""
    return [
        # sensors (always on: capture path is scenario-independent, §V-A2)
        ("rgb_camera", "sensor_fps", {"mw": 36.0}),
        *[(f"gs_camera_{i}", "sensor_fps", {"mw": 17.0}) for i in range(4)],
        *[(f"et_camera_{i}", "sensor_fps", {"mw": 7.0}) for i in range(2)],
        ("et_ir_illuminator", "const", {"mw": 9.0}),
        *[(f"imu_{i}", "const", {"mw": 1.6}) for i in range(2)],
        *[(f"mic_{i}", "const", {"mw": 1.1}) for i in range(5)],
        ("gnss", "const", {"mw": 11.0}),
        ("magnetometer", "const", {"mw": 1.4}),
        ("barometer", "const", {"mw": 0.9}),
        # compute complex
        ("coproc_soc_base", "const", {"mw": 72.0}),
        ("isp", "isp", {"active_mw": 40.0, "floor_mw": 6.0}),
        ("h265_codec", "codec", {"floor_mw": 5.0}),
        ("sensor_hub_mcu", "const", {"mw": 10.0}),
        ("dsp_audio", "dsp_audio", {"base_mw": 3.0, "idle_mw": 0.9}),
        ("npu_ml", "npu", {"off_mw": 0.4}),
        ("hwa_vio6dof", "hwa_vio", {"off_mw": 0.4}),
        # memory
        ("lpddr_dram", "dram", {"base_mw": 28.0}),
        ("ocm_sram", "const", {"mw": 11.0}),
        ("nor_flash", "const", {"mw": 7.0}),
        # wireless
        ("wifi_combo", "wifi", {}),
        ("bt_radio", "const", {"mw": 6.0}),
        # outputs
        ("speaker_amp", "const", {"mw": 15.0}),
        ("ui_led", "const", {"mw": 3.5}),
        # platform
        ("charger_ic", "const", {"mw": 2.2}),
        ("usb_phy", "const", {"mw": 1.3}),
        ("als_sensor", "const", {"mw": 0.7}),
        ("privacy_led", "const", {"mw": 1.8}),
        ("capacitive_touch", "const", {"mw": 1.2}),
        ("hall_sensor", "const", {"mw": 0.3}),
        ("wifi_fem", "const", {"mw": 7.5}),
        ("audio_adc", "const", {"mw": 1.9}),
        ("audio_hub_codec", "const", {"mw": 7.2}),
        ("imu_aggregator_mcu", "const", {"mw": 6.8}),
        ("pm_telemetry_hub", "const", {"mw": 6.5}),
        ("status_display_drv", "const", {"mw": 7.8}),
        ("storage_ctrl", "const", {"mw": 7.0}),
        ("mic_bias_reg", "const", {"mw": 3.0}),
    ]


def _spec_for(name: str, kind: str, params: dict,
              group: str = "mech") -> ComponentSpec:
    cat, proc, rail, digf = _meta(name)
    return ComponentSpec(name, cat, proc, rail, digf,
                         LoadRule(kind, tuple(sorted(params.items()))),
                         group)


@functools.lru_cache(maxsize=1)
def _duty_tables() -> tuple:
    """Placement-indexed duty tables (event-driven taskgraph sim): one
    2^n-entry table per shared resource the power model consumes — the
    ISP duty rule plus the NPU/DSP/DRAM-bus contention terms."""
    per_res = {r: [] for r in workloads.DUTY_RESOURCES}
    for idx in range(1 << len(PRIMITIVES)):
        on = {p: bool(idx >> i & 1) for i, p in enumerate(PRIMITIVES)}
        duties = _duties(tuple(sorted(on.items())))
        for r in workloads.DUTY_RESOURCES:
            per_res[r].append(float(duties.get(
                r, 1.0 if r == "isp" else 0.0)))
    return tuple(sorted((r, tuple(tab)) for r, tab in per_res.items()))


@functools.lru_cache(maxsize=1)
def _ip_rate_table() -> tuple:
    """Per-primitive sustained GFLOP/s on its accelerator (measured nets)."""
    return tuple(sorted([
        ("npu_ht", workloads.flops_rates({"hand_tracking": True})["npu"]),
        ("npu_et", workloads.flops_rates({"eye_tracking": True})["npu"]),
        ("hwa_vio", workloads.flops_rates({"vio": True})["hwa_vio"]),
        ("dsp_asr", workloads.flops_rates({"asr": True})["dsp"]),
    ]))


@functools.lru_cache(maxsize=1)
def aria2_platform() -> PlatformSpec:
    """The baseline Aria2 glasses as a declarative PlatformSpec."""
    comps = [_spec_for(*row) for row in _mech_rows()]
    comps.extend(
        ComponentSpec(c.name, c.category, c.process, c.rail,
                      c.digital_fraction,
                      LoadRule("const", (("mw", c.idle_mw),)), "tail")
        for c in tail_components())
    spec = PlatformSpec(
        name="aria2",
        components=tuple(comps),
        rails=tuple(sorted(RAIL_EFF.items())),
        theta=tuple(sorted(THETA0.items())),
        raw_mbps=tuple(sorted(RAW_MBPS.items())),
        ip_rates=_ip_rate_table(),
        duty_tables=_duty_tables(),
    )
    return register(spec)


@functools.lru_cache(maxsize=1)
def aria2_display_platform() -> PlatformSpec:
    """SKU variant: microLED display subsystem driven by the brightness
    knob (in-lens contextual UI instead of the status LED strip)."""
    spec = aria2_platform().variant(
        "aria2_display",
        add=(_spec_for("microled_display", "display",
                       {"base_mw": 14.0, "max_mw": 260.0}),
             _spec_for("display_pmic", "const", {"mw": 6.0})))
    return register(spec)


@functools.lru_cache(maxsize=1)
def aria2_capture_only_platform() -> PlatformSpec:
    """SKU variant: capture-and-offload only — no on-device ML IPs, no
    eye-tracking optics, no speaker.  Evaluate with empty placements."""
    spec = aria2_platform().variant(
        "aria2_capture_only",
        drop=("npu_ml", "hwa_vio6dof", "et_camera_0", "et_camera_1",
              "et_ir_illuminator", "speaker_amp"),
        replace=(_spec_for("coproc_soc_base", "const", {"mw": 48.0}),))
    return register(spec)


@functools.lru_cache(maxsize=1)
def rayban_cam_platform() -> PlatformSpec:
    """Ray-Ban-class camera+audio SKU, pure data off the Aria2 table:
    one RGB POV camera, mic array and IMU — no GS/ET optics, no
    localization or hand/eye ML IPs (the audio DSP stays, so wake-word /
    ASR can run on-device), no GNSS/mag/baro, and a leaner coprocessor,
    ISP and DRAM sized for the single-camera pipe.  The dropped sensor
    streams are zeroed in `raw_mbps`, so the uplink/codec formulas see a
    camera-only device rather than phantom GS/ET traffic."""
    spec = aria2_platform().variant(
        "rayban_cam",
        drop=("gs_camera_0", "gs_camera_1", "gs_camera_2", "gs_camera_3",
              "et_camera_0", "et_camera_1", "et_ir_illuminator",
              "npu_ml", "hwa_vio6dof", "gnss", "magnetometer",
              "barometer", "imu_1", "imu_aggregator_mcu",
              "status_display_drv"),
        replace=(_spec_for("coproc_soc_base", "const", {"mw": 40.0}),
                 _spec_for("isp", "isp",
                           {"active_mw": 16.0, "floor_mw": 3.0}),
                 _spec_for("lpddr_dram", "dram", {"base_mw": 15.0})),
        raw_mbps={"gs": 0.0, "gs_vio_share": 0.0, "et": 0.0,
                  "imu": RAW_MBPS["imu"] / 2,       # one IMU, not two
                  "aux": 0.01})        # telemetry only: no GNSS/mag/baro
    return register(spec)


@functools.lru_cache(maxsize=1)
def aria2_puck_split_platform() -> PlatformSpec:
    """Glasses half of a puck-companion split: the ML IPs, WiFi front-end
    and their thermal budget move to a pocket host, and the glasses keep
    capture plus a short-range BT-class link (cheaper per bit and far
    cheaper to idle than the WAN radio).  "Offloaded" streams here land
    on the puck, which relays over its own (unconstrained) radio."""
    spec = aria2_platform().variant(
        "aria2_puck_split",
        drop=("npu_ml", "hwa_vio6dof", "wifi_fem"),
        replace=(_spec_for("coproc_soc_base", "const", {"mw": 52.0}),),
        theta={"wifi_mw_per_mbps": 3.2, "wifi_link_mw": 24.0},
        # the pocket host half of the split, as registry data: daysim
        # carries it as a second battery/thermal node in the SAME scan,
        # coupled by the short-range link (its WAN radio re-transmits
        # the glasses' offloaded Mbps at phone-class energy/bit)
        companion={
            "base_mw": 210.0,            # host SoC + relay compute
            "wan_link_mw": 95.0,         # WAN radio link maintenance
            "wan_mw_per_mbps": 9.0,      # WAN energy/bit (MCS8-class)
            "standby_mw": 18.0,
            "battery_mwh": 5600.0,       # pocket-scale pack
            "r_internal_ohm": 0.12,
            "c_soc_j_per_k": 42.0,       # bigger mass, pocket-coupled
            "c_skin_j_per_k": 210.0,
            "r_soc_skin_k_per_w": 4.5,
            "r_skin_amb_k_per_w": 8.0,
        })
    return register(spec)


def platforms() -> tuple:
    """Build + register all built-in platform SKUs."""
    return (aria2_platform(), aria2_display_platform(),
            aria2_capture_only_platform(), rayban_cam_platform(),
            aria2_puck_split_platform())


# ---------------------------------------------------------------------------
# single-Scenario wrappers over the batched engine (compatibility API)
# ---------------------------------------------------------------------------

def _single(sc: Scenario, theta=None, plat: PlatformSpec | None = None,
            device="cuda"):
    from . import scenarios as S
    plat = plat or aria2_platform()
    return plat, S.evaluate(plat, S.ScenarioSet.from_scenarios([sc]), theta,
                            device)


def offloaded_mbps(sc: Scenario, device="cuda"):
    """Wireless uplink rate for a scenario (the compute<->comm trade)."""
    _, rep = _single(sc, device=device)
    return rep.offloaded_mbps[0]


def component_loads(sc: Scenario, theta=None, device="cuda"):
    """Mechanistic component loads (mW) for a scenario, as 0-dim tensors;
    returns (loads, theta) like the pre-redesign API."""
    plat, rep = _single(sc, theta, device=device)
    th = dict(THETA0)
    if theta:
        th.update(theta)
    names = plat.component_names()
    mech = {c.name for c in plat.mech_components()}
    loads = {n: rep.loads_mw[0, i] for i, n in enumerate(names)
             if n in mech}
    return loads, th


def total_mw(sc: Scenario, theta=None, device="cuda"):
    """Scenario total (mechanistic + tail + PD losses)."""
    _, rep = _single(sc, theta, device=device)
    return rep.total_mw[0]


def pd_share(sc: Scenario, theta=None, device="cuda"):
    _, rep = _single(sc, theta, device=device)
    return rep.pd_share()[0]


def build_system(sc: Scenario, theta=None,
                 plat: PlatformSpec | None = None,
                 device="cuda") -> SystemModel:
    """Materialize a power.SystemModel snapshot of one scenario."""
    plat, rep = _single(sc, theta, plat, device)
    row = rep.loads_mw[0].cpu().numpy()
    comps = [Component(c.name, c.category, c.process, idle_mw=float(mw),
                       rail=c.rail, digital_fraction=c.digital_fraction)
             for c, mw in zip(plat.components, row)]
    th = dict(THETA0)
    if theta:
        th.update(theta)
    rails = {r: Rail(r, min(e * th["eff_scale"], 0.97))
             for r, e in plat.rails}
    return SystemModel(comps, rails)


# ---------------------------------------------------------------------------
# pre-redesign reference implementation (parity oracle + bench baseline)
# ---------------------------------------------------------------------------

def _npu_load(on, th, duties, fs):
    """NPU load: per-primitive pJ/FLOP x its measured GFLOP/s, plus the
    sim-duty queueing overhead (shared HT+ET accelerator)."""
    ht = workloads.flops_rates({"hand_tracking": True})["npu"] * th["pj_ht"] \
        if on["hand_tracking"] else 0.0
    et = workloads.flops_rates({"eye_tracking": True})["npu"] * th["pj_et"] \
        if on["eye_tracking"] else 0.0
    queue = th["queue_mw_per_duty"] * duties.get("npu", 0.0) / max(fs, 1.0)
    if on["hand_tracking"] or on["eye_tracking"]:
        return th["ip_idle_mw"] + ht + et + queue
    return 0.4 + queue


def legacy_offloaded_mbps(sc: Scenario):
    c, fs = sc.compression, sc.fps_scale
    on = sc.placements()
    mbps = RAW_MBPS["rgb"] / c / fs                 # RGB always offloaded
    if on["hand_tracking"] and on["vio"]:
        gs = 0.0                                    # cameras fully consumed
    elif on["hand_tracking"]:
        gs = RAW_MBPS["gs_vio_share"]               # VIO's 10fps subset
    else:
        gs = RAW_MBPS["gs"]                         # HT needs full 30fps
    mbps += gs / c / fs
    if not on["eye_tracking"]:
        mbps += RAW_MBPS["et"] / c / fs
    if not on["asr"]:
        mbps += RAW_MBPS["audio_opus"]
    mbps += RAW_MBPS["imu"] + RAW_MBPS["aux"]
    mbps += RAW_MBPS["signals"] * sum(on.values())
    return mbps


def legacy_component_loads(sc: Scenario, theta=None):
    """The seed per-scenario dict implementation, kept verbatim as the
    reference oracle for the batched engine (tests/dse_bench)."""
    th = dict(THETA0)
    if theta:
        th.update(theta)
    on = sc.placements()
    duties = _duties(tuple(sorted(on.items())))
    rates = workloads.flops_rates(on)
    fs = sc.fps_scale
    mbps = legacy_offloaded_mbps(sc)
    raw_visual = (RAW_MBPS["rgb"] + RAW_MBPS["gs"] + RAW_MBPS["et"]) / fs
    # raw pixel rate entering the codec (compressed-for-offload streams +
    # RGB which is always compressed)
    codec_raw = RAW_MBPS["rgb"] / fs
    if not (on["hand_tracking"] and on["vio"]):
        codec_raw += (RAW_MBPS["gs"] if not on["hand_tracking"]
                      else RAW_MBPS["gs_vio_share"]) / fs
    if not on["eye_tracking"]:
        codec_raw += RAW_MBPS["et"] / fs

    fps_f = 0.35 + 0.65 / fs           # sensors have a static power floor

    loads = {
        "rgb_camera":       36.0 * fps_f,
        **{f"gs_camera_{i}": 17.0 * fps_f for i in range(4)},
        **{f"et_camera_{i}": 7.0 * fps_f for i in range(2)},
        "et_ir_illuminator": 9.0,
        **{f"imu_{i}": 1.6 for i in range(2)},
        **{f"mic_{i}": 1.1 for i in range(5)},
        "gnss": 11.0, "magnetometer": 1.4, "barometer": 0.9,
        "coproc_soc_base": 72.0,
        "isp": 40.0 * duties.get("isp", 1.0) / max(fs, 1.0) + 6.0,
        "h265_codec": th["codec_mw_per_rawmbps"] * codec_raw + 5.0,
        "sensor_hub_mcu": 10.0,
        "dsp_audio": 3.0 + (rates["dsp"] * th["pj_asr"]
                            if on["asr"] else 0.9)
                    + th["queue_mw_per_duty"] * duties.get("dsp", 0.0),
        "npu_ml": _npu_load(on, th, duties, fs),
        "hwa_vio6dof": (th["ip_idle_mw"] + rates["hwa_vio"] * th["pj_vio"])
                       if on["vio"] else 0.4,
        "lpddr_dram": 28.0 + th["dram_mw_per_mbps"] * raw_visual / 8
                    + th["queue_mw_per_duty"] * duties.get("dram_bus", 0.0)
                    / max(fs, 1.0),
        "ocm_sram": 11.0,
        "nor_flash": 7.0,
        "wifi_combo": th["wifi_link_mw"] + th["wifi_mw_per_mbps"] * mbps,
        "bt_radio": 6.0,
        "speaker_amp": 15.0,
        "ui_led": 3.5,
        "charger_ic": 2.2,
        "usb_phy": 1.3,
        "als_sensor": 0.7,
        "privacy_led": 1.8,
        "capacitive_touch": 1.2,
        "hall_sensor": 0.3,
        "wifi_fem": 7.5,
        "audio_adc": 1.9,
        "audio_hub_codec": 7.2,
        "imu_aggregator_mcu": 6.8,
        "pm_telemetry_hub": 6.5,
        "status_display_drv": 7.8,
        "storage_ctrl": 7.0,
        "mic_bias_reg": 3.0,
    }
    return loads, th


def legacy_total_mw(sc: Scenario, theta=None):
    """Seed per-scenario total: Python dict + per-call float32 ops (the
    reference's weakly-typed scalar arithmetic, spelled out)."""
    f32 = np.float32
    loads, th = legacy_component_loads(sc, theta)
    total = f32(0.0)
    for name, mw in loads.items():
        _, _, rail, _ = _meta(name)
        eff = np.minimum(f32(RAIL_EFF[rail] * th["eff_scale"]), f32(0.97))
        total = total + f32(mw) / eff
    total = total + f32(TAIL_TOTAL_MW) / np.minimum(
        f32(RAIL_EFF["sys"] * th["eff_scale"]), f32(0.97))
    return total
