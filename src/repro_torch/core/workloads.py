"""Egocentric-primitive taskgraphs (PnPSim workload specs).

Task durations are derived from the *measured* compiled FLOPs of the
perception nets divided by the executing IP's throughput — replacing the
paper's proprietary EDA/profiling inputs.  The six per-net FLOP counts
are frozen data (`data/measured_flops.json`, taken from the XLA cost
analysis of the reference nets), so the port never recounts them.
Sensor sources run at Table II rates; shared devices (ISP, DSP, DRAM bus)
capture cross-primitive contention, which is exactly the coupling §V-B
highlights (VIO and hand tracking share the outward GS cameras/ISP).
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

from .taskgraph import Task, TaskGraph, simulate

FLOPS_PATH = Path(__file__).resolve().parents[1] / "data" / "measured_flops.json"


@functools.lru_cache(maxsize=1)
def measured_flops() -> dict[str, float]:
    """Compiled FLOPs per single invocation of each primitive net."""
    return {k: float(v) for k, v in json.loads(FLOPS_PATH.read_text()).items()}

# IP peak throughputs (GFLOP/s) — embedded-class accelerators
IP_THROUGHPUT = {
    "npu": 120.0,       # ML accelerator (hand/eye nets)
    "hwa_vio": 80.0,    # 6DoF localization hardware IP
    "dsp": 30.0,        # audio/general DSP
}

# sensor rates (Table II)
RATES = {
    "rgb_fps": 5.0, "gs_fps": 30.0, "gs_fps_vio": 10.0, "et_fps": 30.0,
    "imu_hz": 800.0, "audio_khz": 48.0, "gnss_hz": 1.0, "mag_hz": 100.0,
    "baro_hz": 50.0, "n_gs": 4, "n_et": 2, "n_mic": 5, "n_imu": 2,
}

SPEECH_FRACTION = 0.35     # VAD gating for ASR (fraction of audio w/ speech)


def _dur(flops: float, ip: str) -> float:
    return flops / (IP_THROUGHPUT[ip] * 1e9)


def primitive_taskgraphs(on_device: dict[str, bool]) -> list[TaskGraph]:
    """Taskgraphs for the enabled on-device primitives + capture path."""
    f = measured_flops()
    graphs = []
    # capture path always runs: ISP processes every camera frame
    isp_per_frame = 0.9e-3      # s per VGA-class frame on the ISP
    graphs.append(TaskGraph(
        "capture_gs", rate_hz=RATES["gs_fps"],
        tasks=(Task("isp_gs", "isp", isp_per_frame * RATES["n_gs"],
                    bytes_out=RATES["n_gs"] * 640 * 480,
                    out_device="dram_bus"),)))
    graphs.append(TaskGraph(
        "capture_rgb", rate_hz=RATES["rgb_fps"],
        tasks=(Task("isp_rgb", "isp", 6.5e-3,
                    bytes_out=1440 * 1440, out_device="dram_bus"),
               Task("encode_rgb", "codec", 9.0e-3, deps=("isp_rgb",),
                    bytes_out=1440 * 1440 / 10, out_device="dram_bus"))))
    graphs.append(TaskGraph(
        "capture_et", rate_hz=RATES["et_fps"],
        tasks=(Task("isp_et", "isp", 0.25e-3 * RATES["n_et"],
                    bytes_out=RATES["n_et"] * 320 * 240,
                    out_device="dram_bus"),)))

    if on_device.get("hand_tracking"):
        graphs.append(TaskGraph(
            "hand_tracking", rate_hz=RATES["gs_fps"], deadline_s=0.050,
            tasks=(
                Task("ht_detect", "npu", _dur(0.3 * f["hand_tracker"], "npu")),
                Task("ht_pose", "npu", _dur(f["hand_tracker"], "npu"),
                     deps=("ht_detect",), bytes_out=2 * 21 * 3 * 4,
                     out_device="dram_bus"),
            )))
    if on_device.get("eye_tracking"):
        graphs.append(TaskGraph(
            "eye_tracking", rate_hz=RATES["et_fps"], deadline_s=0.033,
            tasks=(Task("et_gaze", "npu", _dur(f["eye_tracker"], "npu"),
                        bytes_out=2 * 4 * 4, out_device="dram_bus"),)))
    if on_device.get("vio"):
        graphs.append(TaskGraph(
            "vio_frontend", rate_hz=RATES["gs_fps_vio"], deadline_s=0.100,
            tasks=(
                Task("vio_feat", "hwa_vio",
                     _dur(RATES["n_gs"] * f["vio_frontend"], "hwa_vio"),
                     bytes_out=4 * 256 * 32 * 4, out_device="dram_bus"),
                Task("vio_filter", "hwa_vio", 0.8e-3, deps=("vio_feat",),
                     bytes_out=6 * 4 * 8, out_device="dram_bus"),
            )))
        graphs.append(TaskGraph(
            "vio_imu", rate_hz=20.0,
            tasks=(Task("tlio", "hwa_vio", _dur(f["vio_imu"], "hwa_vio")),)))
    if on_device.get("asr"):
        graphs.append(TaskGraph(
            "vad", rate_hz=1.0,
            tasks=(Task("vad_1s", "dsp", _dur(f["vad"], "dsp")),)))
        graphs.append(TaskGraph(
            "asr", rate_hz=SPEECH_FRACTION,   # VAD-gated
            tasks=(Task("asr_1s", "dsp", _dur(f["asr_1s"], "dsp"),
                        bytes_out=50 * 4, out_device="dram_bus"),)))
    else:
        # audio is compressed for offload on the DSP (OPUS)
        graphs.append(TaskGraph(
            "opus", rate_hz=1.0,
            tasks=(Task("opus_1s", "dsp", 2.5e-3 * 2,
                        bytes_out=2 * 16000, out_device="dram_bus"),)))
    return graphs


DEVICES = {"isp": 1, "codec": 1, "npu": 1, "hwa_vio": 1, "dsp": 1,
           "dram_bus": 1}

# effective streaming bandwidth of the shared memory bus (bytes/s) in the
# low-power LPDDR state the capture path runs in: producers *occupy* the
# bus for bytes/BUS_BW seconds, so dram_bus contention shows up as duty
BUS_BW = {"dram_bus": 1.6e9}

# resources whose sim duty feeds the batched power engine as a
# placement-indexed table (platform.duty_tables); "isp" drives the ISP
# duty-cycle rule, the rest feed the queue_mw_per_duty contention terms
DUTY_RESOURCES = ("isp", "npu", "dsp", "dram_bus")


def duty_cycles(on_device: dict[str, bool], horizon_s: float = 2.0):
    """Run the event simulation; returns Telemetry (duties, waits, misses)."""
    return simulate(primitive_taskgraphs(on_device), DEVICES,
                    horizon_s=horizon_s, bus_bw=BUS_BW)


def flops_rates(on_device: dict[str, bool]) -> dict[str, float]:
    """Sustained GFLOP/s per IP implied by the enabled primitives."""
    f = measured_flops()
    out = {"npu": 0.0, "hwa_vio": 0.0, "dsp": 0.0}
    if on_device.get("hand_tracking"):
        out["npu"] += 1.3 * f["hand_tracker"] * RATES["gs_fps"] / 1e9
    if on_device.get("eye_tracking"):
        out["npu"] += f["eye_tracker"] * RATES["et_fps"] / 1e9
    if on_device.get("vio"):
        out["hwa_vio"] += (RATES["n_gs"] * f["vio_frontend"] *
                           RATES["gs_fps_vio"] + f["vio_imu"] * 20.0) / 1e9
    if on_device.get("asr"):
        # encoder + autoregressive decoder/beam ~= 2.2x encoder cost
        out["dsp"] += (f["vad"] + SPEECH_FRACTION * f["asr_1s"] * 2.2) / 1e9
    return out
