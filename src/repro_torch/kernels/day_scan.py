"""Fused day integrator: battery SoC + 2-node thermal RC + throttle
hysteresis for a batch of design combos, one whole day per call.

`day_scan(tables)` is the dispatch.  Tables on the CPU go to
`day_scan_plain`, the torch mirror of the reference's
`daysim._integrate_one` over a combo batch (a Python loop over T).
Tables on a CUDA device go to the hand-written kernel
`csrc/day_scan.cu` (one thread per combo, state in registers) or raise:
there is no fallback from the card to the plain version.

Tables use the port's time-major layout, so the kernel's warps read
neighbouring addresses at every step:

    step_mw, step_mw_p, step_pods   (T, L, N) float32
    ambient, active, valid,
    charge, charge_p                (T, N) float32
    act_mult                        (L, N) float32
    const                           {key: (N,) float32}, keys CONST_KEYS

Both return {name: (N, T)} for `OUTS` (transposed views of the (T, N)
buffers; `level` int32).  The level tables are taken at the integer
throttle level, where the reference's `take_linear` / hat-weight gather
is exact.  `LAUNCHES` counts kernel launches (the plain version never
bumps it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.design import ste_gt, ste_lt

# outputs, the subset the day summary reads
OUTS = ("soc", "soc_p", "t_skin", "t_skin_p", "shut", "level", "pods",
        "drain_mw", "drain_p_mw")

# per-combo constants in sorted key order: the rows of the kernel's
# (C, N) constant matrix (enum ConstRow in csrc/day_scan.cu)
CONST_KEYS = (
    "dsoc_coeff", "dt_c_skin", "dt_c_soc", "g_skin_amb", "g_soc_skin",
    "has_puck", "knee_sharp", "knee_v", "max_level", "p_dsoc_coeff",
    "p_dt_c_skin", "p_dt_c_soc", "p_g_skin_amb", "p_g_soc_skin",
    "p_knee_sharp", "p_knee_v", "p_r_ohm", "p_sag_v", "p_standby_mw",
    "p_v_full", "r_ohm", "sag_v", "shutdown_c", "soc_clear", "soc_trip",
    "standby_mw", "ste_beta_c", "ste_beta_soc", "temp_clear", "temp_trip",
    "v_full")
MAX_LEVELS = 16             # largest L the kernel takes

TABLE_KEYS = ("step_mw", "step_mw_p", "step_pods")
ROW_KEYS = ("ambient", "active", "valid", "charge", "charge_p")

LAUNCHES = 0                # kernel launches in this process


def _shape(tables: dict) -> tuple:
    t, n_lvl, n = tables["step_mw"].shape
    return n, t, n_lvl


def _check(tables: dict) -> None:
    n, t, n_lvl = _shape(tables)
    dev = tables["step_mw"].device
    if tuple(sorted(tables["const"])) != CONST_KEYS:
        raise ValueError(f"const keys {sorted(tables['const'])} != "
                         f"{list(CONST_KEYS)}")
    want = {**{k: (t, n_lvl, n) for k in TABLE_KEYS},
            **{k: (t, n) for k in ROW_KEYS}, "act_mult": (n_lvl, n)}
    for k, shape in want.items():
        x = tables[k]
        if tuple(x.shape) != shape or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{k}: want float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    for k in CONST_KEYS:
        x = tables["const"][k]
        if tuple(x.shape) != (n,) or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"const {k}: want float32 ({n},) on {dev}")


def day_scan(tables: dict) -> dict:
    """Integrate the day tables: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, an error for anything else."""
    _check(tables)
    dev = tables["step_mw"].device
    if dev.type == "cpu":
        return day_scan_plain(tables)
    if dev.type == "cuda":
        return _day_scan_cuda(tables)
    raise ValueError(f"day_scan runs on cpu or cuda tensors, got {dev}")


def _node_step(soc, t_soc, t_skin, p_mw, charge_mw, amb, pre, c):
    """daysim._node_step, unfused eager ops in the reference's order."""
    v = (c[pre + "v_full"] - c[pre + "sag_v"] * (1.0 - soc)
         - c[pre + "knee_v"] * torch.exp(-c[pre + "knee_sharp"] * soc))
    i_a = p_mw * 1e-3 / v
    loss_mw = i_a * i_a * c[pre + "r_ohm"] * 1e3
    drain_mw = p_mw + loss_mw
    soc_n = torch.clamp(soc - drain_mw * c[pre + "dsoc_coeff"]
                        + charge_mw * c[pre + "dsoc_coeff"], 0.0, 1.0)
    heat_w = drain_mw * 1e-3
    flow = (t_soc - t_skin) * c[pre + "g_soc_skin"]
    t_soc_n = t_soc + (heat_w - flow) * c[pre + "dt_c_soc"]
    t_skin_n = t_skin + (flow - (t_skin - amb) * c[pre + "g_skin_amb"]) \
        * c[pre + "dt_c_skin"]
    return soc_n, t_soc_n, t_skin_n, drain_mw


def day_scan_plain(tables: dict) -> dict:
    """The plain PyTorch version: daysim._step_math over a combo batch,
    a Python loop over T, on whatever device the tables are on."""
    _check(tables)
    n, t_steps, _ = _shape(tables)
    c = tables["const"]
    cols = torch.arange(n, device=tables["step_mw"].device)
    amb0 = tables["ambient"][0]
    one = torch.ones_like(amb0)
    zero = torch.zeros_like(amb0)
    soc, soc_p = one, one
    t_soc, t_skin, t_soc_p, t_skin_p = amb0, amb0, amb0, amb0
    th_state, soc_state, shut = zero, zero, zero
    out = {k: [] for k in OUTS}
    for t in range(t_steps):
        # hysteresis triggers evaluate on the previous step's state
        trip_t = ste_gt(t_skin, c["temp_trip"])
        clear_t = ste_lt(t_skin, c["temp_clear"])
        th_state = trip_t + (1.0 - trip_t) * (1.0 - clear_t) * th_state
        soc_eff = torch.minimum(soc, soc_p)
        trip_s = ste_lt(soc_eff, c["soc_trip"])
        clear_s = ste_gt(soc_eff, c["soc_clear"])
        soc_state = trip_s + (1.0 - trip_s) * (1.0 - clear_s) * soc_state
        level_f = torch.minimum(th_state + soc_state, c["max_level"])
        lv = level_f.long()                 # an exact small integer

        shut = torch.maximum(shut, (t_skin > c["shutdown_c"]).float())
        shut = torch.maximum(shut, (t_skin_p > c["shutdown_c"]).float()
                             * c["has_puck"])
        alive = ((soc > 0.0).float() * (soc_p > 0.0).float()
                 * (1.0 - shut) * tables["valid"][t])
        act = tables["active"][t] * tables["act_mult"][lv, cols]
        p_mw = (act * tables["step_mw"][t][lv, cols]
                + (1.0 - act) * c["standby_mw"]) * alive
        p_p_mw = (act * tables["step_mw_p"][t][lv, cols]
                  + (1.0 - act) * c["p_standby_mw"]) * alive \
            * c["has_puck"]

        amb = tables["ambient"][t]
        soc, t_soc, t_skin, drain_mw = _node_step(
            soc, t_soc, t_skin, p_mw, tables["charge"][t], amb, "", c)
        soc_p, t_soc_p, t_skin_p, drain_p_mw = _node_step(
            soc_p, t_soc_p, t_skin_p, p_p_mw, tables["charge_p"][t], amb,
            "p_", c)
        pods = act * tables["step_pods"][t][lv, cols] * alive
        for k, v in (("soc", soc), ("soc_p", soc_p), ("t_skin", t_skin),
                     ("t_skin_p", t_skin_p), ("shut", shut),
                     ("level", lv.to(torch.int32)), ("pods", pods),
                     ("drain_mw", drain_mw), ("drain_p_mw", drain_p_mw)):
            out[k].append(v)
    return {k: torch.stack(v).t() for k, v in out.items()}


@functools.lru_cache(maxsize=1)
def _lib():
    from . import build
    lib = build.load("day_scan")
    fn = lib.day_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _day_scan_cuda(tables: dict) -> dict:
    """Launch csrc/day_scan.cu on the current stream (no sync)."""
    global LAUNCHES
    n, t_steps, n_lvl = _shape(tables)
    if n_lvl > MAX_LEVELS:
        raise ValueError(f"day_scan kernel takes at most {MAX_LEVELS} "
                         f"throttle levels, got {n_lvl}")
    dev = tables["step_mw"].device
    ins = [tables[k].contiguous() for k in TABLE_KEYS]
    ins.append(tables["act_mult"].contiguous())
    ins += [tables[k].contiguous() for k in ROW_KEYS]
    ins.append(torch.stack([tables["const"][k] for k in CONST_KEYS]))
    outs = {k: torch.empty((t_steps, n), device=dev,
                           dtype=torch.int32 if k == "level"
                           else torch.float32) for k in OUTS}
    fn = _lib()
    # `ins` may hold fresh copies that are freed when this returns, while
    # the kernel still runs: the caching allocator only hands their
    # memory to later work on the same stream, which runs after it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[x.data_ptr() for x in ins],
                 *[outs[k].data_ptr() for k in OUTS],
                 n, t_steps, n_lvl, len(CONST_KEYS), stream)
    if err != 0:
        raise RuntimeError(f"day_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return {k: v.t() for k, v in outs.items()}
