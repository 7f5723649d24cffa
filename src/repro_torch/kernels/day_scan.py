"""Fused day integrator: battery SoC + 2-node thermal RC + throttle
hysteresis for a batch of design combos, one whole day per call.

`day_scan(tables)` is the dispatch.  Tables on the CPU go to
`day_scan_plain`, the torch mirror of the reference's
`daysim._integrate_one` over a combo batch (a Python loop over T).
Tables on a CUDA device go to the hand-written kernel
`csrc/day_scan.cu` or raise: there is no fallback from the card to the
plain version.  The kernel is warp-specialised: per block of 32 combos a
compute warp runs the chain with the state in registers, while a load, a
prep and a store warp stage chunks of `chunk_steps(L)` steps through
shared memory and form each step's state-independent products for every
level ahead of it.  `day_scan_staged_plain` mirrors that split on the CPU
(tests only) and is bit-equal to `day_scan_plain`.

Tables use the port's time-major layout, so the kernel's warps read
neighbouring addresses at every step:

    step_mw, step_mw_p, step_pods   (T, L, N) float32
    ambient, active, valid,
    charge, charge_p                (T, N) float32
    act_mult                        (L, N) float32
    const                           {key: (N,) float32}, keys CONST_KEYS
    soc0, soc0_p (optional)         (N,) float32, full-trace mode only

`soc0` / `soc0_p` start each combo's glasses and puck node from that
state of charge instead of a full battery (`fleet.fleet_day`'s days after
the first); absent, both start at 1.0 as before.

Both return {name: (N, T)} for `OUTS` (transposed views of the (T, N)
buffers; `level` int32), or with ``full=True`` for all of `TRACE_OUTS`
(the full-trace mode `daysim.simulate` runs: the kernel's second
compile-time variant).  The level tables are taken at the integer
throttle level, where the reference's `take_linear` / hat-weight gather
is exact.  `LAUNCHES` counts kernel launches of both modes,
`FULL_LAUNCHES` those of the full-trace mode (the plain version bumps
neither).  `probe_launch` runs the kernel's probe modes (built with
``-DDAY_SCAN_PROBE``) for `scripts/kernel_probe.py` and does not count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.design import ste_gt, ste_lt
from . import guard as _guard

# outputs, the subset the day summary reads
OUTS = ("soc", "soc_p", "t_skin", "t_skin_p", "shut", "level", "pods",
        "drain_mw", "drain_p_mw")
# the full-trace mode's: all 17 outputs of the reference's
# daysim._step_math (the latches th_state / soc_state as 0 / 1)
TRACE_OUTS = OUTS + ("t_soc", "t_soc_p", "th_state", "soc_state", "p_mw",
                     "p_p_mw", "act", "alive")

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
SOC0_KEYS = ("soc0", "soc0_p")      # the full trace's optional inputs

LAUNCHES = 0                # kernel launches in this process, both modes
FULL_LAUNCHES = 0           # those of the full-trace mode


def _shape(tables: dict) -> tuple:
    t, n_lvl, n = tables["step_mw"].shape
    return n, t, n_lvl


def _check(tables: dict, full: bool = False) -> None:
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
    for k in SOC0_KEYS:
        if k not in tables:
            continue
        if not full:
            raise ValueError(f"{k}: an initial SoC is taken by the "
                             f"full-trace mode only")
        x = tables[k]
        if tuple(x.shape) != (n,) or x.dtype != torch.float32 \
                or x.device != dev:
            raise ValueError(f"{k}: want float32 ({n},) on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def day_scan(tables: dict, full: bool = False) -> dict:
    """Integrate the day tables: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors, an error for anything else.  Returns
    `OUTS`, or `TRACE_OUTS` when `full`."""
    _check(tables, full)
    dev = tables["step_mw"].device
    if dev.type == "cpu":
        return day_scan_plain(tables, full)
    if dev.type == "cuda":
        return _day_scan_cuda(tables, full)
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


def day_scan_plain(tables: dict, full: bool = False) -> dict:
    """The plain PyTorch version: daysim._step_math over a combo batch,
    a Python loop over T, on whatever device the tables are on; `OUTS`,
    or `TRACE_OUTS` when `full`."""
    _check(tables, full)
    n, t_steps, _ = _shape(tables)
    c = tables["const"]
    cols = torch.arange(n, device=tables["step_mw"].device)
    amb0 = tables["ambient"][0]
    one = torch.ones_like(amb0)
    zero = torch.zeros_like(amb0)
    soc, soc_p = tables.get("soc0", one), tables.get("soc0_p", one)
    t_soc, t_skin, t_soc_p, t_skin_p = amb0, amb0, amb0, amb0
    th_state, soc_state, shut = zero, zero, zero
    out = {k: [] for k in (TRACE_OUTS if full else OUTS)}
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
        step = {"soc": soc, "soc_p": soc_p, "t_skin": t_skin,
                "t_skin_p": t_skin_p, "shut": shut,
                "level": lv.to(torch.int32), "pods": pods,
                "drain_mw": drain_mw, "drain_p_mw": drain_p_mw,
                "t_soc": t_soc, "t_soc_p": t_soc_p, "th_state": th_state,
                "soc_state": soc_state, "p_mw": p_mw, "p_p_mw": p_p_mw,
                "act": act, "alive": alive}
        for k, v in out.items():
            v.append(step[k])
    return {k: torch.stack(v).t() for k, v in out.items()}


def _node_step_staged(soc, t_soc, t_skin, p_mw, charge_dsoc, amb, pre, c):
    """`_node_step` with charge_mw * dsoc_coeff formed ahead (the kernel's
    prep); the same operations in the same order otherwise."""
    v = (c[pre + "v_full"] - c[pre + "sag_v"] * (1.0 - soc)
         - c[pre + "knee_v"] * torch.exp(-c[pre + "knee_sharp"] * soc))
    i_a = p_mw * 1e-3 / v
    loss_mw = i_a * i_a * c[pre + "r_ohm"] * 1e3
    drain_mw = p_mw + loss_mw
    soc_n = torch.clamp(soc - drain_mw * c[pre + "dsoc_coeff"]
                        + charge_dsoc, 0.0, 1.0)
    heat_w = drain_mw * 1e-3
    flow = (t_soc - t_skin) * c[pre + "g_soc_skin"]
    t_soc_n = t_soc + (heat_w - flow) * c[pre + "dt_c_soc"]
    t_skin_n = t_skin + (flow - (t_skin - amb) * c[pre + "g_skin_amb"]) \
        * c[pre + "dt_c_skin"]
    return soc_n, t_soc_n, t_skin_n, drain_mw


def day_scan_staged_plain(tables: dict, chunk: int,
                          full: bool = False) -> dict:
    """The kernel's split in plain PyTorch (tests only).  Per chunk of
    `chunk` steps the state-independent products are formed first for
    every level (the prep warp's work): act = active * act_mult,
    act * mw + (1 - act) * standby_mw and its puck twin, act * pods and
    charge * dsoc_coeff for both nodes.  Then the chain runs on them with
    boolean latches, an integer level and a gather at it.  Every operation
    and operand order is `day_scan_plain`'s, so every output is bit-equal
    to it, in both modes (`full`: act at the level is the prep's act_l)."""
    _check(tables, full)
    n, t_steps, _ = _shape(tables)
    c = tables["const"]
    cols = torch.arange(n, device=tables["step_mw"].device)
    amb0 = tables["ambient"][0]
    one = torch.ones_like(amb0)
    zero = torch.zeros_like(amb0)
    soc, soc_p = tables.get("soc0", one), tables.get("soc0_p", one)
    t_soc, t_skin, t_soc_p, t_skin_p = amb0, amb0, amb0, amb0
    th_state = soc_state = torch.zeros_like(amb0, dtype=torch.bool)
    shut = zero
    max_lv = c["max_level"].long()
    out = {k: [] for k in (TRACE_OUTS if full else OUTS)}
    for t0 in range(0, t_steps, chunk):
        rows = slice(t0, t0 + chunk)
        act = tables["active"][rows, None, :] * tables["act_mult"]
        rest = 1.0 - act
        pre_mw = act * tables["step_mw"][rows] + rest * c["standby_mw"]
        pre_mw_p = act * tables["step_mw_p"][rows] \
            + rest * c["p_standby_mw"]
        pre_pods = act * tables["step_pods"][rows]
        cd = tables["charge"][rows] * c["dsoc_coeff"]
        cd_p = tables["charge_p"][rows] * c["p_dsoc_coeff"]
        for j in range(pre_mw.shape[0]):
            t = t0 + j
            th_state = (t_skin > c["temp_trip"]) \
                | (~(t_skin < c["temp_clear"]) & th_state)
            soc_eff = torch.minimum(soc, soc_p)
            soc_state = (soc_eff < c["soc_trip"]) \
                | (~(soc_eff > c["soc_clear"]) & soc_state)
            lv = torch.minimum(th_state.long() + soc_state.long(), max_lv)

            shut = torch.maximum(shut, (t_skin > c["shutdown_c"]).float())
            shut = torch.maximum(shut, (t_skin_p > c["shutdown_c"]).float()
                                 * c["has_puck"])
            alive = ((soc > 0.0).float() * (soc_p > 0.0).float()
                     * (1.0 - shut) * tables["valid"][t])
            p_mw = pre_mw[j][lv, cols] * alive
            p_p_mw = pre_mw_p[j][lv, cols] * alive * c["has_puck"]

            amb = tables["ambient"][t]
            soc, t_soc, t_skin, drain_mw = _node_step_staged(
                soc, t_soc, t_skin, p_mw, cd[j], amb, "", c)
            soc_p, t_soc_p, t_skin_p, drain_p_mw = _node_step_staged(
                soc_p, t_soc_p, t_skin_p, p_p_mw, cd_p[j], amb, "p_", c)
            pods = pre_pods[j][lv, cols] * alive
            step = {"soc": soc, "soc_p": soc_p, "t_skin": t_skin,
                    "t_skin_p": t_skin_p, "shut": shut,
                    "level": lv.to(torch.int32), "pods": pods,
                    "drain_mw": drain_mw, "drain_p_mw": drain_p_mw}
            if full:
                step.update(t_soc=t_soc, t_soc_p=t_soc_p,
                            th_state=th_state.float(),
                            soc_state=soc_state.float(), p_mw=p_mw,
                            p_p_mw=p_p_mw, act=act[j][lv, cols],
                            alive=alive)
            for k, v in out.items():
                v.append(step[k])
    return {k: torch.stack(v).t() for k, v in out.items()}


def _argtypes(n_outs: int) -> list:
    return [ctypes.c_void_p] * (10 + n_outs) + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]


def _lib():
    from . import build
    return build.load("day_scan")


@functools.lru_cache(maxsize=2)
def _entry(full: bool):
    lib = _lib()
    fn = lib.day_scan_full_launch if full else lib.day_scan_launch
    fn.argtypes = _argtypes(len(TRACE_OUTS if full else OUTS)) \
        + [ctypes.c_void_p] * (len(SOC0_KEYS) if full else 0)
    fn.restype = ctypes.c_int
    return fn


def chunk_steps(n_lvl: int, full: bool = False) -> int:
    """Steps of one chunk of the kernel's shared-memory rings at L levels
    in the default or the full-trace mode (builds the kernel on first
    use)."""
    fn = _lib().day_scan_chunk_steps
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n_lvl, int(full))


def _launch(fn, tables: dict, *extra, outs_keys=OUTS) -> dict:
    """Call the C entry `fn` on the tables; returns the (T, N) outputs
    `outs_keys`, in the entry's order."""
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
                           else torch.float32) for k in outs_keys}
    # `ins` may hold fresh copies that are freed when this returns, while
    # the kernel still runs: the caching allocator only hands their
    # memory to later work on the same stream, which runs after it
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[x.data_ptr() for x in ins],
                 *[v.data_ptr() for v in outs.values()],
                 n, t_steps, n_lvl, len(CONST_KEYS), stream, *extra)
    if err != 0:
        raise RuntimeError(f"day_scan kernel launch failed: CUDA error "
                           f"{err}")
    return outs


def _day_scan_cuda(tables: dict, full: bool = False) -> dict:
    """Launch csrc/day_scan.cu on the current stream (no sync), in the
    full-trace mode when `full`.  The kernel has no backward: a table
    that requires a gradient raises (`guard.refuse_grad`)."""
    global LAUNCHES, FULL_LAUNCHES
    _guard.refuse_grad("day_scan", tables)
    # the initial SoC (full trace only; null = a full charge), held here
    # until the launch is queued
    soc0 = [tables[k].contiguous() if k in tables else None
             for k in SOC0_KEYS] if full else []
    outs = _launch(_entry(full), tables,
                   *[None if x is None else x.data_ptr() for x in soc0],
                   outs_keys=TRACE_OUTS if full else OUTS)
    LAUNCHES += 1
    FULL_LAUNCHES += full
    return {k: v.t() for k, v in outs.items()}


# the probe modes of `day_scan_probe_launch` (csrc/day_scan.cu's header)
PROBE_MODES = {"as is": 0, "inputs in registers": 1,
               "no loads or stores": 2}


def probe_launch(tables: dict, mode: str, source: str = "day_scan") -> dict:
    """Run `csrc/<source>.cu`'s probe entry, built with -DDAY_SCAN_PROBE,
    in `mode` (a key of PROBE_MODES); returns the (T, N) output buffers
    (in "no loads or stores" only soc's first row holds a checksum).
    Measurement only: `LAUNCHES` does not count it."""
    from . import build
    fn = build.load(source, ("DAY_SCAN_PROBE",)).day_scan_probe_launch
    fn.argtypes = _argtypes(len(OUTS)) + [ctypes.c_int]
    fn.restype = ctypes.c_int
    return _launch(fn, tables, PROBE_MODES[mode])
