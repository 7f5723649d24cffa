"""Gradient calibration of the Aria2 model against the paper's numbers.

The paper reports (Fig 4) per-primitive placement deltas, (Fig 3) a 16%
full-on-device saving, and (§VI-C) ~20% power delivery share.  The
physical coefficients THETA (radio energy/bit, pJ/FLOP per IP, PD
efficiency) are fitted by gradient descent: the batched scenario engine
is differentiable in theta, so every Adam step evaluates ALL target
scenarios in one batched forward/backward pass.

Calibration is a `design.DesignSpace` citizen like every other knob set:
`theta_space()` declares the coefficient bounds as Knob leaves, and
`fit_ensemble` runs a multi-restart fit — R perturbed starts through
one `torch.func.vmap`-batched value-and-grad a step — returning a theta
ENSEMBLE with a loss-weighted posterior (mean/std per coefficient)
instead of a single point estimate.  `fit_restarts_sequential` runs
the same trajectories one restart at a time (the parity path).

`fit_queue_coeff` calibrates the queueing contention coefficient
`queue_mw_per_duty` against a synthetic latency/power trace (duty
operating points sampled from the taskgraph-sim tables, contention
power with a mild queueing nonlinearity + measurement noise).

`main` writes its fit to the port's own `CAL_PATH`
(`src/repro_torch/data/calibrated.json`, which `aria2` loads at
import).  Every entry point runs on `device` ("cuda" unless the caller
asks for the CPU).
"""
from __future__ import annotations

import functools as _functools
import json
from pathlib import Path

import numpy as np
import torch

from .. import device as _device
from . import aria2, design, scenarios
from .aria2 import PRIMITIVES, Scenario
from .design import DesignSpace, Knob
from .scenarios import ScenarioSet

# paper targets: scenario -> delta vs full-offload (% of full-offload total)
PAPER_DELTAS = {
    ("hand_tracking",): -14.0,
    ("eye_tracking",): 0.0,
    ("asr",): +7.0,
    ("vio",): +1.0,
    ("vio", "hand_tracking"): -22.0,
    tuple(PRIMITIVES): -16.0,
}
PAPER_PD_SHARE = 0.20            # §VI-C
ANCHOR_TOTAL_MW = 1300.0         # full-offload absolute anchor (soft)

FIT_KEYS = ("wifi_mw_per_mbps", "wifi_link_mw", "pj_ht", "pj_et", "pj_vio",
            "pj_asr", "codec_mw_per_rawmbps", "eff_scale")
BOUNDS = {
    "wifi_mw_per_mbps": (4.0, 20.0),   # nJ/bit plausible range at MCS8
    "wifi_link_mw": (40.0, 180.0),
    "pj_ht": (3.0, 45.0), "pj_et": (3.0, 60.0),
    "pj_vio": (2.0, 25.0), "pj_asr": (5.0, 60.0),
    "codec_mw_per_rawmbps": (0.02, 0.3),
    "eff_scale": (0.9, 1.18),
}

# the port's own fitted coefficients (aria2 loads them at import)
CAL_PATH = Path(__file__).resolve().parents[1] / "data" / "calibrated.json"

# row 0 = full offload; rows 1.. = the paper's placement targets, with the
# full-on-device row doubling as the PD-share probe
_TARGET_PLACEMENTS = [(), *PAPER_DELTAS.keys()]
_TARGETS = np.asarray(list(PAPER_DELTAS.values()), np.float32)
_WEIGHTS = np.asarray([2.0 if len(p) >= 2 else 1.0
                       for p in PAPER_DELTAS], np.float32)
_ON_DEVICE_ROW = _TARGET_PLACEMENTS.index(tuple(PRIMITIVES))


def _target_set() -> ScenarioSet:
    return ScenarioSet.from_scenarios(
        [Scenario("cal", p) for p in _TARGET_PLACEMENTS])


def _unpack(z) -> dict:
    th = {}
    for i, k in enumerate(FIT_KEYS):
        lo, hi = BOUNDS[k]
        th[k] = lo + (hi - lo) * torch.sigmoid(z[i])
    return th


def _pack(theta, device="cuda") -> torch.Tensor:
    """(D,) float32 logits of a theta dict (each coefficient squeezed
    into its bounds)."""
    z = []
    for k in FIT_KEYS:
        lo, hi = BOUNDS[k]
        f = min(max((theta[k] - lo) / (hi - lo), 1e-3), 1 - 1e-3)
        z.append(np.log(f / (1 - f)))
    return torch.tensor(np.asarray(z, np.float32),
                        device=_device.resolve(device))


@_functools.lru_cache(maxsize=8)
def _loss_ctx(device: torch.device):
    """Platform / engine / knob vector / targets of the fit, built once
    per device, so the loss's body is tensor work only."""
    plat = aria2.aria2_platform()
    sset = _target_set()
    scenarios._validate(plat, sset)
    return (plat, sset, scenarios.batched_fn(plat), sset.vec(device),
            torch.as_tensor(_TARGETS, device=device),
            torch.as_tensor(_WEIGHTS, device=device))


def loss_fn(z, extra_theta: dict | None = None):
    """Weighted squared misses of the paper's placement deltas, the PD
    share and the full-offload anchor at packed theta `z` (on z's
    device); differentiable in z, and `torch.func.vmap`-able over a
    leading restart axis."""
    th = _unpack(z)
    if extra_theta:
        th = {**extra_theta, **th}
    plat, sset, eng, vec, targets, weights = _loss_ctx(z.device)
    out = eng(vec, scenarios._theta(plat, th, z.device))
    rep = scenarios.BatchReport(plat, sset, out["loads"], out["total"],
                                out["pd_loss"], out["mbps"])
    totals = rep.total_mw
    p0 = totals[0]
    deltas = 100.0 * (totals[1:] - p0) / p0
    loss = torch.sum(weights * (deltas - targets) ** 2)
    pd = rep.pd_share()[_ON_DEVICE_ROW]
    loss = loss + 3000.0 * (pd - PAPER_PD_SHARE) ** 2
    loss = loss + 0.1 * ((p0 - ANCHOR_TOTAL_MW) / 100.0) ** 2
    return loss


def theta_space() -> DesignSpace:
    """The calibration coefficients as DesignSpace knobs (bounds from
    BOUNDS) — theta is a design leaf like any other."""
    return DesignSpace(tuple(
        Knob(k, *BOUNDS[k], design.CONTINUOUS, (),
             "physical coefficient (calibrate.BOUNDS)")
        for k in FIT_KEYS))


def fit(steps: int = 600, lr: float = 0.05, verbose: bool = True,
        extra_theta: dict | None = None, device="cuda"):
    """Single-start sequential Adam fit from THETA0 (the design core's
    `adam_update`, as every fit in this module)."""
    val_grad = torch.func.grad_and_value(lambda zz: loss_fn(zz, extra_theta))
    z = _pack(aria2.THETA0, device)
    pt, state = {"z": z}, design.adam_init({"z": z})
    for t in range(1, steps + 1):
        g, val = val_grad(pt["z"])
        pt, state = design.adam_update(pt, {"z": g}, state, lr)
        if verbose and (t % 150 == 0 or t == 1):
            print(f"step {t:4d} loss {float(val):9.4f}")
    theta = {k: float(v) for k, v in _unpack(pt["z"]).items()}
    return theta, float(loss_fn(pt["z"], extra_theta))


# ---------------------------------------------------------------------------
# multi-restart ensemble fit (theta posterior)
# ---------------------------------------------------------------------------

def _adam_scan(z0, steps: int, lr: float, extra_theta: dict | None = None,
               loss=None):
    """One Adam trajectory of `steps` steps from `z0` on `loss` (default:
    `loss_fn` with `extra_theta`); returns (z, loss at z)."""
    fn = loss or (lambda zz: loss_fn(zz, extra_theta))
    vg = torch.func.grad_and_value(fn)
    pt = {"z": z0}
    st = design.adam_init(pt)
    for _ in range(steps):
        g, _ = vg(pt["z"])
        pt, st = design.adam_update(pt, {"z": g}, st, lr)
    return pt["z"], fn(pt["z"])


def restart_starts(n_restarts: int, seed: int = 0, spread: float = 1.2,
                   device="cuda") -> torch.Tensor:
    """(R, D) packed start points: THETA0 plus gaussian logit jitter
    (restart 0 is the unperturbed THETA0 pack), drawn on the CPU from a
    `torch.Generator` seeded with `seed`, so both devices start from the
    same points."""
    z0 = _pack(aria2.THETA0, "cpu")
    gen = torch.Generator().manual_seed(int(seed))
    noise = spread * torch.randn((n_restarts, z0.shape[0]), generator=gen)
    noise[0] = 0.0
    return (z0[None, :] + noise).to(_device.resolve(device))


def _starts(z0s, device) -> torch.Tensor:
    """(R, D) float32 start points on `device` from a tensor or an
    array (e.g. the reference package's `restart_starts`)."""
    dev = _device.resolve(device)
    if isinstance(z0s, torch.Tensor):
        return z0s.to(device=dev, dtype=torch.float32)
    return torch.tensor(np.array(z0s, np.float32), device=dev)


def fit_restarts_sequential(z0s, steps: int = 300, lr: float = 0.05,
                            extra_theta: dict | None = None, device="cuda"):
    """A Python loop over restarts, one trajectory at a time."""
    z0s = _starts(z0s, device)
    zs, losses = [], []
    for i in range(z0s.shape[0]):
        z, ls = _adam_scan(z0s[i], steps, lr, extra_theta)
        zs.append(z.detach())
        losses.append(float(ls))
    return torch.stack(zs), np.asarray(losses, np.float32)


def fit_restarts_vmapped(z0s, steps: int = 300, lr: float = 0.05,
                         extra_theta: dict | None = None, device="cuda"):
    """All restarts at once: each Adam step is ONE
    `torch.func.vmap`-batched value-and-grad over the (R, D) starts and
    one elementwise Adam update of all of them."""
    zs = _starts(z0s, device)

    def one(zz):
        return loss_fn(zz, extra_theta)

    vg = torch.func.vmap(torch.func.grad_and_value(one))
    pt = {"z": zs}
    st = design.adam_init(pt)
    for _ in range(steps):
        g, _ = vg(pt["z"])
        pt, st = design.adam_update(pt, {"z": g}, st, lr)
    losses = torch.func.vmap(one)(pt["z"])
    return pt["z"].detach(), losses.detach().cpu().numpy()


def fit_ensemble(n_restarts: int = 8, steps: int = 300, lr: float = 0.05,
                 seed: int = 0, spread: float = 1.2,
                 extra_theta: dict | None = None,
                 temperature: float = 2.0, device="cuda") -> dict:
    """Batched multi-restart calibration with a theta posterior.

    Returns {"thetas": [R dicts], "losses": (R,), "best": best theta,
    "posterior": {coeff: {"mean", "std", "best"}}, ...}.  The posterior
    weights restarts by softmax(-loss / temperature): restarts that
    explain the paper targets equally well but land on different
    coefficients widen the std — the identifiability signal a single
    point fit hides."""
    z0s = restart_starts(n_restarts, seed, spread, device)
    zs, losses = fit_restarts_vmapped(z0s, steps, lr, extra_theta, device)
    thetas = [{k: float(v) for k, v in _unpack(zs[i]).items()}
              for i in range(n_restarts)]
    w = np.exp(-(losses - losses.min()) / temperature)
    w = w / w.sum()
    best_i = int(np.argmin(losses))
    posterior = {}
    for k in FIT_KEYS:
        vals = np.asarray([t[k] for t in thetas])
        mean = float((w * vals).sum())
        posterior[k] = {
            "mean": mean,
            "std": float(np.sqrt((w * (vals - mean) ** 2).sum())),
            "best": float(vals[best_i]),
        }
    return {"thetas": thetas, "losses": losses, "weights": w,
            "best": thetas[best_i], "best_loss": float(losses[best_i]),
            "posterior": posterior, "n_restarts": n_restarts,
            "steps": steps}


# ---------------------------------------------------------------------------
# queue_mw_per_duty: fit against a synthetic latency/power trace
# ---------------------------------------------------------------------------

QUEUE_TRACE_SEED = 11
QUEUE_TRUE_MW_PER_DUTY = 47.0   # ground truth of the trace generator
QUEUE_BOUNDS = (10.0, 120.0)


def _q_of(z):
    """Sigmoid reparameterization of queue_mw_per_duty onto its bounds."""
    lo, hi = QUEUE_BOUNDS
    return lo + (hi - lo) * torch.sigmoid(z)


def synth_queue_trace(n: int = 240, seed: int = QUEUE_TRACE_SEED) -> dict:
    """Synthetic contention telemetry: duty operating points sampled
    from the platform's taskgraph-sim duty tables (every placement mask
    x several frame rates), with "measured" extra power

        P = q_true * duty_total + 1.8 * duty_total^2 + N(0, 2.5)  [mW]

    and an M/M/1-flavored latency column (duty/(1-duty)).  The trace is
    measured AT THE BATTERY (delivered power); the quadratic term and the
    noise are deliberately NOT in the linear model being fitted.  Drawn
    with `np.random.RandomState(seed)`, the same draws in the same order
    as the reference package's trace."""
    rng = np.random.RandomState(seed)
    plat = aria2.aria2_platform()
    tabs = {r: np.asarray(plat.duty_table(r, 0.0))
            for r in ("npu", "dsp", "dram_bus")}
    n_masks = 1 << len(plat.primitives)
    masks = rng.randint(0, n_masks, n)
    fps = rng.choice([1.0, 2.0, 4.0, 8.0], n)
    # the engine's duty loading: npu and dram contention amortize with
    # frame rate, dsp does not (scenarios.LOAD_KINDS)
    duty_total = (tabs["npu"][masks] / fps + tabs["dsp"][masks]
                  + tabs["dram_bus"][masks] / fps)
    extra_mw = (QUEUE_TRUE_MW_PER_DUTY * duty_total
                + 1.8 * duty_total ** 2
                + rng.normal(0.0, 2.5, n))
    util = np.clip(duty_total / duty_total.max(), 0.0, 0.97)
    return {"mask": masks, "fps": fps, "duty_total": duty_total,
            "extra_mw": extra_mw,
            "latency_ms": 4.0 * util / (1.0 - util)}


def fit_queue_coeff(trace: dict | None = None, steps: int = 200,
                    lr: float = 0.2, device="cuda") -> dict:
    """Fit queue_mw_per_duty to the trace THROUGH the batched engine.

    For every trace point the model's contention power is total_mw(q) -
    total_mw(q=0) from the engine (so the fit exercises exactly the
    terms the engine applies, including the per-resource fps
    amortization AND the rail-efficiency division), and q minimizes the
    mean squared residual by `_adam_scan`.  The sampled trace repeats
    operating points, so the engine sees only the `ScenarioSet.dedupe`
    unique rows, scattered back to trace order with the inverse
    indices."""
    dev = _device.resolve(device)
    trace = trace or synth_queue_trace()
    plat = aria2.aria2_platform()
    prim = plat.primitives
    rows = [{"on_device": tuple(p for j, p in enumerate(prim)
                                if m >> j & 1),
             "fps_scale": float(f), "compression": 10.0}
            for m, f in zip(trace["mask"], trace["fps"])]
    full = ScenarioSet.build(rows, primitives=prim)
    sset, inverse = full.dedupe()       # trace repeats operating points
    scenarios._validate(plat, sset)
    inv = torch.as_tensor(inverse, device=dev)
    target = torch.as_tensor(np.asarray(trace["extra_mw"], np.float32),
                             device=dev)
    eng = scenarios.batched_fn(plat)
    vec = sset.vec(dev)
    # the q=0 baseline is z-independent: evaluate once
    off = scenarios.total_mw(
        plat, sset, {"queue_mw_per_duty": torch.zeros((), device=dev)},
        dev)

    def mse(z):
        th = scenarios._theta(plat, {"queue_mw_per_duty": _q_of(z)}, dev)
        return torch.mean(((eng(vec, th)["total"] - off)[inv]
                           - target) ** 2)

    z, final = _adam_scan(torch.zeros((), device=dev), steps, lr, loss=mse)
    q = float(_q_of(z))
    return {"queue_mw_per_duty": q, "mse": float(final),
            "n_points": len(rows), "n_unique_rows": len(sset),
            "nominal": float(aria2.THETA0["queue_mw_per_duty"]),
            "trace_true": QUEUE_TRUE_MW_PER_DUTY}


def report(theta=None, device="cuda") -> dict:
    """Model vs paper: each placement delta with its residual, the PD
    share and the full-offload total."""
    plat = aria2.aria2_platform()
    rep = scenarios.evaluate(plat, _target_set(), theta, device)
    totals = rep.total_mw.detach().cpu().numpy()
    p0 = float(totals[0])
    rows = []
    for i, (placement, target) in enumerate(PAPER_DELTAS.items()):
        d = 100.0 * (float(totals[1 + i]) - p0) / p0
        rows.append({"placement": "+".join(placement), "paper": target,
                     "model": round(d, 2), "residual": round(d - target, 2)})
    pd = float(rep.pd_share().detach().cpu().numpy()[_ON_DEVICE_ROW])
    return {"full_offload_mw": round(p0, 1), "deltas": rows,
            "pd_share": round(pd, 4), "pd_target": PAPER_PD_SHARE}


def main(n_restarts: int = 8, steps: int = 600, device="cuda"):
    """Fit the queue coefficient, then the paper coefficients on top,
    and write both to `CAL_PATH`."""
    # 1. queueing contention coefficient from the synthetic trace
    qfit = fit_queue_coeff(device=device)
    q = {"queue_mw_per_duty": qfit["queue_mw_per_duty"]}
    print(f"queue_mw_per_duty: nominal {qfit['nominal']:.1f} -> fitted "
          f"{q['queue_mw_per_duty']:.2f} (trace truth "
          f"{qfit['trace_true']:.1f}, mse {qfit['mse']:.2f})")
    # 2. batched multi-restart fit of the paper coefficients on top
    ens = fit_ensemble(n_restarts=n_restarts, steps=steps, extra_theta=q,
                       device=device)
    theta = {**ens["best"], **q}
    CAL_PATH.write_text(json.dumps(theta, indent=1))
    print(f"best of {n_restarts} restarts: loss "
          f"{ens['best_loss']:.4f} -> {CAL_PATH}")
    print(json.dumps({k: {kk: round(vv, 3) for kk, vv in p.items()}
                      for k, p in ens["posterior"].items()}, indent=1))
    print(json.dumps(report(theta, device), indent=1))


if __name__ == "__main__":
    main()
