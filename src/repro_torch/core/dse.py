"""Design-space exploration (§V-B, §VI-B) on the batched scenario
engine, and the day-level Pareto front.

Steady-state sweeps, each ONE batched evaluation of one `ScenarioSet`
on the device (`scenarios.evaluate`) and one copy of its results to
the host:
  * placement_sweep      — all on/off-device primitive placements
                           (Fig 4 shows 6 of them).
  * compression_sweep    — compression x fps on the full-offload
                           configuration (Fig 6).
  * grid_sweep           — the full placement x compression x fps grid.
  * sensitivity          — d(total power)/d(theta), one autograd pass
                           through the batched engine.
  * pareto               — placement x compression -> (power, offload
                           bandwidth) front.
  * joint_pareto         — placement x compression x fps x MCS (2304
                           points by default) mapped to backend pods
                           (`offload.pods_breakdown`) and the 3-objective
                           (device mW, uplink Mbps, backend pods) front;
                           `co_optimize` takes budget-constrained
                           argmins over it.
  * platform_ablation    — one scenario across the registered SKUs.

Day level: `day_pareto` fronts (time-to-empty h, peak skin °C, backend
pod-hours) on the port's day pipeline, and the survival filter.  Fleet
level: `fleet_pareto` fronts of population variants ($/day, survival
rate, and dropped stream-hours under an autoscaler).

All dominance filtering uses the correct Pareto test — q dominates p
iff q <= p in every objective and q < p in at least one — so points
that tie on one objective at better cost in another are kept and exact
duplicates all survive.  `non_dominated` is the reference's numpy
filter, copied as-is (the steady-state fronts' and the legacy engine's);
`non_dominated_torch` is its tensor counterpart, which the fused
pipeline runs on the device, one front per query of a batch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import device as _device
from . import aria2, design, offload, scenarios
from .aria2 import Scenario
from .design import DesignSpace
from .platform import PlatformSpec, diff as platform_diff
from .scenarios import MCS_TIERS, ScenarioSet, all_placements


def _plat(platform: PlatformSpec | str | None) -> PlatformSpec:
    if platform is None:
        return aria2.aria2_platform()
    if isinstance(platform, str):
        from . import platform as registry
        aria2.platforms()          # ensure built-ins registered
        return registry.get(platform)
    return platform


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def grid_sweep(platform=None, placements=None,
               compressions=scenarios.GRID_COMPRESSIONS,
               fps_scales=scenarios.GRID_FPS_SCALES, device="cuda",
               **knobs) -> scenarios.BatchReport:
    """Full DSE grid (default 16 x 8 x 6 = 768 points) in one batched
    evaluation.  Default placements are every subset of the primitives
    the platform can run on-device."""
    plat = _plat(platform)
    if placements is None:
        placements = all_placements(plat.supported_primitives())
    sset = ScenarioSet.grid(placements=placements,
                            compressions=compressions,
                            fps_scales=fps_scales,
                            primitives=plat.primitives, **knobs)
    return scenarios.evaluate(plat, sset, device=device)


def placement_sweep(platform=None, device="cuda"):
    plat = _plat(platform)
    subsets = all_placements(plat.supported_primitives())
    sset = ScenarioSet.grid(placements=subsets, compressions=(10.0,),
                            fps_scales=(1.0,), primitives=plat.primitives)
    rep = scenarios.evaluate(plat, sset, device=device)
    totals = _host(rep.total_mw)
    mbps = _host(rep.offloaded_mbps)
    p0 = totals[0]                     # empty subset == full offload
    rows = [{
        "on_device": "+".join(subset) if subset else "(none)",
        "total_mw": round(float(p), 1),
        "delta_pct": round(100 * float(p - p0) / float(p0), 2),
        "offload_mbps": round(float(m), 2),
    } for subset, p, m in zip(subsets, totals, mbps)]
    return sorted(rows, key=lambda r: r["total_mw"])


def compression_sweep(compressions=(1, 2, 4, 8, 16, 32, 64, 128),
                      fps_scales=(1, 2, 4, 8, 16, 32), platform=None,
                      device="cuda"):
    plat = _plat(platform)
    sset = ScenarioSet.grid(placements=((),),
                            compressions=[float(c) for c in compressions],
                            fps_scales=[float(f) for f in fps_scales],
                            primitives=plat.primitives)
    rep = scenarios.evaluate(plat, sset, device=device)
    totals = _host(rep.total_mw)
    mbps = _host(rep.offloaded_mbps)
    rows = []
    for i, (c, f) in enumerate((c, f) for c in compressions
                               for f in fps_scales):
        rows.append({
            "compression": c, "fps_scale": f,
            "offload_mbps": round(float(mbps[i]), 2),
            "total_mw": round(float(totals[i]), 1),
        })
    return rows


def sensitivity(scenario: Scenario | None = None, keys=None, platform=None,
                device="cuda"):
    """d(total)/d(theta_k): mW of system power per unit of coefficient,
    one reverse pass for the whole coefficient set."""
    plat = _plat(platform)
    dev = _device.resolve(device)
    sc = scenario or aria2.FULL_ON_DEVICE
    keys = keys or list(aria2.THETA0)
    th0 = {k: torch.tensor(float(np.float32(aria2.THETA0[k])),
                           device=dev, requires_grad=True) for k in keys}
    sset = ScenarioSet.from_scenarios([sc])
    scenarios._validate(plat, sset)
    total = scenarios.evaluate_batched(plat, sset.vec(dev), th0)["total"][0]
    grads = torch.autograd.grad(total, [th0[k] for k in keys],
                                allow_unused=True)
    base = float(total.detach())
    rows = []
    for k, g in zip(keys, grads):
        grad, value = 0.0 if g is None else float(g), float(th0[k].detach())
        rows.append({"theta": k, "value": value,
                     "d_total_mw_d_theta": grad,
                     "elasticity": grad * value / base})
    return sorted(rows, key=lambda r: -abs(r["elasticity"]))


def non_dominated(points, maximize: tuple = (), block: int = 2048
                  ) -> np.ndarray:
    """Boolean mask of Pareto-optimal rows of an (N, K) objective matrix.

    All objectives are minimized; column indices in `maximize` are
    negated first.  Sort-pruned and block-wise: rows are processed in
    lexicographic order (a dominator always sorts strictly earlier),
    each block compared only against the already-kept prefix."""
    pts = np.asarray(points, np.float64).copy()
    if pts.ndim != 2:
        raise ValueError(f"expected (N, K) objectives, got {pts.shape}")
    for c in maximize:
        pts[:, c] *= -1.0
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    order = np.lexsort(pts.T[::-1])         # ascending by col 0, 1, ...
    spts = pts[order]
    keep = np.ones(n, bool)
    for start in range(0, n, block):
        end = min(start + block, n)
        blk = spts[start:end]
        # candidates: surviving strict predecessors + the block itself
        # (intra-block dominators also sort earlier, so one pass suffices)
        cand = np.concatenate([spts[:start][keep[:start]], blk])
        le = (cand[:, None, :] <= blk[None, :, :]).all(-1)
        lt = (cand[:, None, :] < blk[None, :, :]).any(-1)
        keep[start:end] = ~(le & lt).any(axis=0)
    mask = np.empty(n, bool)
    mask[order] = keep
    return mask


def non_dominated_torch(points: torch.Tensor,
                        maximize: tuple = ()) -> torch.Tensor:
    """Non-dominated mask of an (N, K) tensor, or of each query of a
    (Q, N, K) tensor among its own N rows, on its device, with the numpy
    filter's tie semantics.

    Rows are lexsorted (column 0 primary: stable sorts from the last
    column to the first), and each row is tested only against its strict
    predecessors in that order — any dominator sorts strictly earlier,
    and exact duplicates never dominate each other."""
    if points.ndim not in (2, 3):
        raise ValueError(f"expected (N, K) or (Q, N, K) objectives, got "
                         f"{tuple(points.shape)}")
    if points.ndim == 2:
        return non_dominated_torch(points[None], maximize)[0]
    q, n, k = points.shape
    dev = points.device
    if n == 0:
        return torch.zeros((q, 0), dtype=torch.bool, device=dev)
    pts = points.clone()
    for c in maximize:
        pts[..., c] = -pts[..., c]
    order = torch.arange(n, device=dev).expand(q, n)
    for c in range(k - 1, -1, -1):
        col = torch.gather(pts[..., c], 1, order)
        order = torch.gather(order, 1,
                             torch.sort(col, dim=1, stable=True).indices)
    spts = torch.gather(pts, 1, order[..., None].expand(q, n, k))
    # le[:, j, i]: row j <= row i in every objective (j sorted first)
    le = (spts[:, :, None, :] <= spts[:, None, :, :]).all(-1)
    lt = (spts[:, :, None, :] < spts[:, None, :, :]).any(-1)
    idx = torch.arange(n, device=dev)
    earlier = idx[:, None] < idx[None, :]   # j strictly before i in sort
    dominated = (le & lt & earlier).any(dim=1)
    mask = torch.zeros((q, n), dtype=torch.bool, device=dev)
    return mask.scatter(1, order, ~dominated)


def pareto(compressions=(4, 10, 20, 40), platform=None, device="cuda"):
    """Placement x compression -> non-dominated (power, bandwidth) points.

    Row order of `pts` follows ScenarioSet.grid (placement outermost,
    then compression), so labels stay in lockstep with the batch."""
    plat = _plat(platform)
    subsets = all_placements(plat.supported_primitives())
    sset = ScenarioSet.grid(placements=subsets,
                            compressions=[float(c) for c in compressions],
                            fps_scales=(1.0,), primitives=plat.primitives)
    labels = [(sset.on_device(i), float(sset.compression[i]))
              for i in range(len(sset))]
    rep = scenarios.evaluate(plat, sset, device=device)
    totals = _host(rep.total_mw)
    mbps = _host(rep.offloaded_mbps)
    pts = [{
        "on_device": "+".join(s) or "(none)",
        "compression": int(c) if float(c).is_integer() else c,
        "total_mw": round(float(totals[i]), 1),
        "offload_mbps": round(float(mbps[i]), 2),
    } for i, (s, c) in enumerate(labels)]
    keep = non_dominated(np.stack([totals, mbps], axis=1), maximize=(1,))
    front = sorted((pts[i] for i in np.flatnonzero(keep)),
                   key=lambda r: r["total_mw"])
    return pts, front


# ---------------------------------------------------------------------------
# joint device+backend co-optimization (the full-system Amdahl argument)
# ---------------------------------------------------------------------------

JOINT_MCS_TIERS = tuple(range(len(MCS_TIERS)))


@dataclass
class JointReport:
    """Joint device+backend design-space evaluation.

    Arrays share the ScenarioSet's leading dim N.  Objectives: device_mw
    (minimize), uplink_mbps (maximize — context-fidelity proxy),
    backend_pods (minimize).  front_mask marks the 3-objective
    non-dominated set; sources records whether each backend stream's
    capacity came from a dry-run artifact or the fallback bound, and
    `breakdown` carries the per-stream pods (offload.PodsBreakdown)."""
    sset: ScenarioSet
    device_mw: np.ndarray           # (N,)
    uplink_mbps: np.ndarray         # (N,)
    backend_pods: np.ndarray        # (N,)
    front_mask: np.ndarray          # (N,) bool
    sources: dict                   # stream -> "dryrun" | "fallback"
    n_users: float
    duty: float
    breakdown: offload.PodsBreakdown | None = None

    def __len__(self) -> int:
        return len(self.sset)

    def objectives(self) -> np.ndarray:
        """(N, 3) matrix [device_mw, uplink_mbps, backend_pods]."""
        return np.stack([self.device_mw, self.uplink_mbps,
                         self.backend_pods], axis=1)

    def front_indices(self) -> np.ndarray:
        return np.flatnonzero(self.front_mask)

    def missing_streams(self) -> list:
        """Fallback-sized streams that actually reach the backend."""
        if self.breakdown is not None:
            return self.breakdown.missing_streams()
        return offload.missing_streams(self.sources)

    def stream_archs(self) -> dict:
        """stream -> serving arch chosen by min-pods (STREAM_CANDIDATES)."""
        if self.breakdown is not None:
            return dict(self.breakdown.archs)
        return {s: arch for s, (arch, _, _) in
                offload.STREAM_SERVICE.items()}

    def cost_per_day(self) -> dict:
        """Steady-state fleet cost: pods x 24 h -> $ and kgCO2 per day."""
        return offload.pod_cost(self.backend_pods * 24.0)

    def row(self, i: int) -> dict:
        s = self.sset
        cost = offload.pod_cost(float(self.backend_pods[i]) * 24.0)
        out = {
            "index": int(i),
            "on_device": "+".join(s.on_device(i)) or "(none)",
            "compression": float(s.compression[i]),
            "fps_scale": float(s.fps_scale[i]),
            "mcs": MCS_TIERS[int(s.mcs_tier[i])][0],
            "upload_duty": round(float(s.upload_duty[i]), 3),
            "brightness": round(float(s.brightness[i]), 3),
            "device_mw": round(float(self.device_mw[i]), 1),
            "uplink_mbps": round(float(self.uplink_mbps[i]), 2),
            "backend_pods": round(float(self.backend_pods[i]), 1),
            "usd_per_day": round(cost["usd"], 0),
            "kgco2_per_day": round(cost["kgco2"], 0),
        }
        if self.breakdown is not None:
            out["pods_by_stream"] = self.breakdown.row(i)
        return out

    def front_rows(self) -> list:
        rows = [self.row(i) for i in self.front_indices()]
        return sorted(rows, key=lambda r: r["device_mw"])


def joint_pareto(platform=None, placements=None,
                 compressions=scenarios.GRID_COMPRESSIONS,
                 fps_scales=scenarios.GRID_FPS_SCALES,
                 mcs_tiers=JOINT_MCS_TIERS,
                 upload_duties=(1.0,), brightnesses=(0.0,),
                 n_users: float = 1e6, duty: float = 0.35,
                 results_dir=None, theta=None,
                 device="cuda") -> JointReport:
    """Joint device+backend Pareto sweep: the grid (16 placements x 8
    compressions x 6 fps x 3 MCS tiers = 2304 points by default, times
    any upload duties and brightnesses) in one batched evaluation on
    `device`, one numpy fleet-sizing pass (`offload.pods_breakdown`) and
    one blockwise dominance pass (`non_dominated`) on the host, in
    float64."""
    plat = _plat(platform)
    if placements is None:
        placements = all_placements(plat.supported_primitives())
    sset = ScenarioSet.grid(placements=placements,
                            compressions=[float(c) for c in compressions],
                            fps_scales=[float(f) for f in fps_scales],
                            mcs_tiers=[int(m) for m in mcs_tiers],
                            upload_duties=[float(u) for u in upload_duties],
                            brightnesses=[float(b) for b in brightnesses],
                            primitives=plat.primitives)
    rep = scenarios.evaluate(plat, sset, theta, device)
    device_mw = _host(rep.total_mw).astype(np.float64)
    uplink = _host(rep.offloaded_mbps).astype(np.float64)
    bd = offload.pods_breakdown(sset, n_users=n_users, duty=duty,
                                results_dir=results_dir)
    objs = np.stack([device_mw, uplink, bd.pods], axis=1)
    mask = non_dominated(objs, maximize=(1,))
    return JointReport(sset, device_mw, uplink, bd.pods, mask, bd.sources,
                       n_users, duty, breakdown=bd)


def _lex_argmin(keys: list, feasible: np.ndarray):
    """Index minimizing keys lexicographically over a feasibility mask."""
    idx = np.flatnonzero(feasible)
    if idx.size == 0:
        return None
    order = np.lexsort(tuple(np.asarray(k)[idx] for k in reversed(keys)))
    return int(idx[order[0]])


def co_optimize(rep: JointReport, pod_budget: float | None = None,
                power_budget_mw: float | None = None,
                usd_budget_per_day: float | None = None) -> dict:
    """Constrained argmins over a joint grid (deterministic tie-breaks).

    * device_optimum            — min device power, backend unconstrained
      (ties broken toward fewer pods, then higher uplink).
    * min_power_under_pod_budget — min device power s.t. pods <= budget.
    * min_pods_under_power_budget — min pods s.t. device power <= budget
      (ties toward lower power, then higher uplink).
    * min_power_under_usd_budget — min device power s.t. the 24 h fleet
      bill (offload.pod_cost) fits `usd_budget_per_day`.
    Infeasible constraints yield None rows."""
    ones = np.ones(len(rep), bool)
    out = {"device_optimum": rep.row(_lex_argmin(
        [rep.device_mw, rep.backend_pods, -rep.uplink_mbps], ones))}
    if pod_budget is not None:
        i = _lex_argmin([rep.device_mw, rep.backend_pods, -rep.uplink_mbps],
                        rep.backend_pods <= pod_budget)
        out["pod_budget"] = pod_budget
        out["min_power_under_pod_budget"] = None if i is None else rep.row(i)
    if power_budget_mw is not None:
        i = _lex_argmin([rep.backend_pods, rep.device_mw, -rep.uplink_mbps],
                        rep.device_mw <= power_budget_mw)
        out["power_budget_mw"] = power_budget_mw
        out["min_pods_under_power_budget"] = None if i is None else rep.row(i)
    if usd_budget_per_day is not None:
        usd = rep.cost_per_day()["usd"]
        i = _lex_argmin([rep.device_mw, rep.backend_pods, -rep.uplink_mbps],
                        usd <= usd_budget_per_day)
        out["usd_budget_per_day"] = usd_budget_per_day
        out["min_power_under_usd_budget"] = None if i is None else rep.row(i)
    return out


def platform_ablation(names=None, on_device=(), compression: float = 10.0,
                      fps_scale: float = 1.0, device="cuda") -> list:
    """Registry-driven SKU comparison: evaluate one common scenario row
    across platforms and diff each SKU's component table against the
    first (baseline) entry.  Placements a SKU cannot run are downshifted
    to the supported subset."""
    from . import platform as registry
    if names is None:
        names = registry.names()
    plats = [_plat(n) for n in names]
    base = plats[0]
    rows = []
    for plat in plats:
        placement = tuple(p for p in on_device
                          if p in plat.supported_primitives())
        sset = ScenarioSet.grid(placements=(placement,),
                                compressions=(float(compression),),
                                fps_scales=(float(fps_scale),),
                                primitives=plat.primitives)
        rep = scenarios.evaluate(plat, sset, device=device)
        d = platform_diff(base, plat)
        rows.append({
            "platform": plat.name,
            "n_components": len(plat),
            "on_device": "+".join(placement) or "(none)",
            "total_mw": round(float(rep.total_mw[0]), 1),
            "offload_mbps": round(float(rep.offloaded_mbps[0]), 2),
            "vs_baseline": {
                "added": sorted(d["added"]),
                "dropped": sorted(d["dropped"]),
                "changed": sorted(d["changed"]),
                "theta": d["theta"], "raw_mbps": d["raw_mbps"],
            },
        })
    base_mw = rows[0]["total_mw"]
    for r in rows:
        r["delta_mw_vs_baseline"] = round(r["total_mw"] - base_mw, 1)
    return rows


def day_pareto(platforms=None, designs=None, schedules=None, policies=None,
               engine: str = "fused", device="cuda", **kw):
    """Day-level Pareto front over (time-to-empty h, peak skin °C,
    backend pod-hours), time-to-empty maximized.

    Every (platform x design x schedule x policy) combo runs through
    `daysim.day_grid` on `device`.  With `engine="fused"` the front is
    taken on the device by `non_dominated_torch`; `engine="legacy"` is
    the reference's oracle path (host-cached numpy tables, the same
    day-scan kernel, the float64 host summary and the numpy
    `non_dominated`).  Returns the `daysim.DayReport` with `front_mask`
    filled."""
    from . import daysim
    args = {k: v for k, v in (("platforms", platforms),
                              ("designs", designs),
                              ("schedules", schedules),
                              ("policies", policies)) if v is not None}
    if engine == "fused":
        return daysim.day_grid(**args, engine="fused", with_front=True,
                               device=device, **kw)
    if engine != "legacy":
        raise ValueError(f"unknown engine {engine!r}; "
                         f"expected 'fused' or 'legacy'")
    rep = daysim.day_grid(**args, engine="legacy", device=device, **kw)
    rep.front_mask = non_dominated(rep.objectives(), maximize=(0,))
    return rep


def day_pareto_batch(queries, device="cuda", **shared):
    """Batched `day_pareto`: K value-level what-ifs through one day-scan
    launch (`daysim.day_grid_batch`).

    `queries` is a sequence of dicts of `day_pareto` grid kwargs layered
    over `shared`; every query must land in the same bucketed shape
    signature (`daysim.day_grid_groups` takes queries of any signatures
    and groups them).  Returns one `DayReport` per query, `front_mask`
    filled, each bit-identical to the serial `day_pareto` answer for the
    same kwargs."""
    from . import daysim
    return daysim.day_grid_batch(list(queries), device=device, **shared)


def survives_day(rep=None, skin_limit_c: float = 43.0, **kw):
    """(N,) bool per combo: the cell lasts the whole schedule AND peak
    skin temperature stays under the comfort limit.  Pass an existing
    `DayReport` or kwargs to run one."""
    if rep is None:
        rep = day_pareto(**kw)
    elif kw:
        raise TypeError(f"got both a DayReport and grid kwargs "
                        f"{sorted(kw)}; pass one or the other")
    return rep.survives(skin_limit_c)


# ---------------------------------------------------------------------------
# gradient-based design optimization on the DesignSpace
# ---------------------------------------------------------------------------

@dataclass
class GradResult:
    """`gradient_descend` output: each restart's BEST-SEEN point along
    its whole trajectory (leading dim R; not the final Adam iterate —
    projected Adam can overshoot late) with the matching losses, plus
    the best point/loss across restarts."""
    space: DesignSpace
    points: dict                    # {knob: (R, ...)}
    losses: np.ndarray              # (R,)
    best_point: dict                # {knob: (...)}  best restart
    best_loss: float
    steps: int

    def restart_points(self) -> list:
        r = len(self.losses)
        return [{k: np.asarray(v)[i] for k, v in self.points.items()}
                for i in range(r)]


def _keep_better(better: torch.Tensor, new: dict, old: dict) -> dict:
    return {k: torch.where(better.reshape((-1,) + (1,) * (p.ndim - 1)),
                           p, old[k]) for k, p in new.items()}


def gradient_descend(space: DesignSpace, loss_fn, n_restarts: int = 8,
                     steps: int = 200, lr: float = 0.05, seed: int = 0,
                     init: dict | None = None, starts: dict | None = None,
                     device="cuda") -> GradResult:
    """Projected Adam over a DesignSpace point, all restarts batched.

    `loss_fn(point) -> 0-dim tensor` takes one point (0-dim or
    knob-shaped leaves); every Adam update evaluates ALL restarts in one
    `torch.func.vmap(torch.func.grad_and_value(loss_fn))` call, and the
    projection (`space.clip`) keeps every leaf inside its declared
    bounds.  The restarts sample uniformly in bounds from `seed`
    (`DesignSpace.uniform_sample`), or are `starts` ({knob: (R, ...)})
    when given; restart 0 starts from `init` when given (so a known-good
    grid point can only be improved on).  The best point/loss seen over
    ALL steps and restarts is tracked on the device (no host sync per
    step), and one final evaluation lets the last projected update
    compete."""
    dev = _device.resolve(device)
    if starts is not None:
        pts = {k: starts[k].to(dev) if isinstance(starts[k], torch.Tensor)
               else torch.tensor(np.array(starts[k]), device=dev)
               for k in space.names()}
        n_restarts = len(next(iter(pts.values())))
    else:
        pts = space.uniform_sample(seed, n_restarts, dev)
    if init is not None:
        space.validate(init)
        pts = {k: torch.cat([torch.as_tensor(init[k], dtype=v.dtype,
                                             device=dev)[None], v[1:]])
               for k, v in pts.items()}
    pts = space.clip(pts)
    vg = torch.func.vmap(torch.func.grad_and_value(loss_fn))
    state = design.adam_init(pts)
    best_loss = torch.full((n_restarts,), float("inf"), device=dev)
    best_pts = pts
    for _ in range(steps):
        grads, losses = vg(pts)
        new, state = design.adam_update(pts, grads, state, lr)
        better = losses < best_loss
        best_loss = torch.where(better, losses, best_loss)
        best_pts = _keep_better(better, pts, best_pts)
        pts = space.clip(new)
    _, losses = vg(pts)
    better = losses < best_loss
    best_loss = torch.where(better, losses, best_loss).cpu().numpy()
    best_pts = {k: v.detach().cpu().numpy()
                for k, v in _keep_better(better, pts, best_pts).items()}
    i = int(np.argmin(best_loss))
    return GradResult(space, best_pts, best_loss,
                      {k: v[i] for k, v in best_pts.items()},
                      float(best_loss[i]), steps)


def sensitivity_map(platform=None, sset: ScenarioSet | None = None,
                    theta=None, device="cuda") -> dict:
    """Per-scenario d(total mW)/d(knob) over a whole grid in ONE reverse
    pass.

    Each scenario's total depends only on its own knob row, so pulling
    back a ones-cotangent through `scenarios.total_mw_relaxed` yields
    the exact per-scenario gradient rows for every knob at once — (N,)
    for scalar knobs, (N, 4) for placement probabilities, (N, 3) for MCS
    weights."""
    plat = _plat(platform)
    if sset is None:
        sset = ScenarioSet.grid(
            placements=all_placements(plat.supported_primitives()),
            primitives=plat.primitives)
    vec = {k: v.requires_grad_()
           for k, v in scenarios.relax_vec(sset, device).items()}
    total = scenarios.total_mw_relaxed(plat, vec, theta)
    grads = torch.autograd.grad(total, list(vec.values()),
                                grad_outputs=torch.ones_like(total),
                                allow_unused=True, materialize_grads=True)
    return {
        "sset": sset,
        "total_mw": _host(total),
        "d_mw_d": {k: _host(g) for k, g in zip(vec, grads)},
    }


def sensitivity_rows(sense: dict, top: int = 10) -> list:
    """Human-readable top rows of a `sensitivity_map` (largest placement
    leverage first: the biggest |d mW / d placement prob| anywhere)."""
    sset = sense["sset"]
    pl = sense["d_mw_d"]["placement"]
    lever = np.abs(pl).max(axis=1)
    order = np.argsort(-lever)[:top]
    return [{
        "scenario": sset.label(int(i)),
        "compression": float(sset.compression[i]),
        "fps_scale": float(sset.fps_scale[i]),
        "total_mw": round(float(sense["total_mw"][i]), 1),
        "d_mw_d_placement": {p: round(float(pl[i, j]), 1)
                             for j, p in enumerate(sset.primitives)},
        "d_mw_d_upload_duty": round(
            float(sense["d_mw_d"]["upload_duty"][i]), 1),
        "d_mw_d_fps_scale": round(
            float(sense["d_mw_d"]["fps_scale"][i]), 2),
    } for i in order]


def policy_loss(day_fn, cap: float, peak_weight: float = 8.0):
    """`optimize_policy`'s objective on a relaxed day `day_fn`: minus the
    smooth time-to-empty plus `peak_weight` x the mean softplus (sharpness
    4 / K, written as logaddexp: `F.softplus` is the identity above its
    threshold) of skin temperature above `cap`."""
    def loss(point):
        out = day_fn(point)
        x = (out["t_skin"] - cap) * 4.0
        exceed = torch.mean(torch.logaddexp(x, torch.zeros_like(x)) / 4.0)
        return -out["soft_tte_h"] + peak_weight * exceed

    return loss


def optimize_policy(platform, design_row, schedule, policy_template,
                    peak_cap_c: float | None = None,
                    n_restarts: int = 6, steps: int = 120,
                    lr: float = 0.08, seed: int = 0,
                    dt_s: float = 60.0, peak_weight: float = 8.0,
                    starts: dict | None = None, device="cuda",
                    **day_kw) -> dict:
    """Gradient-optimize ThrottlePolicy trip/clear bands through the
    differentiable day (straight-through trip comparisons), then
    HARD-validate.

    Maximizes the smooth time-to-empty surrogate subject to a softplus
    penalty on skin-time above `peak_cap_c` (default: the template
    policy's own hard peak — "equal peak skin").  The template's
    thresholds seed restart 0, so the optimizer can only improve on the
    grid policy it starts from; every restart's best point is hardened
    back into a `ThrottlePolicy` and re-simulated with the exact
    integrator (`daysim.simulate`: one full-trace day-scan launch each,
    after the baseline's) — the returned winner is the best HARD
    time-to-empty among candidates whose hard peak respects the cap.
    `starts` ({knob: (R, ...)}) replaces the sampled restarts.

    `day_kw` accepts any day knob of `daysim.relaxed_day_fn` or
    `daysim.simulate` (standby_mw/battery/thermal/theta/shutdown_c,
    n_users/results_dir, tau/ste_beta_*/soft_alive_*); each is routed
    only to the callee that understands it, unknown keys raise."""
    from . import daysim
    shared = {"standby_mw", "battery", "thermal", "theta", "shutdown_c",
              "n_users", "results_dir"}
    relax_only = {"tau", "ste_beta_c", "ste_beta_soc",
                  "soft_alive_margin", "soft_alive_beta"}
    unknown = set(day_kw) - shared - relax_only
    if unknown:
        raise TypeError(f"optimize_policy: unknown day kwargs "
                        f"{sorted(unknown)}")
    relax_kw = {k: v for k, v in day_kw.items()
                if k in shared | relax_only}
    sim_kw = {k: v for k, v in day_kw.items() if k in shared}
    dev = _device.resolve(device)
    pol = daysim._resolve(policy_template, daysim.get_policy,
                          daysim.ThrottlePolicy)
    if not pol.actions:
        raise ValueError("policy_template needs throttle actions to tune")
    f = daysim.relaxed_day_fn(platform, schedule, pol, design_row,
                              dt_s=dt_s, device=dev, **relax_kw)
    space = design.policy_space()
    init = design.policy_point(pol, dev)
    base = daysim.simulate(platform, design_row, schedule, pol, dt_s=dt_s,
                           device=dev, **sim_kw)
    cap = (float(base.summary["peak_skin_c"]) if peak_cap_c is None
           else float(peak_cap_c))

    res = gradient_descend(space, policy_loss(f, cap, peak_weight),
                           n_restarts=n_restarts, steps=steps, lr=lr,
                           seed=seed, init=init, starts=starts, device=dev)

    def harden(pt) -> "daysim.ThrottlePolicy":
        return daysim.ThrottlePolicy(
            f"{pol.name}_grad",
            temp_trip_c=float(pt["temp_trip_c"]),
            temp_clear_c=float(pt["temp_trip_c"] - pt["temp_band_c"]),
            soc_trip=float(pt["soc_trip"]),
            soc_clear=float(min(pt["soc_trip"] + pt["soc_band"], 0.95)),
            actions=pol.actions)

    candidates = []
    for pt in res.restart_points():
        cand = harden(pt)
        tr = daysim.simulate(platform, design_row, schedule, cand,
                             dt_s=dt_s, device=dev, **sim_kw)
        candidates.append((tr.summary["time_to_empty_h"],
                           tr.summary["peak_skin_c"], cand, pt))
    feasible = [c for c in candidates if c[1] <= cap + 1e-6]
    pool = feasible or candidates
    tte, peak, best_pol, best_pt = max(pool, key=lambda c: c[0])
    return {
        "policy": best_pol,
        "point": {k: float(v) for k, v in best_pt.items()},
        "tte_h": float(tte),
        "peak_skin_c": float(peak),
        "peak_cap_c": cap,
        "feasible": bool(feasible),
        "baseline": {"policy": pol.name,
                     "tte_h": float(base.summary["time_to_empty_h"]),
                     "peak_skin_c": float(base.summary["peak_skin_c"])},
        "gain_h": float(tte - base.summary["time_to_empty_h"]),
        "restarts": n_restarts, "steps": steps,
    }


# ---------------------------------------------------------------------------
# fleet-level fronts: population variants over ($/day, survival rate)
# ---------------------------------------------------------------------------

@dataclass
class FleetFront:
    """`fleet_pareto` output: one row per population variant plus the
    non-dominated mask over (autoscaled fleet $/day minimized, survival
    rate maximized — and dropped stream-hours minimized when the sweep
    was priced with an autoscaler)."""
    rows: list
    front_mask: np.ndarray

    def front_rows(self) -> list:
        return [r for r, m in zip(self.rows, self.front_mask) if m]


def fleet_pareto(spec=None, variants=None, n_users: int = 1024, key=0,
                 dt_s: float = 60.0, fleet_size: float = 1e6,
                 n_draws: int = 1, autoscaler=None, ci: float = 0.90,
                 device="cuda", **kw) -> FleetFront:
    """SKU-mix / policy Pareto front at fleet scale: backend $/day vs the
    fraction of users whose device survives the day (vs dropped
    stream-hours, when an `autoscale.AutoscalerSpec` prices the lagging
    fleet), each variant's fleet day on `device`.

    Each variant is a `(name, PopulationSpec)` — by default every
    (policy x design) override of `spec` via
    `PopulationSpec.with_overrides`.  ONE population sample (same key)
    is reused across variants, so fronts compare policy/design choices
    on the identical fleet.  Costs are the autoscaled diurnal-curve
    pricing at `fleet_size` users.

    `n_draws > 1` runs the sweep as Monte Carlo over the population key
    (`montecarlo.fleet_distribution`, the same `key` per variant =
    common random numbers): rows carry mean objectives plus `ci`-level
    `*_lo` / `*_hi` bands, and the front ranks the means."""
    from . import daysim, fleet, montecarlo
    dev = str(_device.resolve(device))
    if spec is None:
        spec = fleet.DEFAULT_POPULATION
    if variants is None:
        variants = [(f"{pol}/{row['name']}",
                     spec.with_overrides(f"{spec.name}:{pol}:"
                                         f"{row['name']}",
                                         policy=pol, design=row))
                    for pol in daysim.DEFAULT_POLICIES
                    for row in daysim.DEFAULT_DESIGNS]
    rows = []
    if n_draws > 1:
        for name, vspec in variants:
            dist = montecarlo.fleet_distribution(
                vspec, n_users, n_draws, key, ci=ci,
                autoscaler=autoscaler, dt_s=dt_s,
                fleet_size=fleet_size, device=dev, **kw)
            sv, cost = dist.survival_rate(), dist.cost()
            usd = cost["autoscaled_usd"]
            row = {
                "variant": name, "n_draws": n_draws,
                "survival_rate": sv["mean"],
                "survival_lo": sv["lo"], "survival_hi": sv["hi"],
                "usd_per_day": usd["mean"],
                "usd_lo": usd["lo"], "usd_hi": usd["hi"],
                "tte_p50_h": dist.tte_quantiles()["p50"]["mean"],
            }
            if autoscaler is not None:
                row["dynamic_usd_per_day"] = cost["dynamic_usd"]["mean"]
                drop = cost["dropped_stream_hours"]
                row["dropped_stream_hours"] = drop["mean"]
                row["dropped_stream_hours_hi"] = drop["hi"]
            rows.append(row)
    else:
        pop = fleet.sample_population(spec, n_users, key)
        for name, vspec in variants:
            vpop = replace(pop, spec=vspec)
            rep = fleet.fleet_day(vpop, dt_s=dt_s,
                                  fleet_size=fleet_size, device=dev, **kw)
            plan = rep.capacity_plan(autoscaler=autoscaler)
            row = {
                "variant": name,
                "survival_rate": rep.survival_rate(),
                "usd_per_day": plan["autoscaled"]["usd"],
                "peak_usd_per_day": plan["peak_provisioned"]["usd"],
                "kg_co2_per_day": plan["autoscaled"]["kgco2"],
                "peak_pods": plan["peak_pods"],
                "trough_peak_ratio": plan["trough_peak_ratio"],
                "tte_p50_h": plan["tte_quantiles_h"]["p50"],
                "shutdowns": plan["shutdowns"],
            }
            if autoscaler is not None:
                row["dynamic_usd_per_day"] = plan["dynamic"]["usd"]
                row["dropped_stream_hours"] = \
                    plan["dropped_stream_hours"]
            rows.append(row)
    cols = ["usd_per_day", "survival_rate"]
    maximize = (1,)
    if autoscaler is not None:
        cols.append("dropped_stream_hours")
    pts = np.asarray([[r[c] for c in cols] for r in rows])
    return FleetFront(rows, non_dominated(pts, maximize=maximize))
