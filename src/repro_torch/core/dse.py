"""Day-level design-space exploration: the Pareto front over
(time-to-empty h, peak skin °C, backend pod-hours) and the survival
filter, on the port's fused day pipeline.

All dominance filtering uses the correct Pareto test — q dominates p
iff q <= p in every objective and q < p in at least one — so points
that tie on one objective at better cost in another are kept and exact
duplicates all survive.  `non_dominated` is the reference's numpy
filter, copied as-is; `non_dominated_torch` is its tensor counterpart,
which the pipeline runs on the device.
"""
from __future__ import annotations

import numpy as np
import torch


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
    """Non-dominated mask of an (N, K) tensor, on its device, with the
    numpy filter's tie semantics.

    Rows are lexsorted (column 0 primary: stable sorts from the last
    column to the first), and each row is tested only against its strict
    predecessors in that order — any dominator sorts strictly earlier,
    and exact duplicates never dominate each other."""
    if points.ndim != 2:
        raise ValueError(f"expected (N, K) objectives, got "
                         f"{tuple(points.shape)}")
    n, k = points.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    pts = points.clone()
    for c in maximize:
        pts[:, c] = -pts[:, c]
    order = torch.arange(n, device=pts.device)
    for c in range(k - 1, -1, -1):
        order = order[torch.sort(pts[order, c], stable=True).indices]
    spts = pts[order]
    le = (spts[:, None, :] <= spts[None, :, :]).all(-1)  # le[j,i]: q_j<=p_i
    lt = (spts[:, None, :] < spts[None, :, :]).any(-1)
    idx = torch.arange(n, device=pts.device)
    earlier = idx[:, None] < idx[None, :]   # j strictly before i in sort
    dominated = (le & lt & earlier).any(dim=0)
    mask = torch.zeros(n, dtype=torch.bool, device=pts.device)
    mask[order] = ~dominated
    return mask


def day_pareto(platforms=None, designs=None, schedules=None, policies=None,
               engine: str = "fused", device="cuda", **kw):
    """Day-level Pareto front over (time-to-empty h, peak skin °C,
    backend pod-hours), time-to-empty maximized.

    Every (platform x design x schedule x policy) combo runs through
    `daysim.day_grid(engine="fused")` on `device`; the front is taken on
    the device by `non_dominated_torch`.  Returns the `daysim.DayReport`
    with `front_mask` filled."""
    from . import daysim
    args = {k: v for k, v in (("platforms", platforms),
                              ("designs", designs),
                              ("schedules", schedules),
                              ("policies", policies)) if v is not None}
    return daysim.day_grid(**args, engine=engine, with_front=True,
                           device=device, **kw)


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
