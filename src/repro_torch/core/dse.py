"""Day-level design-space exploration: the Pareto front over
(time-to-empty h, peak skin °C, backend pod-hours) and the survival
filter, on the port's fused day pipeline.

All dominance filtering uses the correct Pareto test — q dominates p
iff q <= p in every objective and q < p in at least one — so points
that tie on one objective at better cost in another are kept and exact
duplicates all survive.  `non_dominated` is the reference's numpy
filter, copied as-is (the legacy engine's front); `non_dominated_torch`
is its tensor counterpart, which the fused pipeline runs on the device,
one front per query of a batch.
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
