"""Interactive design twin over the fused day-Pareto pipeline.

`DesignTwin` holds a base grid (platforms x designs x schedules x
policies plus dt_s / n_users and any other `dse.day_pareto` kwarg),
warms it once at construction, and then answers value-level what-ifs —
swap a policy's thresholds, a battery, a platform — through the same
device-resident pipeline: the day scan runs as the hand-written CUDA
kernel on the card.

`query(**grid_overrides)` runs one full grid and returns the DayReport
with the front attached; `what_if(design=..., policy=...)` is the
single-combo ergonomic wrapper (singular axes become 1-tuples).
`TwinStats` tracks query count, latency, and the host pipeline-cache
hits and misses.  PyTorch runs eagerly, so `TwinStats.traces` (the
reference's retrace counter) always reads 0.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..core import daysim, dse


@dataclass
class TwinStats:
    queries: int = 0
    pipeline_hits: int = 0      # queries served from a resident pipeline
    pipeline_misses: int = 0    # queries that assembled a new one
    traces: int = 0             # eager PyTorch never traces: stays 0
    last_ms: float = 0.0
    total_ms: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.queries if self.queries else 0.0


class DesignTwin:
    """Warm, device-resident model of the design space; ask it questions.

    Base-grid axes default to the daysim defaults; any constructor
    kwarg accepted by `dse.day_pareto` (battery, thermal, theta,
    standby_mw, ...) rides along into every query.  Queries are
    serialized behind one lock."""

    _SINGULAR = {"platform": "platforms", "design": "designs",
                 "schedule": "schedules", "policy": "policies"}

    def __init__(self, platforms=None, designs=None, schedules=None,
                 policies=None, *, dt_s: float = daysim.DEFAULT_DT_S,
                 n_users: float = 1e6, device="cuda", warm: bool = True,
                 **grid_kw):
        self.base = {k: v for k, v in (("platforms", platforms),
                                       ("designs", designs),
                                       ("schedules", schedules),
                                       ("policies", policies))
                     if v is not None}
        self.base.update(dt_s=dt_s, n_users=n_users, device=device,
                         **grid_kw)
        self.stats = TwinStats()
        self._lock = threading.Lock()
        if warm:
            self.query()

    def query(self, **overrides) -> daysim.DayReport:
        """Run one full grid through the fused pipeline and time it
        (host clock; the call ends in a copy of the summary to the
        host, so the device work is inside the time)."""
        args = dict(self.base)
        args.update(overrides)
        with self._lock:
            before = dict(daysim.PIPELINE_STATS)
            t0 = time.perf_counter()
            rep = dse.day_pareto(engine="fused", **args)
            ms = (time.perf_counter() - t0) * 1e3
            st = self.stats
            st.queries += 1
            st.pipeline_hits += daysim.PIPELINE_STATS["hits"] \
                - before["hits"]
            st.pipeline_misses += daysim.PIPELINE_STATS["misses"] \
                - before["misses"]
            st.last_ms = ms
            st.total_ms += ms
        return rep

    def _singular(self, overrides: dict) -> dict:
        args = {}
        for k, v in overrides.items():
            plural = self._SINGULAR.get(k)
            if plural is not None:
                args[plural] = (v,)
            else:
                args[k] = v
        return args

    def what_if(self, **overrides) -> daysim.DayReport:
        """`query` with ergonomic singular axes: `what_if(policy=p)`
        pins that axis to the single value (a 1-tuple); plural/scalar
        kwargs pass through unchanged."""
        return self.query(**self._singular(overrides))
