"""Interactive design twin: a batched multi-tenant what-if engine over
the fused day-Pareto pipeline.

`DesignTwin` holds a base grid (platforms x designs x schedules x
policies plus dt_s / n_users and any other `dse.day_pareto` kwarg),
warms it once at construction, and then answers value-level what-ifs —
swap a policy's thresholds, a battery, a platform — through the same
device-resident pipeline: the day scan runs as the hand-written CUDA
kernel on the card.

* `query(**grid_overrides)` runs one full grid and returns the DayReport
  with the front attached; `what_if(design=..., policy=...)` is the
  single-combo ergonomic wrapper (singular axes become 1-tuples).
* `query_batch()` / `what_if_many()` answer K what-ifs through
  `daysim.day_grid_groups`, which groups them by bucketed shape
  signature: a group's day tables go side by side along the kernel's
  combo axis, so a group is one day-scan launch, and every answer is
  bit-identical to the serial `query` answer.
* `submit()` / `run()` are the admission queue: `run` drains it in
  micro-batches of up to `batch_window` submissions through
  `serving.engine.drain_microbatched` and fans the reports back out in
  submission order.

`TwinStats` tracks query and batch counts, latency, and the host
pipeline-cache hits and misses.  PyTorch runs eagerly, so
`TwinStats.traces` and `exec_hits` / `exec_misses` (the reference's
retrace and executable counters) always read 0.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..core import daysim, dse
from .engine import drain_microbatched


@dataclass
class WhatIf:
    """One queued what-if: override kwargs in, report + latency out."""
    qid: int
    overrides: dict
    report: object = None
    ms: float = 0.0


@dataclass
class TwinStats:
    queries: int = 0
    batches: int = 0            # batched evaluations (a query_batch
                                # counts one per signature group)
    pipeline_hits: int = 0      # queries served from a resident pipeline
    pipeline_misses: int = 0    # queries that assembled a new one
    exec_hits: int = 0          # the reference's executable counters:
    exec_misses: int = 0        # the port compiles nothing, so both stay 0
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
    standby_mw, ...) rides along into every query.  All query paths are
    serialized behind one lock, so threads may call `submit()` / `run()`
    / `query()` concurrently and still see serial-identical results."""

    _SINGULAR = {"platform": "platforms", "design": "designs",
                 "schedule": "schedules", "policy": "policies"}

    def __init__(self, platforms=None, designs=None, schedules=None,
                 policies=None, *, dt_s: float = daysim.DEFAULT_DT_S,
                 n_users: float = 1e6, device="cuda",
                 batch_window: int = 16, warm: bool = True, **grid_kw):
        self.base = {k: v for k, v in (("platforms", platforms),
                                       ("designs", designs),
                                       ("schedules", schedules),
                                       ("policies", policies))
                     if v is not None}
        self.base.update(dt_s=dt_s, n_users=n_users, device=device,
                         **grid_kw)
        self.batch_window = batch_window
        self.queue: list[WhatIf] = []
        self.stats = TwinStats()
        self._qid = 0
        self._lock = threading.Lock()
        if warm:
            self.query()

    def _account(self, before: dict, t0: float, n_queries: int,
                 n_batches: int = 0) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        st = self.stats
        st.queries += n_queries
        st.batches += n_batches
        st.pipeline_hits += daysim.PIPELINE_STATS["hits"] - before["hits"]
        st.pipeline_misses += daysim.PIPELINE_STATS["misses"] \
            - before["misses"]
        st.last_ms = ms
        st.total_ms += ms

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
            self._account(before, t0, 1)
        return rep

    def query_batch(self, queries, **shared) -> list:
        """Evaluate K value-level what-ifs, one day-scan launch per shape
        signature.

        `queries` is a sequence of override dicts (each layered over
        `shared` and the base grid).  Queries are grouped by bucketed
        shape signature — each group runs as ONE batch of the fused
        pipeline — and the reports come back in submission order, each
        bit-identical to the serial `query(**q)` answer."""
        args = dict(self.base)
        args.update(shared)
        queries = [dict(q) for q in queries]
        if not queries:
            return []
        with self._lock:
            before = dict(daysim.PIPELINE_STATS)
            t0 = time.perf_counter()
            reports, n_groups = daysim.day_grid_groups(queries, **args)
            self._account(before, t0, len(queries), n_groups)
        return reports

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

    def what_if_many(self, whatifs, **shared) -> list:
        """`query_batch` with ergonomic singular axes per item."""
        return self.query_batch([self._singular(w) for w in whatifs],
                                **shared)

    # -- admission queue (the serving.engine.Server shape) ----------------
    def submit(self, **overrides) -> int:
        """Enqueue a what-if; returns its query id."""
        with self._lock:
            self._qid += 1
            self.queue.append(WhatIf(self._qid, overrides))
            return self._qid

    def run(self, max_steps: int = 64) -> list[WhatIf]:
        """Drain the queue in micro-batches of up to `batch_window`
        submissions (at most `max_steps` queries in all); each batch is
        evaluated through `what_if_many` — one day-scan launch per
        shape-signature group — and every finished WhatIf carries its
        report and its share of the batch's time."""

        def eval_batch(batch: list[WhatIf]) -> list[WhatIf]:
            t0 = time.perf_counter()
            reps = self.what_if_many([wi.overrides for wi in batch])
            per_ms = (time.perf_counter() - t0) * 1e3 / len(batch)
            for wi, rep in zip(batch, reps):
                wi.report = rep
                wi.ms = per_ms
            return batch

        return drain_microbatched(self.queue, self.batch_window,
                                  eval_batch, max_items=max_steps,
                                  lock=self._lock)
