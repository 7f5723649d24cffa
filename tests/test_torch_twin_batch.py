"""The port's batched what-if path (on the CPU, through the day scan's
plain version): `DesignTwin.query_batch` / `what_if_many` / `submit` +
`run`, `dse.day_pareto_batch` and the batched `non_dominated_torch`.

The contract is the reference's (`tests/test_twin_serving.py`): a query
answered inside a batch equals the same query answered alone, bit for
bit, in its combos, front, survival flags and every field of
`torch_day_reports.FIELDS`.  Against the JAX `day_pareto_batch` the
discrete outputs are exact and the continuous ones within the
tolerances of `torch_day_reports.assert_reports_match`.  Grids run at
dt_s = 60 s as the reference's serving tests do (at a few hundred
seconds the explicit thermal step diverges on the hottest combos)."""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import daysim as j_daysim
from repro.core import dse as j_dse
from repro_torch.core import daysim, dse
from repro_torch.kernels import day_scan as ds
from repro_torch.serving.engine import drain_microbatched
from repro_torch.serving.twin import DesignTwin
from torch_day_reports import assert_identical, assert_reports_match

DT = 60.0
GRID = dict(platforms=("aria2_display",), schedules=("commuter",),
            dt_s=DT)


def _point_whatifs(mod, k: int, start: int = 0) -> list:
    gov = mod.get_policy("thermal_governor")
    return [{"platform": "aria2_display",
             "design": mod.DEFAULT_DESIGNS[1],
             "schedule": "commuter",
             "policy": dataclasses.replace(
                 gov, name=f"t{start + i}",
                 temp_trip_c=38.0 + 0.05 * (start + i))}
            for i in range(k)]


def _policies(mod, k: int, start: int = 0) -> tuple:
    gov = mod.get_policy("thermal_governor")
    return tuple(dataclasses.replace(gov, name=f"v{start + i}",
                                     temp_trip_c=38.0 + 0.1 * (start + i))
                 for i in range(k))


def _singular(w: dict) -> dict:
    plural = {"platform": "platforms", "design": "designs",
              "schedule": "schedules", "policy": "policies"}
    return {plural[k]: (v,) for k, v in w.items()}


@pytest.fixture(scope="module")
def twin():
    return DesignTwin(designs=daysim.DEFAULT_DESIGNS[:2], device="cpu",
                      **GRID)


@pytest.fixture
def scans(monkeypatch):
    """Record the combo width N of every day-scan call of the pipeline."""
    widths = []
    scan = daysim._ds.day_scan

    def recording(tables):
        widths.append(tables["step_mw"].shape[-1])
        return scan(tables)

    monkeypatch.setattr(daysim._ds, "day_scan", recording)
    return widths


def test_batch_bit_identical_to_serial(twin, scans):
    """K = 5 point what-ifs: one day scan at N = 5 N_b, one row-stage
    pass (they share theta and n_users), and every answer bit-identical
    to its serial query."""
    whatifs = _point_whatifs(daysim, 5)
    serial = [twin.what_if(**w) for w in whatifs]
    n_b = daysim.bucket_size(len(serial[0]))
    del scans[:]
    passes = daysim.ROW_STAGE_STATS["passes"]
    launches = ds.LAUNCHES
    batch = twin.what_if_many(whatifs)
    assert scans == [5 * n_b]
    assert daysim.ROW_STAGE_STATS["passes"] == passes + 1
    assert ds.LAUNCHES == launches      # the CPU runs the plain version
    assert len(batch) == 5
    for s, b in zip(serial, batch):
        assert_identical(s, b)


def test_batch_grid_queries_bit_identical(twin, scans):
    queries = [{"policies": _policies(daysim, 3, 10 * i)} for i in range(3)]
    serial = [twin.query(**q) for q in queries]
    del scans[:]
    batch = twin.query_batch(queries)
    assert len(scans) == 1
    for s, b in zip(serial, batch):
        assert daysim.bucket_size(len(s)) > len(s)     # combo padding
        assert_identical(s, b)


@pytest.mark.parametrize("kind", ["points", "grids"])
def test_batch_matches_reference_batch(kind):
    """The port's `day_pareto_batch` against the JAX one."""
    if kind == "points":
        want = j_dse.day_pareto_batch(
            [_singular(w) for w in _point_whatifs(j_daysim, 5)], dt_s=DT)
        got = dse.day_pareto_batch(
            [_singular(w) for w in _point_whatifs(daysim, 5)],
            device="cpu", dt_s=DT)
    else:
        want = j_dse.day_pareto_batch(
            [{"policies": _policies(j_daysim, 3, 10 * i)} for i in range(3)],
            designs=j_daysim.DEFAULT_DESIGNS[:2], **GRID)
        got = dse.day_pareto_batch(
            [{"policies": _policies(daysim, 3, 10 * i)} for i in range(3)],
            device="cpu", designs=daysim.DEFAULT_DESIGNS[:2], **GRID)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_reports_match(g, w)


def test_batch_rows_share_a_pass_per_context(twin, scans):
    """Queries whose row stages read other values (n_users) get one
    pass each; all still make one day scan and keep their serial bits."""
    queries = [{"n_users": n} for n in (1e5, 1e6, 1e5)]
    serial = [twin.query(**q) for q in queries]
    del scans[:]
    passes = daysim.ROW_STAGE_STATS["passes"]
    batch = twin.query_batch(queries)
    assert daysim.ROW_STAGE_STATS["passes"] == passes + 2
    assert len(scans) == 1
    for s, b in zip(serial, batch):
        assert_identical(s, b)
    assert not np.array_equal(batch[0].pod_hours, batch[1].pod_hours)


def test_batch_mixed_signature_raises():
    with pytest.raises(ValueError, match="different bucketed shape"):
        dse.day_pareto_batch(
            [{"policies": _policies(daysim, 2)},
             {"policies": _policies(daysim, 6)}],
            device="cpu", designs=daysim.DEFAULT_DESIGNS[:2], **GRID)


def test_batch_empty_raises():
    with pytest.raises(ValueError, match="at least one"):
        daysim.day_grid_batch([], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        dse.day_pareto_batch([], device="cpu")


def test_day_grid_groups_orders_and_counts(scans):
    """Queries of two signatures, interleaved: one day scan per group,
    the reports in submission order and equal to each group's own
    `day_grid_batch`."""
    points = [_singular(w) for w in _point_whatifs(daysim, 2, 600)]
    grid = {"policies": _policies(daysim, 2, 600)}
    queries = [points[0], grid, points[1]]
    shared = dict(GRID, designs=daysim.DEFAULT_DESIGNS[:2])
    reps, n_groups = daysim.day_grid_groups(queries, device="cpu", **shared)
    assert n_groups == 2 and len(scans) == 2
    assert [len(r) for r in reps] == [1, 4, 1]
    want = daysim.day_grid_batch(points, device="cpu", **shared)
    assert_identical(reps[0], want[0])
    assert_identical(reps[2], want[1])
    assert_identical(reps[1], daysim.day_grid_batch([grid], device="cpu",
                                                    **shared)[0])


def test_drain_microbatched_window_and_budget():
    queue = list(range(10))
    seen = []

    def eval_batch(batch):
        seen.append(list(batch))
        return batch

    out = drain_microbatched(queue, 4, eval_batch, max_items=7)
    assert out == list(range(7))
    assert seen == [[0, 1, 2, 3], [4, 5, 6]]
    assert queue == [7, 8, 9]
    assert drain_microbatched(queue, 4, eval_batch) == [7, 8, 9]
    assert queue == []


def test_run_microbatches_and_fans_out(twin, scans):
    whatifs = _point_whatifs(daysim, 5, 200)
    serial = [twin.what_if(**w) for w in whatifs]
    qids = [twin.submit(**w) for w in whatifs]
    batches = twin.stats.batches
    del scans[:]
    done = twin.run()
    assert [wi.qid for wi in done] == qids
    assert twin.queue == []
    assert twin.stats.batches == batches + 1        # one signature group
    assert len(scans) == 1
    for s, wi in zip(serial, done):
        assert_identical(s, wi.report)
        assert wi.ms > 0.0


def test_run_counts_signature_groups(twin, scans):
    """Point what-ifs and grid queries in one window: two signature
    groups, so two day scans, and results in submission order."""
    items = [_point_whatifs(daysim, 1, 400)[0],
             {"policies": _policies(daysim, 2, 400)},
             _point_whatifs(daysim, 1, 401)[0]]
    serial = [twin.what_if(**w) for w in items]
    qids = [twin.submit(**w) for w in items]
    batches = twin.stats.batches
    del scans[:]
    done = twin.run()
    assert [wi.qid for wi in done] == qids
    assert twin.stats.batches == batches + 2
    assert len(scans) == 2
    for s, wi in zip(serial, done):
        assert_identical(s, wi.report)


def test_run_budget_leaves_the_rest_queued(twin):
    qids = [twin.submit(**w) for w in _point_whatifs(daysim, 3, 500)]
    first = twin.run(max_steps=2)
    assert [w.qid for w in first] == qids[:2]
    assert len(twin.queue) == 1
    rest = twin.run()
    assert [w.qid for w in rest] == qids[2:] and not twin.queue


def test_concurrent_submit_run_mixed_shapes(twin):
    whatifs = _point_whatifs(daysim, 6, 300)
    grids = [{"policies": _policies(daysim, 2, 300 + 10 * i)}
             for i in range(4)]
    serial = {f"p{i}": twin.what_if(**w) for i, w in enumerate(whatifs)}
    serial.update({f"g{i}": twin.query(**q) for i, q in enumerate(grids)})
    qid_to_key, results, errors = {}, {}, []

    def submit_points(lo, hi):
        for i in range(lo, hi):
            qid_to_key[twin.submit(**whatifs[i])] = f"p{i}"

    def submit_grids():
        for i, q in enumerate(grids):
            qid_to_key[twin.submit(**q)] = f"g{i}"

    def drain():
        try:
            for wi in twin.run():
                results[wi.qid] = wi.report
        except Exception as e:                  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submit_points, args=(0, 3)),
               threading.Thread(target=submit_points, args=(3, 6)),
               threading.Thread(target=submit_grids),
               threading.Thread(target=drain),
               threading.Thread(target=drain)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as it can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    results.update({wi.qid: wi.report for wi in twin.run()})

    assert not errors
    assert len(results) == len(qid_to_key) == 10
    for qid, key in qid_to_key.items():
        assert_identical(serial[key], results[qid])


@pytest.mark.parametrize("q,n,k,maximize,seed", [
    (4, 16, 3, (0,), 0),
    (8, 64, 3, (0,), 1),
    (3, 33, 2, (), 2),
    (5, 20, 4, (1, 3), 3),
])
def test_non_dominated_torch_batched(q, n, k, maximize, seed):
    """Each query's front among its own rows equals the numpy filter's,
    on points with many exact ties and duplicates."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.normal(size=(q, n, k)) * 2) / 2
    pts[:, 1] = pts[:, 0]                   # exact duplicates
    pts = pts.astype(np.float32)
    got = dse.non_dominated_torch(torch.as_tensor(pts), maximize).numpy()
    assert got.shape == (q, n)
    for i in range(q):
        want = dse.non_dominated(pts[i], maximize=maximize)
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(
            dse.non_dominated_torch(torch.as_tensor(pts[i]), maximize)
            .numpy(), want)


def test_non_dominated_torch_rejects_other_ranks():
    with pytest.raises(ValueError, match="objectives"):
        dse.non_dominated_torch(torch.zeros(5))


def test_twin_stats_keep_the_reference_counters(twin):
    """`examples/what_if.py` reads `exec_hits` beside `traces`: the port
    compiles nothing, so both executable counters stay 0 after queries."""
    twin.query()
    st = twin.stats
    assert st.queries >= 1
    assert (st.exec_hits, st.exec_misses, st.traces) == (0, 0, 0)
