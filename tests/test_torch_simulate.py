"""Port parity: the full-trace day (`daysim.simulate`, `scan_integrate`,
`DayTrace`) and the day-scan kernel's full-trace mode in its plain
versions, against the JAX reference on the same inputs, on the CPU, at
dt_s 60 (the bit-identity tests' step: at a few hundred seconds the
explicit thermal step diverges on the hottest combos in both packages).

Discrete traces (`level`, `shut`, `th_state`, `soc_state`) and `valid`
must be exact; the other traces are held at rtol 1e-6 / atol 1e-4
(`tests/test_kernels.py`), the summary at rtol 1e-6 with its discrete
fields exact.  Bit equality with JAX is not expected: XLA on the CPU
contracts a*b+c into fused multiply-adds and uses its own exp."""
import numpy as np
import pytest
import torch

from repro.core import daysim as j_daysim
from repro_torch.core import daysim
from repro_torch.kernels import day_scan as ds
from torch_day_tables import random_tables

DT = 60.0
CPU = "cpu"
EXACT = ("level", "shut", "th_state", "soc_state")
# DayTrace field -> the scan output it holds
TRACE_FIELDS = {"soc": "soc", "soc_puck": "soc_p", "t_soc_c": "t_soc",
                "t_skin_c": "t_skin", "t_skin_puck_c": "t_skin_p",
                "level": "level", "th_state": "th_state",
                "soc_state": "soc_state", "shut": "shut", "p_mw": "p_mw",
                "p_puck_mw": "p_p_mw", "drain_mw": "drain_mw",
                "drain_puck_mw": "drain_p_mw", "pods": "pods"}
DISCRETE_SUMMARY = ("day_hours", "time_to_empty_h", "shutdown")
# (platform, design index, schedule, policy): tests/test_daysim.py's
# three scan cases, examples/all_day.py's combo, a puck-split day whose
# thermal and SoC latches both trip, and a day that hits the thermal
# hard-kill
CASES = [
    ("aria2_display", 1, "commuter", "none"),
    ("aria2_display", 1, "commuter", "battery_saver"),
    ("aria2_display", 1, "field_day", "thermal_governor"),
    ("rayban_cam", 0, "desk_day", "battery_saver"),
    ("aria2_puck_split", 1, "field_day", "thermal_governor"),
    ("aria2_display", 2, "field_day", "none"),
]


def _assert_traces(got: dict, want: dict, keys, label: str) -> None:
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4,
                                       err_msg=f"{label}/{k}")


@pytest.mark.parametrize("plat,design,schedule,policy", CASES,
                         ids=lambda x: str(x))
def test_simulate_matches_reference(plat, design, schedule, policy):
    args = (plat, daysim.DEFAULT_DESIGNS[design], schedule, policy)
    got = daysim.simulate(*args, dt_s=DT, device=CPU)
    want = j_daysim.simulate(*args, dt_s=DT)
    assert got.combo == want.combo and got.dt_s == want.dt_s
    np.testing.assert_array_equal(got.valid, want.valid)
    label = "/".join(map(str, args[::2]))
    _assert_traces({f: getattr(got, f) for f in TRACE_FIELDS},
                   {f: getattr(want, f) for f in TRACE_FIELDS},
                   TRACE_FIELDS, label)
    assert list(got.summary) == list(want.summary)
    for k, v in want.summary.items():
        if k in DISCRETE_SUMMARY:
            assert got.summary[k] == v, (label, k)
        else:
            assert got.summary[k] == pytest.approx(v, rel=1e-6), (label, k)


def test_simulate_cases_exercise_every_latch():
    """The cases above trip both throttle latches and the hard-kill (so
    the exact comparisons compare something)."""
    seen = {"th_state": 0.0, "soc_state": 0.0, "shut": 0.0}
    for plat, design, schedule, policy in CASES:
        tr = j_daysim.simulate(plat, j_daysim.DEFAULT_DESIGNS[design],
                               schedule, policy, dt_s=DT)
        for k in seen:
            seen[k] = max(seen[k], float(np.max(getattr(tr, k))))
    assert seen == {"th_state": 1.0, "soc_state": 1.0, "shut": 1.0}


@pytest.fixture
def scans(monkeypatch):
    """Record (N, full) of every day-scan call."""
    calls = []
    scan = daysim._ds.day_scan

    def recording(tables, full=False):
        calls.append((int(tables["step_mw"].shape[-1]), full))
        return scan(tables, full)

    monkeypatch.setattr(daysim._ds, "day_scan", recording)
    return calls


def test_simulate_is_one_full_trace_scan(scans):
    before = (ds.LAUNCHES, ds.FULL_LAUNCHES)
    daysim.simulate("aria2_puck_split", daysim.DEFAULT_DESIGNS[0],
                    "commuter", "thermal_governor", dt_s=DT, device=CPU)
    assert scans == [(1, True)]
    # the plain version counts no launch
    assert (ds.LAUNCHES, ds.FULL_LAUNCHES) == before


@pytest.mark.parametrize("schedule,policy", [
    ("commuter", "none"), ("commuter", "battery_saver"),
    ("field_day", "thermal_governor"),
])
def test_scan_integrate_all_keys(schedule, policy):
    """The reference's compiled tables through both packages'
    `scan_integrate`: all 17 traces."""
    tb = j_daysim.compiled_tables("aria2_display",
                                  j_daysim.DEFAULT_DESIGNS[1], schedule,
                                  policy, dt_s=DT)
    want = j_daysim.scan_integrate(tb)
    got = daysim.scan_integrate(tb, device=CPU)
    assert sorted(got) == sorted(want) == sorted(ds.TRACE_OUTS)
    _assert_traces(got, want, ds.TRACE_OUTS, f"{schedule}/{policy}")
    # the port's own compiled tables give the same traces
    port_tb = daysim.compiled_tables("aria2_display",
                                     daysim.DEFAULT_DESIGNS[1], schedule,
                                     policy, dt_s=DT, device=CPU)
    again = daysim.scan_integrate(port_tb, device=CPU)
    _assert_traces(again, want, ds.TRACE_OUTS, f"port {schedule}/{policy}")


@pytest.mark.parametrize("n,t,n_lvl,chunk", [
    (1, 50, 1, 7), (37, 300, 3, 13), (70, 200, 6, 1), (33, 120, 12, 200),
])
def test_full_mode_plain_and_staged(n, t, n_lvl, chunk):
    """day_scan_plain(full=True) == day_scan_staged_plain(full=True) on
    all 17 outputs, and their first nine equal the default mode's."""
    tables = random_tables(n, t, n_lvl, seed=n, device=torch.device(CPU))
    full = ds.day_scan_plain(tables, full=True)
    staged = ds.day_scan_staged_plain(tables, chunk, full=True)
    short = ds.day_scan_plain(tables)
    assert tuple(full) == ds.TRACE_OUTS and tuple(short) == ds.OUTS
    for k in ds.TRACE_OUTS:
        assert full[k].dtype == staged[k].dtype, k
        assert torch.equal(full[k], staged[k]), k
    for k in ds.OUTS:
        assert torch.equal(full[k], short[k]), k
    for k in ("th_state", "soc_state", "alive"):
        assert set(torch.unique(full[k]).tolist()) <= {0.0, 1.0}, k
    # act is active x act_mult at the level the step ran at
    lv = full["level"].long()
    want_act = tables["active"].t() * torch.gather(
        tables["act_mult"].t(), 1, lv)
    assert torch.equal(full["act"], want_act)


def test_day_scan_full_dispatch_on_cpu():
    tables = random_tables(5, 40, 3, seed=3, device=torch.device(CPU))
    before = (ds.LAUNCHES, ds.FULL_LAUNCHES)
    out = ds.day_scan(tables, full=True)
    assert tuple(out) == ds.TRACE_OUTS
    assert tuple(ds.day_scan(tables)) == ds.OUTS
    assert (ds.LAUNCHES, ds.FULL_LAUNCHES) == before
