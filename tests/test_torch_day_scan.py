"""Port parity of the day scan: the port's `day_scan` on CPU tensors (its
plain PyTorch version) against the reference Pallas kernel in interpret
mode and the reference's vmapped `lax.scan` oracle, on the exact day
fixture of `tests/test_kernels.py` (throttling, puck split, three
policies, dt_s = 60)."""
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.day_scan import day_scan as pallas_day_scan
from repro_torch import convert
from repro_torch.core import daysim as t_daysim
from repro_torch.core.design import take_linear
from repro_torch.kernels import day_scan as ds


@pytest.fixture(scope="module")
def day_tables():
    """Batched day tables for a small grid that exercises throttling
    (thermal governor), puck split (two-node SKU) and the offload-only
    short schedule — the paths the fused day kernel must reproduce."""
    from repro.core import daysim
    combos, _ = daysim.build_combos(
        platforms=("aria2_display", "aria2_puck_split"),
        designs=({"name": "hot", "on_device": ("slam", "asr"),
                  "compression": 10.0},
                 {"name": "lean", "on_device": ()}),
        schedules=("commuter",),
        policies=("none", "thermal_governor", "battery_saver"))
    assert combos
    return daysim.batch_tables(combos, dt_s=60.0)


@pytest.fixture(scope="module")
def port_out(day_tables):
    tables = convert.tables_from_numpy(day_tables, device="cpu")
    before = ds.LAUNCHES
    out = ds.day_scan(tables)
    assert ds.LAUNCHES == before        # CPU tensors: the plain version
    return out


@pytest.mark.parametrize("oracle", ["pallas_interpret", "scan_ref"])
def test_day_scan_parity(day_tables, port_out, oracle):
    """Throttle level and shutdown latch exact; traces to the reference's
    own tolerance (rtol 1e-6 / atol 1e-4, tests/test_kernels.py)."""
    if oracle == "pallas_interpret":
        want = pallas_day_scan(day_tables, chunk=128, interpret=True)
    else:
        want = ref.day_scan_ref(day_tables)
    assert set(port_out) == set(want)
    np.testing.assert_array_equal(port_out["level"].numpy(),
                                  np.asarray(want["level"]))
    np.testing.assert_array_equal(port_out["shut"].numpy(),
                                  np.asarray(want["shut"]))
    for k in ("soc", "soc_p", "pods", "t_skin", "t_skin_p", "drain_mw",
              "drain_p_mw"):
        np.testing.assert_allclose(port_out[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-4, err_msg=k)


def test_fixture_throttles(port_out):
    """The fixture really reaches a throttle level above 0."""
    assert int(port_out["level"].max()) >= 1


def test_plain_matches_numpy_oracle(day_tables, port_out):
    """Per combo, the plain version against the port's copy of the
    reference's numpy per-step oracle `reference_integrate`."""
    n = np.asarray(day_tables["step_mw"]).shape[0]
    for i in range(n):
        tb = {k: (np.asarray(v)[i] if k != "const" else
                  {kk: np.asarray(vv)[i] for kk, vv in v.items()})
              for k, v in day_tables.items()}
        want = t_daysim.reference_integrate(tb)
        np.testing.assert_array_equal(port_out["level"][i].numpy(),
                                      want["level"])
        for k in ("soc", "soc_p", "t_skin", "t_skin_p", "pods",
                  "drain_mw", "drain_p_mw", "shut"):
            np.testing.assert_allclose(port_out[k][i].numpy(), want[k],
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"combo {i} {k}")


def test_take_linear_exact_at_integer_levels():
    """The reference indexes level tables with `take_linear`; at the
    integer levels the scan produces it is bit-equal to the plain
    integer take the port uses."""
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.uniform(10, 900, (257, 3)).astype(
        np.float32))
    level = torch.as_tensor(rng.integers(0, 3, 257))
    got = take_linear(table, level.float())
    want = table[torch.arange(257), level]
    assert torch.equal(got, want)


def test_day_scan_rejects_bad_tables(day_tables):
    tables = convert.tables_from_numpy(day_tables, device="cpu")
    bad = dict(tables, const={k: v for k, v in tables["const"].items()
                              if k != "temp_trip"})
    with pytest.raises(ValueError, match="const keys"):
        ds.day_scan(bad)
    bad = dict(tables, active=tables["active"][:-1])
    with pytest.raises(ValueError, match="active"):
        ds.day_scan(bad)
    bad = dict(tables, step_mw=tables["step_mw"].double())
    with pytest.raises(ValueError, match="step_mw"):
        ds.day_scan(bad)


def test_tables_layout(day_tables):
    """convert.tables_from_numpy lays tables out time-major."""
    tables = convert.tables_from_numpy(day_tables, device="cpu")
    n, t, n_lvl = np.asarray(day_tables["step_mw"]).shape
    assert tables["step_mw"].shape == (t, n_lvl, n)
    assert tables["ambient"].shape == (t, n)
    assert tables["act_mult"].shape == (n_lvl, n)
    assert tuple(sorted(tables["const"])) == ds.CONST_KEYS
    np.testing.assert_array_equal(
        tables["step_mw"][:, 1, 0].numpy(),
        np.asarray(day_tables["step_mw"])[0, :, 1])
