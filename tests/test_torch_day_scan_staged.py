"""The day-scan kernel's split on the CPU: `day_scan_staged_plain` forms
each chunk's state-independent products for every throttle level first
(the kernel's prep warp), then runs the chain with boolean latches and a
gather at the integer level (its compute warp).  Held bit-equal to
`day_scan_plain` on all nine outputs at several chunk sizes and level
counts, and to the reference Pallas kernel in interpret mode at the
reference's tolerance on the day fixture of `tests/test_kernels.py`
(throttling, puck split, chunks 32 and 128)."""
import numpy as np
import pytest
import torch

from repro.kernels.day_scan import day_scan as pallas_day_scan
from repro_torch import convert
from repro_torch.kernels import day_scan as ds
from torch_day_tables import random_tables

N, T = 16, 120


@pytest.fixture(scope="module")
def day_tables():
    """The day fixture of tests/test_kernels.py: throttling (thermal
    governor), puck split (two-node SKU), three policies, dt_s = 60."""
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


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) == set(ds.OUTS)
    for k in ds.OUTS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n_lvl", [1, 3, 16])
@pytest.mark.parametrize("chunk", [1, 7, 32, T + 5])
def test_staged_equals_plain(chunk, n_lvl):
    """Bit-equal on all nine outputs, chunks of one step, ragged chunks,
    and one chunk longer than the day."""
    tables = random_tables(N, T, n_lvl, seed=2, device="cpu")
    want = ds.day_scan_plain(tables)
    _assert_equal(ds.day_scan_staged_plain(tables, chunk), want)
    # the tables reach the paths a rounding slip would show in
    assert int(want["level"].max()) >= min(1, n_lvl - 1)
    assert float(want["shut"].max()) == 1.0


@pytest.mark.parametrize("chunk", [32, 128])
def test_staged_matches_pallas(day_tables, chunk):
    """Throttle level and shutdown latch exact; traces within the
    reference's tolerance (rtol 1e-6 / atol 1e-4) of the Pallas kernel
    run at the same chunk; and bit-equal to the plain version."""
    tables = convert.tables_from_numpy(day_tables, device="cpu")
    got = ds.day_scan_staged_plain(tables, chunk)
    want = pallas_day_scan(day_tables, chunk=chunk, interpret=True)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["level"].numpy(),
                                  np.asarray(want["level"]))
    np.testing.assert_array_equal(got["shut"].numpy(),
                                  np.asarray(want["shut"]))
    for k in ("soc", "soc_p", "pods", "t_skin", "t_skin_p", "drain_mw",
              "drain_p_mw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    assert int(got["level"].max()) >= 1
    _assert_equal(got, ds.day_scan_plain(tables))
