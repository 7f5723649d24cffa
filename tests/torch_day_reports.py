"""Report comparisons shared by the port's day tests (numpy only, so the
card tests can use them on a machine without JAX).

`assert_reports_match` holds a port report to a JAX reference report:
discrete outputs exactly, continuous ones at the reference's own
tolerances — trace values (end SoC, peak skin temperature) to rtol 1e-6
/ atol 1e-4 (`tests/test_kernels.py`), the steady total to rtol 1e-6,
accumulated sums to rtol 1e-5 / atol 1e-5 (`tests/test_twin.py`).  Bit
equality is not expected there: XLA on the CPU contracts a*b+c into
fused multiply-adds and uses its own exp, while the port rounds every
operation on its own, as its CUDA kernel does.

`assert_identical` is the batched path's contract with the serial one
(`tests/test_twin_serving.py`): the same combos, front and survival
flags, and every field in `FIELDS` equal bit for bit."""
import numpy as np

FIELDS = ("time_to_empty_h", "peak_skin_c", "pod_hours", "end_soc",
          "energy_mwh", "throttled_h", "steady_mw", "day_hours")


def assert_reports_match(got, want):
    assert got.combos == want.combos
    assert got.skipped == want.skipped
    np.testing.assert_array_equal(got.front_mask, want.front_mask)
    np.testing.assert_array_equal(got.survives(), want.survives())
    np.testing.assert_array_equal(got.shutdown, want.shutdown)
    np.testing.assert_array_equal(got.day_hours, want.day_hours)
    for k in ("end_soc", "end_soc_puck", "peak_skin_c", "peak_skin_puck_c"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.steady_mw, want.steady_mw, rtol=1e-6)
    for k in ("time_to_empty_h", "pod_hours", "energy_mwh", "throttled_h"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def assert_identical(a, b):
    assert a.combos == b.combos
    assert np.array_equal(a.front_mask, b.front_mask)
    assert np.array_equal(a.survives(), b.survives())
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
