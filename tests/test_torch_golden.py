"""The port on the CPU against the golden day-Pareto answers the card is
held to (`src/repro_torch/data/golden_day_pareto.json`, written from the
JAX reference by `tests/torch_golden.py`): the default grid at dt_s =
10 s plus three what-ifs, asked one by one and in one batch.  Passing
also proves the file is current."""
import json

import numpy as np
import pytest

import torch_golden
from repro_torch.core import daysim
from repro_torch.serving.twin import DesignTwin
from torch_day_reports import assert_identical

GOLDEN = json.loads(torch_golden.GOLDEN.read_text())


@pytest.fixture(scope="module")
def twin():
    return DesignTwin(dt_s=GOLDEN["dt_s"], device="cpu", warm=False)


def _check_golden(rep, want: dict) -> None:
    assert rep.combos == want["combos"]
    for k, got in (("front_mask", rep.front_mask),
                   ("survives", rep.survives()),
                   ("shutdown", rep.shutdown)):
        np.testing.assert_array_equal(np.asarray(got, bool),
                                      np.asarray(want[k], bool), err_msg=k)
    for k in ("time_to_empty_h", "peak_skin_c", "pod_hours"):
        np.testing.assert_allclose(getattr(rep, k), want[k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(GOLDEN["queries"]))
def test_port_matches_golden(twin, name):
    want = GOLDEN["queries"][name]
    assert want["overrides"] == torch_golden.WHAT_IFS[name]
    _check_golden(twin.what_if(**torch_golden.overrides(want["overrides"],
                                                        daysim)), want)


def test_port_batch_matches_golden_and_serial(twin):
    """The golden's four queries in one `what_if_many` (three signature
    groups): each report matches the golden and equals the serial
    answer bit for bit."""
    names = sorted(GOLDEN["queries"])
    whatifs = [torch_golden.overrides(GOLDEN["queries"][n]["overrides"],
                                      daysim) for n in names]
    batches = twin.stats.batches
    reports = twin.what_if_many(whatifs)
    assert twin.stats.batches == batches + 3
    for name, w, rep in zip(names, whatifs, reports):
        _check_golden(rep, GOLDEN["queries"][name])
        assert_identical(rep, twin.what_if(**w))
