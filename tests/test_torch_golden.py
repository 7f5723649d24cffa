"""The port on the CPU against the golden day-Pareto answers the card is
held to (`src/repro_torch/data/golden_day_pareto.json`, written from the
JAX reference by `tests/torch_golden.py`): the default grid at dt_s =
10 s plus three what-ifs.  Passing also proves the file is current."""
import json

import numpy as np
import pytest

import torch_golden
from repro_torch.core import daysim
from repro_torch.serving.twin import DesignTwin

GOLDEN = json.loads(torch_golden.GOLDEN.read_text())


@pytest.fixture(scope="module")
def twin():
    return DesignTwin(dt_s=GOLDEN["dt_s"], device="cpu", warm=False)


@pytest.mark.parametrize("name", sorted(GOLDEN["queries"]))
def test_port_matches_golden(twin, name):
    want = GOLDEN["queries"][name]
    assert want["overrides"] == torch_golden.WHAT_IFS[name]
    rep = twin.what_if(**torch_golden.overrides(want["overrides"], daysim))
    assert rep.combos == want["combos"]
    for k, got in (("front_mask", rep.front_mask),
                   ("survives", rep.survives()),
                   ("shutdown", rep.shutdown)):
        np.testing.assert_array_equal(np.asarray(got, bool),
                                      np.asarray(want[k], bool), err_msg=k)
    for k in ("time_to_empty_h", "peak_skin_c", "pod_hours"):
        np.testing.assert_allclose(getattr(rep, k), want[k], rtol=1e-5,
                                   err_msg=k)
