"""`repro_torch.golden`, the checks that hold logits to a golden file or
to a float32 forward, on constructed logits: the spread, the top-1 held
apart, and the top-8 rank rule."""
import numpy as np
import pytest
import torch

from repro_torch import golden as g


def _golden(logits: np.ndarray, top1_rtol=None) -> dict:
    ids = np.array([1, 4, 9, 17, 30])
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :8]
    out = {"sample_ids": ids.tolist(),
           "logits_at_sample": logits[:, ids].tolist(),
           "top8_ids": top.tolist(),
           "top8_logits": np.take_along_axis(logits, top, -1).tolist()}
    if top1_rtol is not None:
        out["top1_rtol"] = top1_rtol
    return out


def _logits() -> np.ndarray:
    x = np.random.default_rng(0).standard_normal((2, 40)).astype(np.float32)
    x[0, 9] = 500.0                  # row 0's top-1 is also a sampled id
    x[1, 33] = 300.0
    return x


def test_spread_is_the_population_std_without_the_top1():
    x = _logits()
    want = min(np.delete(row.astype(np.float64), row.argmax()).std()
               for row in x)
    assert g.spread(x) == pytest.approx(want, rel=1e-12)
    assert g.spread(torch.from_numpy(x)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("top1_rtol", [None, 1e-5])
def test_golden_errors_hold_the_top1_apart_when_the_golden_says(top1_rtol):
    x = _logits()
    gold = _golden(x, top1_rtol)
    y = x.copy()
    y[:, 4] += 0.01                  # a sampled id that is no top-1
    y[0, 9] += 0.5                   # row 0's top-1: 1e-3 of itself
    err, rel1 = g.golden_errors(y, gold)
    assert rel1 == pytest.approx(0.5 / 500.0, rel=1e-4)
    assert err == pytest.approx(0.01 if top1_rtol else 0.5, rel=1e-4)


def test_logit_errors_on_a_forward():
    ref = torch.from_numpy(_logits())
    is_top1 = torch.zeros_like(ref, dtype=torch.bool).scatter(
        -1, ref.argmax(-1, keepdim=True), True)
    got = ref.clone()
    got[1, 33] -= 3.0
    got[1, 0] += 0.25
    assert g.logit_errors(got, ref, is_top1, True) == \
        pytest.approx((0.25, 0.01), rel=1e-6)
    assert g.logit_errors(got, ref, is_top1, False) == \
        pytest.approx((3.0, 0.01), rel=1e-6)


def test_rank_miss_allows_ties_only():
    x = _logits()
    gold = _golden(x)
    assert g.rank_miss(x, gold, 1e-3) is None
    top = gold["top8_ids"][1]
    other = next(i for i in range(40) if i not in top)
    d = float(x[1, top[1]] - x[1, top[2]]) / 2
    y = x.copy()
    y[1, other] = x[1, top[2]] + d   # a new id at rank 2, d above the old
    assert g.rank_miss(y, gold, d / 4) == (1, 2)
    assert g.rank_miss(torch.from_numpy(y), gold, d / 4) == (1, 2)
    assert g.rank_miss(y, gold, 10.0) is None     # ties within 2 tol
