"""Port parity: the calibration module (`core/calibrate.py`) of
`repro_torch` against the JAX reference `repro`, on the same inputs, on
the CPU, at the reference tests' sizes (25 Adam steps for the restart
fits, 120 for the queue coefficient).

Tolerances: the loss and its gradient at the THETA0 pack at rtol 1e-4
(the gradient's smallest entry, d/d eff_scale, is a difference of
large terms: held at 1e-4 of the gradient's norm); batched against
sequential restarts and the port against the reference from the
reference's own `restart_starts` at rtol 1e-3 (the reference's own
vmapped-vs-sequential tolerance; the end points at 1e-4); the synthetic
queue trace bit for bit.  No test writes to either committed
calibrated.json: `main` runs with `CAL_PATH` on a temporary path."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate as j_cal
from repro_torch.core import calibrate as t_cal

CPU = "cpu"


def _z0():
    return j_cal._pack(j_cal.aria2.THETA0), \
        t_cal._pack(t_cal.aria2.THETA0, CPU)


def test_constants_and_theta_space_equal_reference():
    assert t_cal.PAPER_DELTAS == j_cal.PAPER_DELTAS
    assert (t_cal.PAPER_PD_SHARE, t_cal.ANCHOR_TOTAL_MW) \
        == (j_cal.PAPER_PD_SHARE, j_cal.ANCHOR_TOTAL_MW)
    assert t_cal.FIT_KEYS == j_cal.FIT_KEYS
    assert t_cal.BOUNDS == j_cal.BOUNDS
    assert t_cal.theta_space().to_dict() == j_cal.theta_space().to_dict()
    assert t_cal.CAL_PATH.parent.name == "data"
    assert "repro_torch" in t_cal.CAL_PATH.parts
    jz, tz = _z0()
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    for k, v in t_cal._unpack(tz).items():
        assert float(v) == pytest.approx(
            float(j_cal._unpack(jz)[k]), rel=1e-6)


@pytest.mark.parametrize("extra", [None, {"queue_mw_per_duty": 44.0}])
def test_loss_and_gradient_match_reference(extra):
    jz, tz = _z0()
    want = float(j_cal.loss_fn(jz, extra))
    gj = np.asarray(jax.grad(lambda z: j_cal.loss_fn(z, extra))(jz))
    gt, got = torch.func.grad_and_value(
        lambda z: t_cal.loss_fn(z, extra))(tz)
    assert float(got) == pytest.approx(want, rel=1e-4)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                               atol=1e-4 * np.linalg.norm(gj))


def test_synth_queue_trace_bit_equal():
    for seed in (j_cal.QUEUE_TRACE_SEED, 3):
        want = j_cal.synth_queue_trace(seed=seed)
        got = t_cal.synth_queue_trace(seed=seed)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_restart_starts_shape_and_determinism():
    a = t_cal.restart_starts(5, seed=2, device=CPU)
    b = t_cal.restart_starts(5, seed=2, device=CPU)
    c = t_cal.restart_starts(5, seed=3, device=CPU)
    assert a.shape == (5, len(t_cal.FIT_KEYS)) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    _, tz = _z0()
    assert torch.equal(a[0], tz)
    assert float((a[1:] - tz).std()) > 0.5


def test_vmapped_restarts_match_sequential_and_reference():
    z0s = j_cal.restart_starts(3, seed=2)
    zs_j, loss_j = j_cal.fit_restarts_vmapped(z0s, steps=25)
    zs_v, loss_v = t_cal.fit_restarts_vmapped(np.asarray(z0s), steps=25,
                                              device=CPU)
    zs_s, loss_s = t_cal.fit_restarts_sequential(np.asarray(z0s),
                                                 steps=25, device=CPU)
    np.testing.assert_allclose(zs_v.numpy(), zs_s.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(loss_v, loss_s, rtol=1e-3)
    np.testing.assert_allclose(zs_v.numpy(), np.asarray(zs_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(loss_v, loss_j, rtol=1e-3)


def test_fit_ensemble_posterior():
    ens = t_cal.fit_ensemble(n_restarts=3, steps=20, device=CPU)
    assert len(ens["thetas"]) == 3
    assert ens["losses"].shape == (3,)
    assert ens["best_loss"] == pytest.approx(float(ens["losses"].min()))
    for k in t_cal.FIT_KEYS:
        p = ens["posterior"][k]
        lo, hi = t_cal.BOUNDS[k]
        assert lo <= p["best"] <= hi
        assert p["std"] >= 0.0
    assert ens["weights"].sum() == pytest.approx(1.0)
    # the same fit from the same starts through the sequential path
    zs, losses = t_cal.fit_restarts_sequential(
        t_cal.restart_starts(3, device=CPU), steps=20, device=CPU)
    np.testing.assert_allclose(ens["losses"], losses, rtol=1e-3)


def test_fit_single_start_matches_reference():
    theta_j, loss_j = j_cal.fit(steps=30, verbose=False)
    theta_t, loss_t = t_cal.fit(steps=30, verbose=False, device=CPU)
    assert loss_t == pytest.approx(loss_j, rel=1e-3)
    for k, v in theta_j.items():
        assert theta_t[k] == pytest.approx(v, rel=1e-4), k


def test_fit_queue_coeff_matches_reference():
    want = j_cal.fit_queue_coeff(steps=120)
    got = t_cal.fit_queue_coeff(steps=120, device=CPU)
    assert got["queue_mw_per_duty"] == pytest.approx(
        want["queue_mw_per_duty"], rel=1e-4)
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-4)
    for k in ("n_points", "n_unique_rows", "nominal", "trace_true"):
        assert got[k] == want[k], k
    assert 25.0 < got["queue_mw_per_duty"] < 50.0


def test_report_matches_reference():
    theta = {"wifi_mw_per_mbps": 9.5, "pj_ht": 20.0}
    for th in (None, theta):
        assert t_cal.report(th, device=CPU) == j_cal.report(th)


def test_main_writes_only_its_cal_path(tmp_path, monkeypatch, capsys):
    committed = t_cal.CAL_PATH.read_bytes()
    out = tmp_path / "calibrated.json"
    monkeypatch.setattr(t_cal, "CAL_PATH", out)
    t_cal.main(n_restarts=2, steps=5, device=CPU)
    theta = json.loads(out.read_text())
    assert set(theta) == set(t_cal.FIT_KEYS) | {"queue_mw_per_duty"}
    for k in t_cal.FIT_KEYS:
        lo, hi = t_cal.BOUNDS[k]
        assert lo <= theta[k] <= hi
    assert "best of 2 restarts" in capsys.readouterr().out
    monkeypatch.undo()
    assert t_cal.CAL_PATH.read_bytes() == committed
